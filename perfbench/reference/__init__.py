"""The plain reference the benchmark judges the program by: GF(2^8)
Cauchy Reed-Solomon (`gf256`), BLAKE3 (`blake3`), the stored piece's
layout (`layout`), and a codec built of them (`codec`).  Each traffic
kind's `compare` (`kinds/`) judges the program with these.  Plain
NumPy; it imports nothing of the program."""
