"""Host ms a block in the piece store's `wrap_piece` of each rebuilt
piece (a host BLAKE3 of it): the program's stage `wrap`, per block whose
content the round hashed."""

from perfbench.stages import STORE, ms_per_block


def read(run):
    return ms_per_block(run, "wrap", STORE, "verify_hash", STORE)
