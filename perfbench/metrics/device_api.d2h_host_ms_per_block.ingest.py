"""Host ms a block in the device API's copies of parity and hashes back
from the card, once the kernels are done: the program's stage `d2h` (op
`encode`), per block stacked."""

from perfbench.stages import INGEST, ms_per_block


def read(run):
    return ms_per_block(run, "d2h", INGEST, "stack", INGEST)
