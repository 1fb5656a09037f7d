"""Host ms a block in the `bytes()` copies of its k+m pieces and hashes
out of the encode group's arrays: the program's stage `unstack` (op
`encode`), per block stacked."""

from perfbench.stages import INGEST, ms_per_block


def read(run):
    return ms_per_block(run, "unstack", INGEST, "stack", INGEST)
