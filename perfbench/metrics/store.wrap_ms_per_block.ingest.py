"""Host ms a block in the piece store's `wrap_piece` of its k+m pieces:
the program's stage `wrap` (one use a piece), per block stacked."""

from perfbench.stages import INGEST, STORE, ms_per_block


def read(run):
    return ms_per_block(run, "wrap", STORE, "stack", INGEST)
