"""Host ms a block in the codec's `np.stack` of each encode group: the
program's stage `stack` (op `encode`) over the blocks it stacked, over
the window."""

from perfbench.stages import INGEST, ms_per_block


def read(run):
    return ms_per_block(run, "stack", INGEST, "stack", INGEST)
