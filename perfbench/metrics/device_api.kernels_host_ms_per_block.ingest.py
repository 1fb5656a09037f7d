"""Host ms a block from the launch of each encode dispatch's kernels to
their end, as the host waits on the compute bracket's end event: the
program's stage `kernels` (op `encode`), per block stacked."""

from perfbench.stages import INGEST, ms_per_block


def read(run):
    return ms_per_block(run, "kernels", INGEST, "stack", INGEST)
