"""Host ms a block in the device API's copy of each encode batch to the
card and its pad, as the host waits on it (a pageable copy): the
program's stage `h2d` (op `encode`), per block stacked."""

from perfbench.stages import INGEST, ms_per_block


def read(run):
    return ms_per_block(run, "h2d", INGEST, "stack", INGEST)
