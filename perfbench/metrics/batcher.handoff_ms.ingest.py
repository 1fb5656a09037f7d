"""Mean ms an encode dispatch of the batcher waited on its thread
handoff: from the hand-off to its start in a worker thread, plus from
its return to the event loop resuming the lane (the program's stage
`handoff`, op `encode`), per dispatch."""

from perfbench.stages import INGEST, uses_and_seconds


def read(run):
    uses, secs = uses_and_seconds(run, "handoff", INGEST)
    return 1e3 * secs / uses if uses else None
