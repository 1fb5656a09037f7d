"""95th percentile, in ms, of the time from a block's call into the
batcher until its last piece is wrapped, over every block submitted in
the window (the run's notes give the count)."""


def read(run):
    return None if run.p95_s is None else 1e3 * run.p95_s
