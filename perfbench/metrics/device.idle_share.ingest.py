"""Share, in %, of the traced window in which the card ran neither a
kernel nor a copy (the run's notes give the kernels' time alone)."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100 * (1 - run.trace["busy_s"] / run.trace["window_s"])
