"""MiB a second of user blocks brought back to full redundancy inside
the window: gathered pieces verified, the lost piece rebuilt and
wrapped."""


def read(run):
    return run.done_bytes / (1 << 20) / run.window_s
