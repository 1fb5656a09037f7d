"""MiB a second of user blocks whose k+m stored pieces were all made
(encoded, hashed and wrapped) inside the window."""


def read(run):
    return run.done_bytes / (1 << 20) / run.window_s
