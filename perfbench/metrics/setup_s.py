"""Seconds from the start of the process to the opening of the window:
the imports, the card's context, the kernels' build or load, the inputs
made from the seed, and the warm-up."""


def read(run):
    return run.setup_s
