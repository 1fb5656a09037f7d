"""Blocks in each encode dispatch of the batcher over the window: the
program's `block_codec_batch_size` histogram, its sum over its count."""


def read(run):
    n, total = run.reg.histogram("block_codec_batch_size")
    return total / n if n else None
