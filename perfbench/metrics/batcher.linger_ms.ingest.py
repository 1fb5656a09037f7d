"""Mean ms a block waited in the batcher's encode lane from its submit
to the start of its dispatch: the program's
`block_codec_batch_lane_linger{lane="encode"}` over the window."""


def read(run):
    n, total = run.reg.histogram("block_codec_batch_lane_linger", lane="encode")
    return 1e3 * total / n if n else None
