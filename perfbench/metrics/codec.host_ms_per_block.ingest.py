"""Host ms a block in the codec's marshalling (`np.stack`, the pieces'
`bytes()` copies): the benchmark's span around each
`EcCodec.encode_batch_hashed` call less the program's
`tpu_codec_dispatch_duration` of the same dispatches, per block."""


def read(run):
    blocks = run.spans.blocks("codec.encode_batch_hashed")
    if not blocks:
        return None
    _n, dispatch = run.reg.histogram("tpu_codec_dispatch_duration")
    return 1e3 * (run.spans.secs("codec.encode_batch_hashed") - dispatch) / blocks
