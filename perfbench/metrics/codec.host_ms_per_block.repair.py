"""Host ms a block in the codec's marshalling during repair: the
benchmark's spans around each `decode_batch` and `reconstruct_batch`
less the program's `tpu_codec_dispatch_duration` of their dispatches,
per block the rounds took."""


def read(run):
    blocks = run.spans.blocks("store.verify")
    if not blocks:
        return None
    _n, dispatch = run.reg.histogram("tpu_codec_dispatch_duration")
    host = (run.spans.secs("codec.decode_batch")
            + run.spans.secs("codec.reconstruct_batch") - dispatch)
    return 1e3 * host / blocks
