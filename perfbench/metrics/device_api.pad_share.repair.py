"""Share, in %, of the batch rows sent to the card that were padding:
the program's `tpu_codec_pad_padded_total` against
`tpu_codec_pad_requested_total` over the window."""


def read(run):
    padded = run.reg.counter("tpu_codec_pad_padded_total")
    if not padded:
        return None
    return 100 * (1 - run.reg.counter("tpu_codec_pad_requested_total") / padded)
