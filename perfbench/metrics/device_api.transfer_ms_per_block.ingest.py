"""Device ms a block in the device API's copies: the card's time in the
traced window's host-to-device and device-to-host copies (CUPTI's
`Memcpy` events), per block encoded."""


def read(run):
    blocks = run.spans.blocks("codec.encode_batch_hashed")
    if run.trace is None or not blocks:
        return None
    return 1e3 * run.trace["copy_s"] / blocks
