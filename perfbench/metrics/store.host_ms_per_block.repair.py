"""Host ms a block in the piece store during repair: the content hash
of each decoded block (the span around `_verify_gathered` less the one
around its `decode_batch`) and the `wrap_piece` of each rebuilt piece,
which hashes it on the host, per block the rounds took."""


def read(run):
    blocks = run.spans.blocks("store.verify")
    if not blocks:
        return None
    host = (run.spans.secs("store.verify") - run.spans.secs("codec.decode_batch")
            + run.spans.secs("store.wrap_piece"))
    return 1e3 * host / blocks
