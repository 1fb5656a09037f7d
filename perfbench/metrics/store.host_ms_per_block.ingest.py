"""Host ms a block in the piece store: the benchmark's span around the
`wrap_piece` calls of a block's k+m pieces, per block."""


def read(run):
    blocks = run.spans.blocks("store.wrap_piece")
    return 1e3 * run.spans.secs("store.wrap_piece") / blocks if blocks else None
