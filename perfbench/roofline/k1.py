"""K1, GF(2^8) coding of shards: the bytes its least time is bound by.

An (r x q) coding matrix applied to q shards of S bytes reads each input
byte once and writes each output byte once: (q + r) * S bytes a block.
Its least time is those bytes over the card's HBM bandwidth
(`peaks.json`).  Counted for the blocks a call asks for, never for pad
rows.
"""


def bytes_moved(q: int, r: int, s: int) -> int:
    return (q + r) * s
