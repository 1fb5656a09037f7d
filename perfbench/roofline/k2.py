"""K2, BLAKE3 of pieces: the integer operations its least time is bound by.

A message of L bytes takes one compression per 64-byte block of each
1024-byte chunk (at least one a chunk) and one per parent node of the
chunk tree (chunks - 1).  A compression is 456 int32 instructions (7
rounds of 8 G functions, the feed-forward and the message loads), and
the card issues `int32_lanes_per_sm_cycle` of them a cycle on each SM
(`peaks.json`).  Counted for the pieces a call asks for, never for pad
rows.
"""

OPS_PER_COMPRESSION = 456


def compressions(length: int) -> int:
    chunks = max(1, -(-length // 1024))
    last = length - 1024 * (chunks - 1)
    return 16 * (chunks - 1) + max(1, -(-last // 64)) + (chunks - 1)


def int_ops(length: int) -> int:
    return OPS_PER_COMPRESSION * compressions(length)
