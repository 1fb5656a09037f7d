"""Shared exponential-backoff policy.

One implementation for every retry loop in the tree — block resync's
1 min -> 64 min error ladder (block/resync.py), peering's reconnect
pacing (net/peering.py), and the RPC layer's idempotent-call retries
(rpc/rpc_helper.py) — so cap/jitter behavior can't drift between them.

Two shapes:

  - `expo(count, base, max_)`   — pure function of the attempt count
    (deterministic; persisted-counter loops like resync use this)
  - `jittered(delay, rng)`      — multiply by a uniform [0.75, 1.25)
    factor so a thundering herd of retriers decorrelates
  - `Backoff`                   — stateful next()/reset() for in-memory
    retry loops (RPC retries): jittered-exponential with reset-on-success
"""

from __future__ import annotations

import random

JITTER_SPREAD = 0.5  # total width of the jitter factor window


def expo(count: int, base: float, max_: float, factor: float = 2.0) -> float:
    """base * factor**count, capped at max_ (count capped to avoid
    astronomically large intermediates)."""
    return min(max_, base * factor ** min(max(count, 0), 30))


def jittered(delay: float, rng: random.Random | None = None) -> float:
    """delay scaled by a uniform factor in [0.75, 1.25)."""
    r = rng.random() if rng is not None else random.random()
    return delay * (1.0 - JITTER_SPREAD / 2 + JITTER_SPREAD * r)


class Backoff:
    """Jittered-exponential retry pacing with reset-on-success.

    >>> b = Backoff(base=0.1, max_=2.0)
    >>> b.next()   # ~0.1 (jittered)
    >>> b.next()   # ~0.2
    >>> b.reset()  # success observed: next() is back at ~base
    """

    def __init__(
        self,
        base: float,
        max_: float,
        factor: float = 2.0,
        rng: random.Random | None = None,
    ):
        self.base = base
        self.max_ = max_
        self.factor = factor
        self.rng = rng
        self.attempt = 0

    def next(self) -> float:
        d = jittered(expo(self.attempt, self.base, self.max_, self.factor), self.rng)
        self.attempt += 1
        return d

    def reset(self) -> None:
        self.attempt = 0
