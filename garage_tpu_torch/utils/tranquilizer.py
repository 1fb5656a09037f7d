"""Self-throttling for background workers.

Mirrors reference src/util/tranquilizer.rs:9-26: measure the duration of each
work unit over a sliding window; after each unit, sleep
`tranquility × avg(observed durations)` so a worker with tranquility t uses
at most 1/(t+1) of one CPU / disk stream.
"""

from __future__ import annotations

import time
from collections import deque


class Tranquilizer:
    def __init__(self, window: int = 10):
        self.observations: deque[float] = deque(maxlen=window)
        self._last_start: float | None = None

    def reset(self) -> None:
        self._last_start = time.monotonic()

    def tranquilize_delay(self, tranquility: int) -> float:
        """Record the unit that began at `reset()`; return seconds to sleep."""
        if self._last_start is None:
            return 0.0
        dt = time.monotonic() - self._last_start
        self.observations.append(dt)
        self._last_start = None
        if tranquility <= 0 or not self.observations:
            return 0.0
        avg = sum(self.observations) / len(self.observations)
        return min(tranquility * avg, 10.0)
