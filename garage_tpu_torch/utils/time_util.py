"""Time helpers (reference src/util/time.rs)."""

from __future__ import annotations

import time
from datetime import datetime, timezone


# fault-injection seam (chaos/jepsen clock nemesis): a test shifts the
# whole process's notion of wall time to exercise the LWW/next_timestamp
# logic under forward and BACKWARD clock jumps
_offset_msec = 0


def set_clock_offset(ms: int) -> None:
    global _offset_msec
    _offset_msec = ms


def now_msec() -> int:
    """Milliseconds since the unix epoch."""
    return int(time.time() * 1000) + _offset_msec


def increment_logical_clock(prev: int) -> int:
    """max(now, prev+1) — monotone timestamps for LWW registers
    (reference src/util/time.rs:9-13)."""
    return max(now_msec(), prev + 1)


def msec_to_rfc3339(msecs: int) -> str:
    dt = datetime.fromtimestamp(msecs / 1000.0, tz=timezone.utc)
    return dt.strftime("%Y-%m-%dT%H:%M:%S.") + f"{msecs % 1000:03d}Z"
