"""Overload-control plane, reaction side: the SLO-driven shedding
controller.

A background `Worker` closes the loop from observation (the
`SloTracker` burn rates, the event-loop-lag p99 from the local
telemetry digest) to action: when the node is burning its SLO budget
faster than it can afford, the controller walks a DECLARED degradation
ladder — cheapest, most reversible step first — and walks back down
once the budget stops burning:

    level 1  repair-slow      repair tranquility x4, bytes-in-flight /4
    level 2  sync-stretch     table anti-entropy interval x4
    level 3  scrub-pause      pause the scrub worker
    level 4  shed-anonymous   admission sheds tier 3 (anonymous)
    level 5  shed-list        admission sheds tiers >= 2 (list/batch)
    level 6  shed-write       admission sheds tiers >= 1 (writes)

Interactive traffic (tier 0) is never shed by the ladder — at level 6
the node serves reads, queues them briefly under the in-flight cap, and
turns everything else away with `503 SlowDown`.

Every actuator is one of the live `BgVars` / worker commands that
already exist (repair-tranquility, repair-bytes-in-flight,
sync-interval-secs, scrub pause) plus the admission controller's shed
tier (api/overload.py) — the controller saves each knob's prior value
when a step applies and restores it exactly on the way down.

Hysteresis (no flapping):
  - step UP at most one level per check interval, only while the signal
    says overloaded (burn > `ladder_burn_up` or loop lag p99 over its
    threshold);
  - step DOWN one level only after `ladder_hold_secs` of CONTINUOUS
    recovery (burn < `ladder_burn_down` and lag below half the
    threshold), and the hold restarts after each step down;
  - the gray zone between the two thresholds holds position.

Every transition is logged with its reason and counted in
`overload_ladder_steps_total{direction}`; the current level is the
`overload_ladder_level` gauge, the gossiped digest's `ovl.lvl`, and the
federated `cluster_node_overload_ladder_level` — a shedding node is
visible cluster-wide in `cluster top`.
"""

from __future__ import annotations

import logging
import time
from typing import Any

from ..utils.background import Worker, WorkerState
from ..utils.metrics import registry

logger = logging.getLogger("garage.shedding")


# --- ladder steps -------------------------------------------------------------


class _Step:
    """One rung: apply() returns an opaque saved-state token that
    revert() consumes.  Both are best-effort: a missing actuator (e.g.
    scrub disabled) must not wedge the ladder above or below it."""

    name = "step"

    def apply(self, garage) -> Any:
        raise NotImplementedError

    def revert(self, garage, saved: Any) -> None:
        raise NotImplementedError


class _RepairSlow(_Step):
    name = "repair-slow"

    def apply(self, garage) -> Any:
        bv = garage.bg_vars
        saved = (bv.get("repair-tranquility"), bv.get("repair-bytes-in-flight"))
        bv.set("repair-tranquility", str(max(int(saved[0]) * 4, 8)))
        bv.set(
            "repair-bytes-in-flight",
            str(max(int(saved[1]) // 4, 1024 * 1024)),
        )
        return saved

    def revert(self, garage, saved: Any) -> None:
        garage.bg_vars.set("repair-tranquility", saved[0])
        garage.bg_vars.set("repair-bytes-in-flight", saved[1])


class _SyncStretch(_Step):
    name = "sync-stretch"

    def apply(self, garage) -> Any:
        bv = garage.bg_vars
        saved = bv.get("sync-interval-secs")
        bv.set("sync-interval-secs", str(min(float(saved) * 4, 3600.0)))
        return saved

    def revert(self, garage, saved: Any) -> None:
        garage.bg_vars.set("sync-interval-secs", saved)


class _ScrubPause(_Step):
    name = "scrub-pause"

    def apply(self, garage) -> Any:
        sw = getattr(garage.block_manager, "scrub_worker", None)
        if sw is None:
            return None  # scrub disabled: the rung is a no-op
        saved = sw.paused
        sw.cmd_pause()
        return saved

    def revert(self, garage, saved: Any) -> None:
        sw = getattr(garage.block_manager, "scrub_worker", None)
        if sw is not None and saved is False:
            sw.cmd_resume()


class _ShedTier(_Step):
    def __init__(self, name: str, tier: int):
        self.name = name
        self.tier = tier

    def apply(self, garage) -> Any:
        ctl = garage.overload
        saved = ctl.shed_from_tier
        ctl.set_shed_tier(self.tier)
        return saved

    def revert(self, garage, saved: Any) -> None:
        garage.overload.set_shed_tier(saved)


def build_ladder() -> list[_Step]:
    from ..api.overload import TIER_ANON, TIER_LIST, TIER_WRITE

    return [
        _RepairSlow(),
        _SyncStretch(),
        _ScrubPause(),
        _ShedTier("shed-anonymous", TIER_ANON),
        _ShedTier("shed-list", TIER_LIST),
        _ShedTier("shed-write", TIER_WRITE),
    ]


# --- controller ---------------------------------------------------------------


class SheddingController(Worker):
    """Spawned by `Garage.spawn_workers()` when `[overload] enabled`.
    `evaluate()` is synchronous and clock-injected so the hysteresis
    state machine unit-tests without a running cluster."""

    def __init__(self, garage, clock=time.monotonic):
        self.garage = garage
        self.cfg = garage.config.overload
        self.clock = clock
        self.ladder = build_ladder()
        self.level = 0
        self._saved: list[Any] = []  # saved state per applied step
        self._recovered_since: float | None = None
        self.steps_up = 0
        self.steps_down = 0
        self.last_change: float | None = None
        self.last_reason: str | None = None
        self._last_blocked: float | None = None

    def name(self) -> str:
        return "shedding"

    def status(self) -> dict[str, Any]:
        return {
            "level": self.level,
            "steps": [s.name for s in self.ladder[: self.level]],
        }

    # --- signals --------------------------------------------------------------

    def signals(self, consume: bool = True) -> tuple[float, float]:
        """(max SLO burn rate, event-loop lag p99 seconds) — burn from
        the SloTracker, lag from the LOCAL telemetry digest (the same
        row this node gossips, rpc/telemetry_digest.py).

        Two guards keep quiet nodes off the ladder:
          - burn only counts once the SLO window holds at least
            `min_window_requests` (one 500 among a handful of requests
            is noise, not overload);
          - the lag histogram is CUMULATIVE, so its p99 remembers every
            stall the process ever had — the lag signal only counts
            while `event_loop_blocked_total` is still increasing, i.e.
            there is fresh stall evidence this interval.

        `consume=False` (status surfaces) leaves the stall-evidence
        edge detector untouched: a dashboard polling /v1/overload must
        not eat the `blocked`-increased evidence the controller's own
        next evaluate() needs."""
        slo = self.garage.slo_tracker.compute()
        minreq = int(self.cfg.min_window_requests)
        burn = 0.0
        for kind in ("availability", "latency_p99"):
            st = slo[kind]
            if st["window_total"] >= minreq:
                burn = max(burn, st["burn_rate"])
        dig = self.garage.telemetry.collect()
        loop_d = dig.get("loop") or {}
        lag = float(loop_d.get("p99") or 0.0)
        blocked = float(loop_d.get("blocked") or 0.0)
        fresh_stalls = (
            self._last_blocked is not None and blocked > self._last_blocked
        )
        if consume:
            self._last_blocked = blocked
        return burn, (lag if fresh_stalls else 0.0)

    # --- hysteresis state machine ---------------------------------------------

    def evaluate(self, now: float | None = None) -> None:
        """One control decision.  Separated from work() so tests drive
        it with a fake clock and injected signals."""
        if now is None:
            now = self.clock()
        cfg = self.cfg
        burn, lag = self.signals()
        lag_limit = float(cfg.loop_lag_p99_msec) / 1000.0
        overloaded = burn > float(cfg.ladder_burn_up) or lag > lag_limit
        recovered = (
            burn < float(cfg.ladder_burn_down) and lag < 0.5 * lag_limit
        )
        if overloaded:
            self._recovered_since = None
            if self.level < len(self.ladder):
                self._step_up(now, burn, lag)
        elif recovered and self.level > 0:
            if self._recovered_since is None:
                self._recovered_since = now
            elif now - self._recovered_since >= float(cfg.ladder_hold_secs):
                self._step_down(now, burn, lag)
                # hold again before the next step down: recovery is
                # re-proven at each level, so a marginal node descends
                # slowly instead of oscillating
                self._recovered_since = now
        else:
            # gray zone (or healthy at level 0): hold position
            self._recovered_since = None if not recovered else self._recovered_since

    def _step_up(self, now: float, burn: float, lag: float) -> None:
        step = self.ladder[self.level]
        try:
            self._saved.append(step.apply(self.garage))
        except Exception as e:  # noqa: BLE001 — a dead actuator must not
            # wedge the ladder; the rung applies as a no-op and the
            # controller keeps climbing if pressure persists
            logger.warning("ladder step %s failed to apply: %r", step.name, e)
            self._saved.append(None)
        self.level += 1
        self.steps_up += 1
        self.last_change = now
        self.last_reason = (
            f"burn={burn:.2f} lag_p99={lag * 1000:.0f}ms -> {step.name}"
        )
        registry.incr("overload_ladder_steps_total", (("direction", "up"),))
        logger.warning(
            "overload ladder UP to level %d (%s): %s",
            self.level, step.name, self.last_reason,
        )

    def _step_down(self, now: float, burn: float, lag: float) -> None:
        self.level -= 1
        step = self.ladder[self.level]
        saved = self._saved.pop()
        try:
            step.revert(self.garage, saved)
        except Exception as e:  # noqa: BLE001 — log and keep descending
            logger.warning("ladder step %s failed to revert: %r", step.name, e)
        self.steps_down += 1
        self.last_change = now
        self.last_reason = (
            f"burn={burn:.2f} lag_p99={lag * 1000:.0f}ms -> recover {step.name}"
        )
        registry.incr("overload_ladder_steps_total", (("direction", "down"),))
        logger.info(
            "overload ladder DOWN to level %d (recovered %s): %s",
            self.level, step.name, self.last_reason,
        )

    # --- worker ---------------------------------------------------------------

    async def work(self):
        self.evaluate()
        return (WorkerState.THROTTLED, float(self.cfg.check_interval_secs))

    def status_full(self) -> dict[str, Any]:
        """Ladder half of admin `GET /v1/overload`."""
        burn, lag = self.signals(consume=False)
        return {
            "level": self.level,
            "maxLevel": len(self.ladder),
            "ladder": [
                {"name": s.name, "applied": i < self.level}
                for i, s in enumerate(self.ladder)
            ],
            "burnRate": round(burn, 4),
            "loopLagP99Ms": round(lag * 1000.0, 2),
            "stepsUp": self.steps_up,
            "stepsDown": self.steps_down,
            "lastChangeAgoSecs": (
                round(self.clock() - self.last_change, 2)
                if self.last_change is not None
                else None
            ),
            "lastReason": self.last_reason,
            "thresholds": {
                "burnUp": self.cfg.ladder_burn_up,
                "burnDown": self.cfg.ladder_burn_down,
                "loopLagP99Msec": self.cfg.loop_lag_p99_msec,
                "holdSecs": self.cfg.ladder_hold_secs,
                "checkIntervalSecs": self.cfg.check_interval_secs,
            },
        }
