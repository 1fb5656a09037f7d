"""Seedable fault-injection plane (deterministic chaos nemesis).

Generalizes the binary `NetApp.blocked_peers` seam: a `FaultPlan` is a
per-node description of the faults its outgoing RPC traffic and local
disk should suffer, driven by ONE PRNG seeded explicitly — the same seed
replays the exact same fault sequence, so a chaos-test failure is
reproducible from its logged seed.

Fault kinds (per peer, or a default for all peers):

  latency_ms / jitter_ms   added one-way delay per outgoing call
  drop                     probability a request is lost: the call hangs
                           until the caller's timeout fires (like a real
                           lost packet — this is what exercises adaptive
                           timeouts + the circuit breaker, not a fast
                           error)
  truncate                 probability a served response stream is cut
                           mid-transfer (the receiver sees a StreamError,
                           not a short read)
  disk_write_fail /        probability a local block-file write/read
  disk_read_fail           raises OSError (block/manager.py honors these
                           when a plan is installed on the manager)

Install with `netapp.fault_plan = FaultPlan(seed).set_rule(...)` and/or
`block_manager.fault_plan = plan`; remove by setting None.  Every decision
the plan takes is appended to `plan.trace` as (op, peer_prefix, outcome),
which tests assert on for deterministic replay.

Reference analog: the reference tests this layer with external tooling
(mknet topologies + jepsen.garage); here the nemesis lives in-process so
single-process integration tests can run it deterministically.
"""

from __future__ import annotations

import random
from dataclasses import dataclass

from .stream import StreamError


@dataclass
class FaultRule:
    latency_ms: float = 0.0
    jitter_ms: float = 0.0
    drop: float = 0.0
    truncate: float = 0.0
    disk_write_fail: float = 0.0
    disk_read_fail: float = 0.0


class InjectedDiskFault(OSError):
    pass


TRACE_MAX = 100_000  # decisions kept for replay assertions; benches with a
# long-lived plan (thousands of calls) must not grow memory unboundedly


class FaultPlan:
    def __init__(self, seed: int):
        self.seed = seed
        self.rng = random.Random(seed)
        self.rules: dict[bytes, FaultRule] = {}
        self.default_rule: FaultRule | None = None
        self.trace: list[tuple] = []

    def set_rule(self, rule: FaultRule, peer: bytes | None = None) -> "FaultPlan":
        """Faults for calls toward `peer` (None = every peer without a
        specific rule).  Returns self for chaining.  Disk faults are
        node-LOCAL (there is no peer on a disk read), so they are only
        accepted on the default rule — a per-peer disk rule would be
        silently dead, which a chaos test must never be."""
        if peer is None:
            self.default_rule = rule
        else:
            if rule.disk_write_fail or rule.disk_read_fail:
                raise ValueError(
                    "disk faults are node-local: set them on the default "
                    "rule (set_rule(rule) without peer=)"
                )
            self.rules[peer] = rule
        return self

    def _rule(self, peer: bytes) -> FaultRule | None:
        return self.rules.get(peer, self.default_rule)

    def _note(self, op: str, peer: bytes, outcome) -> None:
        if len(self.trace) < TRACE_MAX:
            self.trace.append((op, peer.hex()[:8], outcome))

    # --- decisions (each draws from the seeded PRNG in call order) -----------

    def rpc_delay(self, peer: bytes) -> float:
        """Seconds of injected delay for one outgoing call."""
        r = self._rule(peer)
        if r is None or (r.latency_ms <= 0 and r.jitter_ms <= 0):
            return 0.0
        if r.jitter_ms <= 0:
            # fixed latency is not a PRNG decision: no draw, no trace
            # (bench seams add 2 ms to every call — tracing each would
            # be pure memory growth with zero replay value)
            return r.latency_ms / 1000.0
        d = r.latency_ms + self.rng.random() * r.jitter_ms
        self._note("delay", peer, round(d, 6))
        return d / 1000.0

    def should_drop(self, peer: bytes) -> bool:
        r = self._rule(peer)
        if r is None or r.drop <= 0:
            return False
        hit = self.rng.random() < r.drop
        self._note("drop", peer, hit)
        return hit

    def maybe_truncate_stream(self, peer: bytes, stream):
        """Wrap a response stream so it fails partway through (~uniform
        fraction of the chunks delivered, then StreamError)."""
        r = self._rule(peer)
        if stream is None or r is None or r.truncate <= 0:
            return stream
        hit = self.rng.random() < r.truncate
        self._note("truncate", peer, hit)
        if not hit:
            return stream
        cut_after = self.rng.randint(1, 4)  # chunks delivered before the cut

        async def gen():
            n = 0
            async for chunk in stream:
                if n >= cut_after:
                    raise StreamError(
                        f"injected stream truncation after {n} chunks "
                        f"(FaultPlan seed {self.seed})"
                    )
                n += 1
                yield chunk
            # stream shorter than the cut point: the fault misses

        return gen()

    def should_fail_disk(self, op: str) -> bool:
        """op: 'read' | 'write' — local block-store fault."""
        r = self.default_rule
        if r is None:
            return False
        p = r.disk_write_fail if op == "write" else r.disk_read_fail
        if p <= 0:
            return False
        hit = self.rng.random() < p
        if len(self.trace) < TRACE_MAX:
            self.trace.append(("disk-" + op, "", hit))
        return hit
