"""Overload-control plane, admission side: per-tenant token buckets,
a global in-flight cap, and priority classes in front of the S3
frontend.

PRs 5-6 built the sensors (SLO burn-rate gauges, latency X-ray, canary
probing); this module is the *actuator* on the request path.  Every S3
request passes through `AdmissionController.admit()` at the single
`_entry` choke point (api/s3/api_server.py) BEFORE any SigV4 work:

  - priority classes: interactive GET/HEAD (tier 0) > PUT/multipart
    (tier 1) > list/batch (tier 2) > anonymous (tier 3) — the HTTP-level
    mirror of the RPC frame priorities (net/message.py PRIO_*);
  - per-key and per-bucket token buckets (tenant isolation: one noisy
    key drains its own bucket, not the node);
  - a global in-flight concurrency cap (the knob that actually bounds
    memory/event-loop pressure under a burst);
  - queue-rather-than-reject for the TOP tier only: an interactive GET
    waits a bounded `queue_wait_msec` for capacity before shedding —
    every other tier sheds immediately (its work is retryable by
    design);
  - over-limit requests receive the S3-semantic `503 SlowDown` with a
    `Retry-After` hint (the response every AWS SDK backs off on).

Shed requests never enter `request_metrics` — they are counted in their
own `api_admission_shed_total{tier}` family and deliberately do NOT
increment `api_s3_request_counter` / `api_s3_error_counter`.  An
intentional shed must not burn the availability SLO budget: the
shedding controller (rpc/shedding.py) reads that budget, and counting
its own 503s against it would close a positive feedback loop (shed ->
more 5xx -> higher burn -> shed harder).

Admission happens before signature verification, so tenant identity is
the *claimed* key id parsed from the Authorization header.  A client
spoofing another tenant's key id can at worst drain that tenant's
token bucket (fairness accounting), never gain access — it still fails
SigV4 afterwards, and the global in-flight cap bounds the damage.

The canary prober's key is EXEMPT (registered by api/s3/canary.py at
client setup): shedding must not blind the exact probe signal the
shedding controller needs to decide when to recover.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import math
import re
import time
from collections import OrderedDict
from typing import Any

from ..utils.metrics import registry as global_registry

logger = logging.getLogger("garage.overload")

# priority classes, best (never ladder-shed, may queue) first
TIER_INTERACTIVE = 0  # authenticated object GET / HEAD
TIER_WRITE = 1  # PUT / POST / DELETE objects, multipart legs
TIER_LIST = 2  # listings, batch ops, bucket-config reads
TIER_ANON = 3  # no credential at all (incl. PostObject form uploads)
TIER_NAMES = ("interactive", "write", "list", "anonymous")

# claimed tenant identity, pre-auth: SigV4 header or presigned query
_CRED_RE = re.compile(r"Credential=([^/,\s]+)/")

# bounded queue poll quantum: waiters re-check capacity at this cadence
# (pure polling — _release() deliberately does not wake waiters early)
_QUEUE_QUANTUM = 0.02

# exemption is claimed pre-auth (the canary's key id travels in
# cleartext Authorization headers, so it is NOT a secret): bound how
# many concurrent requests the claim can admit past the normal checks.
# The canary probes serially — 4 is generous for it, and a spoofer
# replaying the id buys at most this much concurrency before falling
# through to normal admission (where the spoofed id just drains the
# canary's own token bucket)
_EXEMPT_MAX_IN_FLIGHT = 4

# per-tenant gauges carry a process-unique id label: several in-process
# nodes share the global registry, and two controllers
# tracking the same key id must not overwrite / unregister each other
_ctl_ids = itertools.count(1)


class TokenBucket:
    """Classic token bucket: `rate` tokens/s up to `burst`.  Rates are
    read live from the attributes so `worker set` style tuning applies
    to existing tenants, not only new ones."""

    def __init__(self, rate: float, burst: float, clock=time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst)
        self.clock = clock
        self.tokens = self.burst
        self._last = clock()

    def _refill(self) -> None:
        now = self.clock()
        self.tokens = min(
            self.burst, self.tokens + (now - self._last) * self.rate
        )
        self._last = now

    def take(self, n: float = 1.0) -> bool:
        self._refill()
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False

    def level(self) -> float:
        self._refill()
        return self.tokens

    def time_until(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (0 if now)."""
        self._refill()
        if self.tokens >= n:
            return 0.0
        if self.rate <= 0:
            return math.inf
        return (n - self.tokens) / self.rate


class Ticket:
    """The admit() verdict.  An admitted ticket MUST be release()d
    exactly once (the api server does it in a finally); release is
    idempotent so error paths can't double-free the in-flight slot."""

    __slots__ = ("admitted", "tier", "queued", "queued_secs", "retry_after",
                 "reason", "exempt", "_ctl")

    def __init__(self, admitted: bool, tier: int, *, queued: bool = False,
                 queued_secs: float = 0.0, retry_after: float = 1.0,
                 reason: str = "", exempt: bool = False, ctl=None):
        self.admitted = admitted
        self.tier = tier
        self.queued = queued
        # time spent in the admission queue before the slot opened —
        # the api server folds it into api_s3_request_duration so the
        # latency the SLO tracker sees is the latency the CLIENT saw
        # (queueing under load must be able to step the ladder)
        self.queued_secs = queued_secs
        self.retry_after = retry_after
        self.reason = reason
        self.exempt = exempt
        self._ctl = ctl

    def release(self) -> None:
        if self._ctl is not None:
            ctl, self._ctl = self._ctl, None
            ctl._release(exempt=self.exempt)


class AdmissionController:
    """One per node, constructed by model/garage.py from `[overload]`
    config.  All knobs are read live off the shared OverloadConfig
    dataclass, so `worker set overload-max-in-flight` (and tests
    mutating the config) apply immediately."""

    def __init__(self, cfg, registry=None, clock=time.monotonic):
        self.cfg = cfg
        self.registry = registry if registry is not None else global_registry
        self.clock = clock
        self.in_flight = 0
        self._exempt_in_flight = 0
        self._queue_len = 0
        self._shed_from: int | None = None  # ladder: shed tier >= this
        self._exempt: set[str] = set()
        self._key_buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self._bucket_buckets: OrderedDict[str, TokenBucket] = OrderedDict()
        self._gauge_id = str(next(_ctl_ids))
        # mirrors of the registry counters for status() (the registry is
        # process-global and may aggregate several in-process nodes)
        self.counts = {
            kind: [0] * len(TIER_NAMES) for kind in ("admitted", "queued", "shed")
        }
        self.exempt_admitted = 0

    # --- classification -------------------------------------------------------

    @staticmethod
    def claimed_key_id(request) -> str | None:
        """Pre-auth tenant identity: SigV4 `Credential=<key>/...` from
        the Authorization header, or `X-Amz-Credential` on presigned
        URLs.  None = anonymous."""
        auth = request.headers.get("Authorization", "")
        m = _CRED_RE.search(auth)
        if m:
            return m.group(1)
        cred = request.query.get("X-Amz-Credential")
        if cred:
            return cred.split("/", 1)[0]
        return None

    @staticmethod
    def classify(request, key: str, key_id: str | None) -> int:
        """Priority class of a request (`key` = object key from the
        path, "" for bucket-level)."""
        if key_id is None:
            return TIER_ANON
        q = request.query
        m = request.method
        if m in ("GET", "HEAD"):
            if not key:
                return TIER_LIST  # ListObjects / ListBuckets / bucket config
            if "uploadId" in q:
                return TIER_LIST  # ListParts
            return TIER_INTERACTIVE
        if m == "POST" and "delete" in q:
            return TIER_LIST  # DeleteObjects batch
        return TIER_WRITE  # PUT / POST / DELETE, incl. multipart legs

    # --- tenant buckets -------------------------------------------------------

    def _tenant_bucket(
        self, table: OrderedDict, ident: str, rate: float, burst: float,
        gauge: str, label: str, kind: str,
    ) -> TokenBucket:
        b = table.get(ident)
        if b is not None:
            table.move_to_end(ident)
            # live-tune existing tenants when the config knobs change
            b.rate, b.burst = float(rate), float(burst)
            return b
        b = TokenBucket(rate, burst, clock=self.clock)
        cap = max(1, int(self.cfg.max_tracked_tenants))
        if len(table) >= cap:
            # tenant-churn pressure: this create rides an eviction.
            # Identities are CLAIMED pre-auth, so an attacker cycling
            # > max_tracked_tenants fake ids could evict every real
            # tenant and hand each (itself included) a fresh full burst
            # per cycle — under pressure, new buckets start at one
            # second's refill instead of the full burst, bounding what
            # eviction churn can mint
            b.tokens = min(b.burst, max(b.rate, 1.0))
            self.registry.incr(
                "api_admission_tenant_evictions_total", (("kind", kind),)
            )
        table[ident] = b
        # graft-lint: allow-taint(claimed pre-auth id as a label value is by design — metrics._fmt applies _esc to EVERY label at exposition, so a hostile id cannot corrupt the scrape)
        self.registry.register_gauge(
            gauge, ((label, ident), ("id", self._gauge_id)), b.level
        )
        while len(table) > cap:
            old_ident, _old = table.popitem(last=False)
            self.registry.unregister_gauge(
                gauge, ((label, old_ident), ("id", self._gauge_id))
            )
        return b

    def _token_wait(
        self, key_id: str | None, bucket_name: str
    ) -> tuple[float, tuple]:
        """(seconds until one token is available on BOTH tenant buckets,
        the bucket pair) — a pure peek, nothing debited.  Debiting is
        separate (`_debit`) and happens only at the moment of admission:
        a request shed at the in-flight cap, or an interactive waiter
        re-checking every poll quantum, must not burn tokens it never
        used (the queue loop would otherwise drain a tenant's whole
        budget while waiting for a slot)."""
        cfg = self.cfg
        # the tenant label is named `tenant`, NOT `key`/`bucket`: the
        # metrics-lint cardinality guard (script/dashboard_lint.py)
        # reserves those label names for statically-bounded value sets —
        # per-object series are how exposition cardinality explodes
        # (hot-key data belongs in /v1/traffic's sketch JSON instead).
        # This family's value set is LRU-bounded by max_tracked_tenants.
        kb = (
            self._tenant_bucket(
                self._key_buckets, key_id, cfg.key_rate, cfg.key_burst,
                "api_admission_key_tokens", "tenant", "key",
            )
            if key_id
            else None
        )
        bb = (
            self._tenant_bucket(
                self._bucket_buckets, bucket_name, cfg.bucket_rate,
                cfg.bucket_burst, "api_admission_bucket_tokens", "tenant",
                "bucket",
            )
            if bucket_name
            else None
        )
        wait = 0.0
        for b in (kb, bb):
            if b is not None:
                wait = max(wait, b.time_until())
        return wait, (kb, bb)

    @staticmethod
    def _debit(buckets: tuple) -> None:
        for b in buckets:
            if b is not None:
                b.take()

    # --- admission ------------------------------------------------------------

    def exempt_key(self, key_id: str) -> None:
        """Exempt a key from admission entirely (canary prober): its
        probes must keep flowing at every ladder level, or shedding
        would blind the very signal that decides recovery."""
        self._exempt.add(key_id)

    def set_shed_tier(self, tier: int | None) -> None:
        """Ladder actuator (rpc/shedding.py): shed every request of
        tier >= `tier`; None sheds nothing.  Tier 0 is never shed —
        the floor is TIER_WRITE."""
        self._shed_from = max(TIER_WRITE, int(tier)) if tier is not None else None

    @property
    def shed_from_tier(self) -> int | None:
        return self._shed_from

    def _count(self, kind: str, tier: int) -> None:
        self.counts[kind][tier] += 1
        self.registry.incr(
            f"api_admission_{kind}_total", (("tier", TIER_NAMES[tier]),)
        )

    @staticmethod
    def _shed_tenant(key_id: str | None) -> None:
        # join admission sheds into the tenant observatory under the
        # CLAIMED key id — sheds happen pre-auth, so the claim is the
        # only identity there is (rpc/tenant.py keeps it sketch-bounded)
        try:
            from ..rpc.tenant import observatory

            observatory.record_shed(key_id)
        except Exception:  # noqa: BLE001
            pass  # graft-lint: allow-swallow(accounting must never turn a shed into a 500)

    def _release(self, exempt: bool = False) -> None:
        # queued waiters poll on _QUEUE_QUANTUM, so freeing a slot is
        # observed within ~20 ms without any notification machinery
        self.in_flight -= 1
        if exempt:
            self._exempt_in_flight -= 1

    async def admit(self, request, bucket_name: str, key: str) -> Ticket:
        """The one admission decision, called from `_entry` before any
        auth/parse work.  Never raises; returns an (un)admitted Ticket."""
        cfg = self.cfg
        key_id = self.claimed_key_id(request)
        tier = self.classify(request, key, key_id)
        if not cfg.enabled:
            return Ticket(True, tier)
        if (
            key_id is not None
            and key_id in self._exempt
            and self._exempt_in_flight < _EXEMPT_MAX_IN_FLIGHT
        ):
            # exempt = canary: admitted past the ladder/buckets/cap so
            # shedding can't blind the recovery signal — but the claim
            # is pre-auth data, so the bypass is concurrency-bounded
            # (_EXEMPT_MAX_IN_FLIGHT); over the bound the claim falls
            # through to normal admission like any other request
            self.exempt_admitted += 1
            self.registry.incr(
                "api_admission_admitted_total", (("tier", "exempt"),)
            )
            self.in_flight += 1
            self._exempt_in_flight += 1
            return Ticket(True, tier, exempt=True, ctl=self)

        if self._shed_from is not None and tier >= self._shed_from:
            self._count("shed", tier)
            self._shed_tenant(key_id)
            return Ticket(
                False, tier,
                retry_after=max(1.0, float(cfg.shed_retry_after_secs)),
                reason=f"load shedding active (ladder sheds tier >= "
                       f"{TIER_NAMES[self._shed_from]})",
            )

        token_wait, buckets = self._token_wait(key_id, bucket_name)
        cap_full = self.in_flight >= int(cfg.max_in_flight)
        if token_wait == 0.0 and not cap_full:
            self._debit(buckets)
            self._count("admitted", tier)
            self.in_flight += 1
            return Ticket(True, tier, ctl=self)

        if tier != TIER_INTERACTIVE:
            self._count("shed", tier)
            self._shed_tenant(key_id)
            reason = (
                "request rate over the tenant budget"
                if token_wait > 0
                else "node at its concurrency limit"
            )
            retry = token_wait if token_wait > 0 else float(
                cfg.shed_retry_after_secs
            )
            return Ticket(False, tier, retry_after=max(1.0, retry), reason=reason)

        # top tier: queue-rather-than-reject, bounded in depth and time
        if self._queue_len >= int(cfg.queue_depth):
            self._count("shed", tier)
            self._shed_tenant(key_id)
            return Ticket(
                False, tier, retry_after=max(1.0, float(cfg.shed_retry_after_secs)),
                reason="interactive admission queue is full",
            )
        entered = self.clock()
        deadline = entered + float(cfg.queue_wait_msec) / 1000.0
        self._queue_len += 1
        try:
            while True:
                remaining = deadline - self.clock()
                if remaining <= 0:
                    break
                await asyncio.sleep(min(_QUEUE_QUANTUM, remaining))
                token_wait, buckets = self._token_wait(key_id, bucket_name)
                if token_wait == 0.0 and self.in_flight < int(cfg.max_in_flight):
                    self._debit(buckets)
                    self._count("queued", tier)
                    self._count("admitted", tier)
                    self.in_flight += 1
                    return Ticket(True, tier, queued=True,
                                  queued_secs=self.clock() - entered, ctl=self)
        finally:
            self._queue_len -= 1
        self._count("shed", tier)
        self._shed_tenant(key_id)
        return Ticket(
            False, tier, retry_after=max(1.0, token_wait),
            reason=f"no capacity within {cfg.queue_wait_msec:g} ms queue wait",
        )

    # --- surfaces -------------------------------------------------------------

    def status(self) -> dict[str, Any]:
        """Admission half of admin `GET /v1/overload` / `cli overload
        status`."""
        cfg = self.cfg

        def top(table: OrderedDict, n: int = 8) -> dict[str, float]:
            # most-recently-active tenants (LRU order, newest last)
            return {
                ident: round(b.level(), 2)
                for ident, b in list(table.items())[-n:]
            }

        return {
            "enabled": bool(cfg.enabled),
            "inFlight": self.in_flight,
            "maxInFlight": int(cfg.max_in_flight),
            "queued": self._queue_len,
            "queueDepth": int(cfg.queue_depth),
            "shedFromTier": (
                TIER_NAMES[self._shed_from]
                if self._shed_from is not None
                else None
            ),
            "tiers": {
                TIER_NAMES[t]: {
                    "admitted": self.counts["admitted"][t],
                    "queued": self.counts["queued"][t],
                    "shed": self.counts["shed"][t],
                }
                for t in range(len(TIER_NAMES))
            },
            "exemptAdmitted": self.exempt_admitted,
            "exemptKeys": sorted(self._exempt),
            "keyTokens": top(self._key_buckets),
            "bucketTokens": top(self._bucket_buckets),
            "rates": {
                "keyRate": cfg.key_rate,
                "keyBurst": cfg.key_burst,
                "bucketRate": cfg.bucket_rate,
                "bucketBurst": cfg.bucket_burst,
            },
        }

    def digest_fields(self) -> dict[str, Any]:
        """The `ovl` block of the gossiped telemetry digest (additive
        keys; DIGEST_VERSION stays 1)."""
        return {
            "inf": self.in_flight,
            "shed": sum(self.counts["shed"]),
            "adm": sum(self.counts["admitted"]),
        }

    def close(self) -> None:
        """Unregister every per-tenant gauge (node shutdown — several
        in-process nodes share the registry, so leaking them would
        poison later tests/scrapes)."""
        for ident in self._key_buckets:
            self.registry.unregister_gauge(
                "api_admission_key_tokens",
                (("tenant", ident), ("id", self._gauge_id)),
            )
        for ident in self._bucket_buckets:
            self.registry.unregister_gauge(
                "api_admission_bucket_tokens",
                (("tenant", ident), ("id", self._gauge_id)),
            )
        self._key_buckets.clear()
        self._bucket_buckets.clear()
