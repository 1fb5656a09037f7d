"""Canary prober: low-rate synthetic S3 traffic against a hidden bucket.

The latency X-ray (`utils/latency.py`), the SLO budgets (`rpc/telemetry_digest.py`) and the
outlier detector all feed off real S3 request metrics — which means an
IDLE cluster is blind: no requests, no phase waterfall, no budget burn
signal, and a node that would fail every PUT looks healthy until a user
arrives.  The canary keeps a heartbeat of real traffic flowing: a
background `Worker` drives a PUT → GET (with payload verification) →
DELETE cycle through the node's own S3 HTTP frontend (full SigV4 + block
pipeline — the probe exercises exactly what a user request would) every
`[admin] canary_interval_secs`, against `[admin] canary_bucket` (default
`canary-probe`; hidden in the sense that only the canary's own key is
authorized on it, so normal keys' ListBuckets never show it).

Each probe leg lands in `canary_probe_duration{op,outcome}`; the cycle
health is the `canary_healthy{id}` gauge (registered at spawn,
unregistered at node shutdown, process-unique `id` —
several in-process nodes share the registry).  Probe totals
and p99 fold into the telemetry digest (`canary` block), so
`cluster top` shows canary health per node and a node whose canary fails
is visible cluster-wide with zero foreground traffic.

The probes also flow into the ordinary `api_s3_*` families and the phase
histograms — that is the point, not a side effect: the waterfall and the
SLO trackers always have a trickle of signal.
"""

from __future__ import annotations

import itertools
import logging
import os
import time

from ...utils.background import Worker, WorkerState
from ...utils.error import Error
from ...utils.metrics import registry

logger = logging.getLogger("garage.canary")

# process-unique gauge id (several in-process nodes share the registry;
# a per-node id would collide and one node's shutdown would delete the
# others' canary gauge)
_gauge_ids = itertools.count(1)

CANARY_KEY_NAME = "canary-probe"
# bounded object churn: probe keys rotate through a small ring so a
# wedged DELETE leg can't grow the hidden bucket without bound
KEY_RING = 16


class CanaryWorker(Worker):
    """One PUT/GET/DELETE probe cycle per `interval` seconds."""

    def __init__(
        self,
        garage,
        endpoint: str,
        interval: float = 60.0,
        object_bytes: int = 65536,
        bucket: str = "canary-probe",
    ):
        self.garage = garage
        self.endpoint = endpoint
        self.interval = float(interval)
        self.object_bytes = int(object_bytes)
        self.bucket = bucket
        self.gauge_id = str(next(_gauge_ids))
        self.healthy: float | None = None  # None until the first cycle
        self.probes = 0
        self.failed = 0
        self.last_error: str | None = None
        self._client = None
        self._seq = 0

    def name(self) -> str:
        return "canary"

    def status(self) -> dict:
        return {
            "bucket": self.bucket,
            "endpoint": self.endpoint,
            "probes": self.probes,
            "failed": self.failed,
            **({"last_error": self.last_error} if self.last_error else {}),
        }

    async def _ensure_client(self) -> None:
        """Find-or-create the canary key + hidden bucket.  The key is
        shared cluster-wide by name (the key table is replicated), so N
        nodes probing the same bucket don't accrete N keys."""
        if self._client is not None:
            return
        g = self.garage
        key = None
        for k in await g.helper.list_keys():
            if (k.params().name.get() or "") == CANARY_KEY_NAME:
                key = k
                break
        if key is None:
            key = await g.helper.create_key(CANARY_KEY_NAME)
        # admission exemption (api/overload.py): the canary's probes must
        # keep flowing at EVERY shedding-ladder level — shedding them
        # would blind the exact signal the shedding controller uses to
        # decide the node has recovered
        ctl = getattr(g, "overload", None)
        if ctl is not None:
            ctl.exempt_key(key.key_id)
        try:
            bid = await g.helper.resolve_bucket(self.bucket)
        except Error:
            bid = await g.helper.create_bucket(self.bucket)
        await g.helper.set_bucket_key_permissions(
            bid, key.key_id, True, True, False
        )
        from .client import S3Client

        self._client = S3Client(self.endpoint, key.key_id, key.secret())

    def _layout_can_store(self) -> bool:
        """A PUT needs a layout with enough storage nodes (EC: k+m per
        block).  A fresh node that hasn't been assigned a layout yet
        would fail every probe — that's bring-up, not an outage, and it
        must not burn the SLO budget or spam 500s."""
        cur = self.garage.layout_manager.history.current()
        need = max(1, self.garage.block_manager.codec.n_pieces)
        return len(cur.storage_nodes()) >= need

    async def work(self):
        if not self._layout_can_store():
            return (WorkerState.THROTTLED, self.interval)
        try:
            await self._ensure_client()
        except Exception as e:  # noqa: BLE001 — setup failure IS canary
            # data: raising would hand it to the worker supervisor, whose
            # exponential backoff silences the canary exactly during the
            # outage it should be reporting
            self.probes += 1
            self.failed += 1
            self.healthy = 0.0
            self.last_error = f"setup: {e!r}"
            logger.warning("canary setup failed: %r", e)
            return (WorkerState.THROTTLED, self.interval)
        c = self._client
        # per-node key ring: nodes sharing the hidden bucket must not
        # race each other's probe objects
        obj = (
            f"probe-{self.garage.node_id.hex()[:8]}-{self._seq % KEY_RING:02d}"
        )
        self._seq += 1
        body = os.urandom(self.object_bytes)

        async def get_and_verify():
            got = await c.get_object(self.bucket, obj)
            if got != body:
                raise Error("canary readback does not match what was PUT")

        ok_all, denied = True, False
        for op, fn in (
            ("put", lambda: c.put_object(self.bucket, obj, body)),
            ("get", get_and_verify),
            ("delete", lambda: c.delete_object(self.bucket, obj)),
        ):
            t0 = time.perf_counter()
            try:
                await fn()
                outcome = "ok"
            except Exception as e:  # noqa: BLE001 — a probe failure is a
                # datum, not a worker error (the supervisor would back off
                # and STOP probing exactly when signal matters most)
                outcome = "error"
                ok_all = False
                denied = denied or getattr(e, "status", None) == 403
                self.last_error = f"{op}: {e!r}"
                logger.warning("canary %s probe failed: %r", op, e)
            registry.observe(
                "canary_probe_duration",
                (("op", op), ("outcome", outcome)),
                time.perf_counter() - t0,
            )
        self.probes += 1
        if not ok_all:
            self.failed += 1
        self.healthy = 1.0 if ok_all else 0.0
        if denied:
            # the key's grant names another bucket than the alias does now
            # (two S3 nodes created the hidden bucket at once, and the
            # alias kept the other): set up again on the next cycle, which
            # grants on the bucket the alias names
            await self.stop_client()
        return (WorkerState.THROTTLED, self.interval)

    async def stop_client(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None


def digest_fields(reg=None) -> dict:
    """The `canary` block of the gossiped telemetry digest: cumulative
    probe count / failures + probe latency p99, read straight off the
    `canary_probe_duration` histogram (no parallel counter family to
    drift).  Zero-valued on nodes without a canary."""
    r = reg if reg is not None else registry
    return {
        "ops": r.histogram_family_count("canary_probe_duration"),
        "err": r.histogram_family_count(
            "canary_probe_duration",
            lambda labels: ("outcome", "error") in labels,
        ),
        "p99": r.family_quantile("canary_probe_duration", 0.99),
    }
