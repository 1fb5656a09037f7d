"""Daemon configuration: a single TOML file plus env-var / file secrets.

Mirrors reference src/util/config.rs:13-142 (knob inventory, defaults) and
src/garage/secrets.rs (secret layering: inline < file < env).  New in the
rebuild: `replication_mode` accepts `"ec:k:m"` to enable the TPU-batched
erasure-coded block codec.
"""

from __future__ import annotations

import os
import re

try:  # py3.11+ stdlib; absent on 3.10 containers — only read_config needs it
    import tomllib
except ImportError:
    tomllib = None
from dataclasses import dataclass, field
from typing import Any

DEFAULT_BLOCK_SIZE = 1024 * 1024  # 1 MiB, config.rs:273-275
DEFAULT_COMPRESSION_LEVEL = 1  # zstd level, config.rs:284


@dataclass
class DataDir:
    path: str
    capacity: int | None = None  # bytes; None = unlimited single-dir mode
    read_only: bool = False


@dataclass
class S3ApiConfig:
    api_bind_addr: str | None = None
    s3_region: str = "garage"
    root_domain: str | None = None


@dataclass
class K2VApiConfig:
    api_bind_addr: str | None = None


@dataclass
class WebConfig:
    bind_addr: str | None = None
    root_domain: str = ".web.garage"
    add_host_to_metrics: bool = False


@dataclass
class AdminConfig:
    api_bind_addr: str | None = None
    admin_token: str | None = None
    admin_token_file: str | None = None
    metrics_token: str | None = None
    metrics_token_file: str | None = None
    trace_sink: str | None = None
    # flight recorder (utils/flight.py): slow-request ring buffer served
    # from /v1/debug/slow — on by default so a node self-diagnoses with
    # zero external collectors (enables span creation without a sink)
    flight_recorder: bool = True
    slow_request_threshold_msec: float = 500.0
    slow_request_top_k: int = 64
    # event-loop watchdog: scheduling-lag histogram + blocked-loop task
    # dumps; 0 disables
    event_loop_watchdog_threshold_msec: float = 250.0
    # stall auto-capture (utils/profiler.StallProfiler): when the
    # watchdog counts a stall, sample the wedged process for a burst and
    # attach the top stacks to a `loop-stall-profile` flight event —
    # opt-in, the capture burns ~0.25 s of watchdog-thread time per
    # (rate-limited) episode
    stall_profile: bool = False
    # SLO tracker (rpc/telemetry_digest.py SloTracker): S3 availability
    # target (percent of requests answered without a 5xx) and p99
    # latency target, both accounted over a rolling window -> the
    # `slo_error_budget_remaining` / `slo_burn_rate` gauges and the
    # cluster rollup's SLO block
    slo_availability_target: float = 99.9  # percent
    slo_latency_p99_target_msec: float = 1000.0
    slo_window_secs: float = 3600.0
    # latency X-ray (utils/latency.py): phase-level critical-path
    # attribution of S3 requests, served from /v1/debug/latency — on by
    # default, zero external collectors (span-end hook like the flight
    # recorder)
    latency_xray: bool = True
    # canary prober (api/s3/canary.py): low-rate synthetic PUT/GET/DELETE
    # against a hidden bucket so the waterfall, SLO budgets and outlier
    # detector have signal on an idle cluster.  Spawned by the daemon
    # when the S3 API is enabled.
    canary_enabled: bool = True
    canary_interval_secs: float = 60.0
    canary_object_bytes: int = 65536
    # must be a valid S3 bucket name; "hidden" because only the canary's
    # own key is authorized on it (ListBuckets is per-key)
    canary_bucket: str = "canary-probe"
    # traffic observatory (rpc/traffic.py + utils/sketch.py): streaming
    # hot-object / op-mix / skew analytics fed from the S3 request path,
    # served from /v1/traffic (+ /v1/traffic/profile) — on by default,
    # bounded memory (Space-Saving top-K + Count-Min).  The halflife is
    # the exponential-decay window: "hot" means hot over roughly this
    # many seconds, not since process start.
    traffic_observatory: bool = True
    traffic_topk: int = 256
    traffic_halflife_secs: float = 600.0
    # rebalance observatory (rpc/transition.py): |clock offset| above
    # which a node gets the `SKEW!` flag in `cluster top` — beyond it
    # the merged event timeline's ordering is not trustworthy at
    # sub-threshold granularity
    clock_skew_warn_msec: float = 250.0
    # tenant observatory (rpc/tenant.py): per-authenticated-key usage
    # accounting + per-class SLO burn, gossiped as the `tn.*` digest
    # section and federated via /v1/cluster/tenants — on by default,
    # bounded memory (Space-Saving top-K over tenant ids gates exact
    # rows)
    tenant_observatory: bool = True
    tenant_topk: int = 64
    # HOG! threshold: a tenant whose cluster-wide consumption share
    # exceeds this multiple of the fair share (1/tenants) flags in
    # `cluster top` and emits the `tenant-hog` flight event
    tenant_hog_share: float = 3.0


@dataclass
class TenantClassConfig:
    """Rebuild-specific: one `[tenants.<class>]` SLO class for the
    tenant observatory (rpc/tenant.py).  A class names its availability
    and latency targets and lists the access-key ids that belong to it;
    keys not listed anywhere fall to the `default` class (which may
    itself be configured here to override the built-in targets)."""

    # percent of the tenant's requests answered without a 5xx
    availability_target: float = 99.9
    # per-request latency target: requests over it burn the tenant's
    # latency budget (same allowed fraction as availability)
    latency_target_msec: float = 1000.0
    # access-key ids (the AUTHENTICATED identity) in this class
    keys: list[str] = field(default_factory=list)


@dataclass
class ConsulDiscoveryConfig:
    """Reference src/util/config.rs ConsulDiscoveryConfig / consul.rs."""

    consul_http_addr: str = "http://127.0.0.1:8500"
    service_name: str = "garage-tpu"
    api: str = "catalog"  # "catalog" | "agent"
    token: str | None = None
    tags: list[str] = field(default_factory=list)
    meta: dict[str, str] = field(default_factory=dict)
    # TLS to the consul endpoint (reference config.rs ca_cert/client_cert/
    # client_key/tls_skip_verify)
    ca_cert: str | None = None
    client_cert: str | None = None
    client_key: str | None = None
    tls_skip_verify: bool = False


@dataclass
class KubernetesDiscoveryConfig:
    """Reference src/util/config.rs KubernetesDiscoveryConfig / kubernetes.rs."""

    namespace: str = "default"
    service_name: str = "garage-tpu"
    skip_crd: bool = False
    api_server: str | None = None  # None = in-cluster default
    token: str | None = None  # None = mounted service account


@dataclass
class RepairPlanConfig:
    """Rebuild-specific: admission-control defaults for the repair plane
    (block/repair_plan.py) — runtime-tunable via `worker set
    repair-tranquility` / `repair-bytes-in-flight`."""

    tranquility: int = 2  # Tranquilizer pacing between rounds (0 = flat out)
    bytes_in_flight: int = 128 * 1024 * 1024  # surviving-shard bytes / round
    batch_blocks: int | None = None  # None: 2x device mesh, min 256
    auto_resume: bool = True  # resume a checkpointed plan at daemon start


@dataclass
class DurabilityConfig:
    """Rebuild-specific: the durability observatory
    (block/durability.py DurabilityScanner) — an incremental
    rc-tree walk classifying every locally-owned block into redundancy
    classes (healthy / degraded / at_risk / unreadable), deriving
    zone-loss exposure, repair ETA and layout-transition progress.
    `worker set durability-tranquility` / `durability-interval-secs`
    tune the running scanner live."""

    enabled: bool = True
    # Tranquilizer pacing between scan batches (same contract as resync:
    # sleep tranquility x the average batch duration; 0 = flat out)
    tranquility: int = 2
    # rc-tree keys classified per work() iteration
    scan_batch: int = 256
    # seconds between full ledger passes (a layout change kicks one
    # immediately); tests tune this down
    interval_secs: float = 60.0
    # a resync-errored block older than this counts "stuck" rather than
    # "transient" in the ledger (error ages, block/resync.py)
    stuck_error_secs: float = 900.0


@dataclass
class OverloadConfig:
    """Rebuild-specific: the overload-control plane (api/overload.py
    admission controller + rpc/shedding.py SLO-driven shedding ladder).
    Defaults are sized for a single node serving heavy mixed traffic;
    `worker set overload-max-in-flight` tunes the cap live."""

    enabled: bool = True
    # global concurrency cap: requests processing at once on this node
    max_in_flight: int = 256
    # per-access-key token bucket (tokens/sec, burst ceiling)
    key_rate: float = 200.0
    key_burst: float = 400.0
    # per-bucket token bucket — a bucket is a tenant surface too (many
    # keys can hammer one bucket)
    bucket_rate: float = 500.0
    bucket_burst: float = 1000.0
    # LRU bound on tracked tenants (keys + buckets each)
    max_tracked_tenants: int = 1024
    # top tier (interactive GET/HEAD) queues up to this long for
    # capacity instead of shedding; bounded depth
    queue_wait_msec: float = 2000.0
    queue_depth: int = 64
    # Retry-After hint on 503 SlowDown when no better estimate exists
    shed_retry_after_secs: float = 2.0
    # shedding controller (rpc/shedding.py): evaluation cadence and
    # hysteresis thresholds on the max SLO burn rate / loop lag p99
    check_interval_secs: float = 5.0
    ladder_burn_up: float = 2.0  # step up while burn exceeds this
    ladder_burn_down: float = 0.5  # recovery requires burn below this
    loop_lag_p99_msec: float = 500.0  # or event-loop lag p99 over this
    ladder_hold_secs: float = 30.0  # continuous recovery before a step down
    # noise floor: the burn signal only counts once the SLO window holds
    # at least this many requests — one 500 on an idle node must not
    # walk the ladder (mirrors the outlier detector's eps floor)
    min_window_requests: int = 100


@dataclass
class BlockConfig:
    """Rebuild-specific: foreground block-layer tuning — the cross-
    request codec batcher (block/codec_batch.py) and the CPU-offload
    thresholds of the PUT pipeline.  `codec-batch-linger-msec` /
    `codec-batch-max-blocks` tune the live batcher via `worker set`."""

    # cross-request codec batcher (EC write path)
    batch_enabled: bool = True
    # how long a lone block may wait for companions before its dispatch
    # flushes anyway — bounds the single-client latency tax
    batch_linger_msec: float = 2.0
    # a full batch flushes immediately (mesh-sized dispatch ceiling)
    batch_max_blocks: int = 64
    batch_max_bytes: int = 64 * 1024 * 1024
    # dispatch backend: "auto" (device kernel on TPU backends, native
    # host codec on CPU), or force "xla" / "host"
    batch_impl: str = "auto"
    # CPU-bound work this size or larger leaves the event loop
    # (replica-path zstd, content hashing): below it the thread-hop
    # overhead exceeds the stall it avoids
    cpu_offload_min_bytes: int = 64 * 1024
    # EC read path (doc/monitoring.md read-path runbook):
    # hot-block cache budget — a bounded-bytes LRU of assembled
    # plaintext blocks per node (0 disables; live `worker set
    # read-cache-bytes`)
    read_cache_bytes: int = 128 * 1024 * 1024
    # hedged reads: when a fetch stays unanswered past an RTT-derived
    # delay (slowest healthy peer's EWMA x mult, floored at min), a
    # hedge launches to the next candidate / a parity rank
    read_hedge_enabled: bool = True
    read_hedge_min_msec: float = 30.0
    read_hedge_rtt_mult: float = 4.0


@dataclass
class MetaConfig:
    """Rebuild-specific knobs for the metadata plane: the
    `model/` sharded tables carry their own replication factor — the
    metadata ring, first `replication_factor` distinct nodes of each
    partition's layout node list (table/replication.py
    TableMetaReplication) — so table quorums stay O(1) in EC stripe
    width, plus the table insert coalescer (table/coalesce.py) the
    smaller quorum makes worth having.  `worker set
    meta-coalesce-linger-msec` / `meta-coalesce-max-entries` tune the
    live coalescers."""

    # metadata replication factor.  On layouts whose own rf is SMALLER
    # (replica modes "1"/"2") the ring falls back to the full partition
    # node list — the effective factor is min(this, layout rf).
    replication_factor: int = 3
    # cross-caller coalescing of table inserts: same-destination rows
    # from concurrent requests share one RPC per node (CodecBatcher lane
    # pattern).  A lone insert flushes after the linger; a full batch
    # flushes immediately.
    coalesce_enabled: bool = True
    coalesce_linger_msec: float = 1.0
    coalesce_max_entries: int = 256
    # metadata fast path: per-node LRU of COMPLETE versions' rows —
    # safe because a visible complete version's block list is immutable
    # (model/s3/version_table.py VersionRowCache); 0 disables
    version_cache_entries: int = 1024


@dataclass
class TpuConfig:
    """Rebuild-specific: the device of the EC block codec and the batched
    scrub hashing (no analog in the reference).  The section keeps the
    reference's name so that one config file serves both packages; the
    port reads `enable` and `platform` (`model/garage.py::codec_device`)."""

    enable: bool = True  # false: the kernels' plain versions on the CPU
    platform: str | None = None  # "cpu" as enable = false; anything else: the CUDA card
    batch_blocks: int = 1024  # parsed, not read by the port
    max_dispatch_bytes: int = 256 * 1024 * 1024  # parsed, not read by the port


@dataclass
class Config:
    metadata_dir: str = ""
    data_dir: list[DataDir] = field(default_factory=list)

    db_engine: str = "sqlite"  # "sqlite" | "log" | "native" | "memory" (reference: lmdb|sqlite)
    # disabled by default like the reference (src/util/config.rs:19-21
    # "Whether to fsync after all metadata transactions (disabled by
    # default)"): a process crash can't lose committed metadata (the page
    # cache survives), only a host crash can — and quorum replication is
    # the durability story there.  Engine mapping: log/native skip the
    # per-commit fdatasync; sqlite runs WAL+synchronous=NORMAL (sync at
    # checkpoints only) vs FULL when true.
    # Round 4: the native engine also accepts "group" — group commit, a
    # C++ flusher coalesces concurrent commits into shared fdatasyncs
    # (durability window ~ one fdatasync; full sync at barriers).
    metadata_fsync: bool | str = False
    data_fsync: bool = False
    metadata_auto_snapshot_interval: int | None = None  # msec
    metadata_snapshots_dir: str | None = None  # default <metadata_dir>/snapshots
    disable_scrub: bool = False
    use_local_tz: bool = False  # lifecycle worker day boundaries
    allow_punycode: bool = False  # xn-- bucket names/aliases
    # "text" | "json" — JSON-lines output with trace_id/span_id stamping
    # (utils/log_fmt.py); env GARAGE_LOG_FORMAT overrides
    log_format: str = "text"

    block_size: int = DEFAULT_BLOCK_SIZE
    block_ram_buffer_max: int = 256 * 1024 * 1024
    compression_level: int | None = DEFAULT_COMPRESSION_LEVEL  # None = off

    replication_factor: int = 1
    consistency_mode: str = "consistent"  # consistent|degraded|dangerous
    # Rebuild extension: "ec:k:m" selects the erasure-coded block codec;
    # metadata tables always use plain replication_factor.
    replication_mode: str | None = None

    rpc_secret: str | None = None
    rpc_secret_file: str | None = None
    rpc_bind_addr: str = "127.0.0.1:3901"
    rpc_bind_outgoing: bool = False
    rpc_public_addr: str | None = None
    # pick the public address automatically: first local interface address
    # inside this CIDR (reference config.rs rpc_public_addr_subnet)
    rpc_public_addr_subnet: str | None = None
    rpc_timeout_msec: int = 10_000
    rpc_ping_timeout_msec: int | None = None  # default net/peering.PING_TIMEOUT

    bootstrap_peers: list[str] = field(default_factory=list)

    allow_world_readable_secrets: bool = False

    meta: MetaConfig = field(default_factory=MetaConfig)
    s3_api: S3ApiConfig = field(default_factory=S3ApiConfig)
    k2v_api: K2VApiConfig = field(default_factory=K2VApiConfig)
    s3_web: WebConfig = field(default_factory=WebConfig)
    admin: AdminConfig = field(default_factory=AdminConfig)
    block: BlockConfig = field(default_factory=BlockConfig)
    tpu: TpuConfig = field(default_factory=TpuConfig)
    repair: RepairPlanConfig = field(default_factory=RepairPlanConfig)
    durability: DurabilityConfig = field(default_factory=DurabilityConfig)
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    consul_discovery: ConsulDiscoveryConfig | None = None
    kubernetes_discovery: KubernetesDiscoveryConfig | None = None
    # `[tenants.<class>]` SLO classes for the tenant observatory
    # (rpc/tenant.py): class name -> targets + member key ids
    tenants: dict[str, TenantClassConfig] = field(default_factory=dict)

    # --- derived -----------------------------------------------------------

    def ec_params(self) -> tuple[int, int] | None:
        """(k, m) when replication_mode = "ec:k:m", else None."""
        if self.replication_mode and self.replication_mode.startswith("ec:"):
            m = re.fullmatch(r"ec:(\d+):(\d+)", self.replication_mode)
            if not m:
                raise ValueError(
                    f"bad replication_mode {self.replication_mode!r}, want ec:k:m"
                )
            k, mm = int(m.group(1)), int(m.group(2))
            if not (1 <= k <= 128 and 1 <= mm <= 128 and k + mm <= 255):
                raise ValueError("ec:k:m out of range (k+m must be <= 255)")
            return (k, mm)
        return None


def _get_secret(
    inline: str | None, file_path: str | None, env_name: str, allow_world_readable: bool
) -> str | None:
    """Secret layering (reference src/garage/secrets.rs): env overrides;
    inline + file together is an ambiguous config and refused
    (secrets.rs:98 "only one of `x` and `x_file` can be set"); file must
    not be world-readable."""
    if inline and file_path:
        raise ValueError(
            f"only one of the inline secret and its _file variant may be "
            f"set (env {env_name})"
        )
    env = os.environ.get(env_name)
    if env:
        return env.strip()
    if file_path:
        st = os.stat(file_path)
        # refuse any group/other access bits (reference src/garage/secrets.rs:128)
        if st.st_mode & 0o077 and not allow_world_readable:
            raise ValueError(
                f"secret file {file_path} is accessible by group/others "
                f"(mode {st.st_mode & 0o777:o}); refusing "
                "(set allow_world_readable_secrets = true to override)"
            )
        with open(file_path) as f:
            return f.read().strip()
    return inline


def _parse_toml_minimal(text: str) -> dict[str, Any]:
    """Fallback TOML-subset parser for interpreters without tomllib
    (python < 3.11 containers): comments, [dotted.sections], and
    `key = value` with string / int / float / bool / single-line array
    values — the full shape of garage config files.  Anything fancier
    raises rather than guessing."""

    def scalar(tok: str):
        tok = tok.strip()
        if len(tok) >= 2 and tok[0] == tok[-1] and tok[0] in "\"'":
            body = tok[1:-1]
            if tok[0] == '"':
                body = (
                    body.replace("\\\\", "\x00")
                    .replace('\\"', '"')
                    .replace("\\n", "\n")
                    .replace("\\t", "\t")
                    .replace("\x00", "\\")
                )
            return body
        if tok in ("true", "false"):
            return tok == "true"
        try:
            return int(tok)
        except ValueError:
            pass
        try:
            return float(tok)
        except ValueError:
            raise ValueError(f"unsupported TOML value {tok!r}") from None

    def split_csv(body: str) -> list[str]:
        out, cur, quote = [], "", None
        for ch in body:
            if quote:
                cur += ch
                if ch == quote and not cur.endswith("\\" + quote):
                    quote = None
            elif ch in "\"'":
                quote = ch
                cur += ch
            elif ch == ",":
                out.append(cur)
                cur = ""
            else:
                cur += ch
        if cur.strip():
            out.append(cur)
        return out

    root: dict[str, Any] = {}
    table = root
    for lineno, raw_line in enumerate(text.splitlines(), 1):
        line = raw_line.strip()
        if not line or line.startswith("#"):
            continue
        if line.startswith("["):
            if not line.endswith("]") or line.startswith("[["):
                raise ValueError(f"line {lineno}: unsupported section {line!r}")
            table = root
            for part in line[1:-1].strip().split("."):
                table = table.setdefault(part.strip(), {})
            continue
        key, eq, val = line.partition("=")
        if not eq:
            raise ValueError(f"line {lineno}: expected key = value, got {line!r}")
        key = key.strip()
        target = table
        if key.startswith('"') and key.endswith('"'):
            key = key[1:-1]  # quoted key: dots are literal
        elif "." in key:
            # dotted key nests, exactly like tomllib ('a.b = 1' ->
            # {'a': {'b': 1}}) — storing the literal "a.b" would make the
            # same file parse differently on py3.11 vs the fallback
            *parents, key = [part.strip().strip('"') for part in key.split(".")]
            for part in parents:
                target = target.setdefault(part, {})
        val = val.strip()
        # strip a trailing comment: first '#' OUTSIDE any quoted string
        quote = None
        for i, ch in enumerate(val):
            if quote:
                if ch == quote and val[i - 1] != "\\":
                    quote = None
            elif ch in "\"'":
                quote = ch
            elif ch == "#":
                val = val[:i].strip()
                break
        if val.startswith("["):
            if not val.endswith("]"):
                raise ValueError(
                    f"line {lineno}: multi-line arrays need python >= 3.11"
                )
            target[key] = [scalar(t) for t in split_csv(val[1:-1])]
        else:
            target[key] = scalar(val)
    return root


def read_config(path: str) -> Config:
    # the loop is not serving traffic before the config exists
    if tomllib is not None:
        # graft-lint: allow-blocking(startup-only config read)
        with open(path, "rb") as f:
            raw = tomllib.load(f)
    else:
        # graft-lint: allow-blocking(startup-only config read)
        with open(path, encoding="utf-8") as f:
            raw = _parse_toml_minimal(f.read())
    return config_from_dict(raw)


def config_from_dict(raw: dict[str, Any]) -> Config:
    cfg = Config()
    simple = {
        f
        for f in (
            "metadata_dir db_engine metadata_fsync data_fsync block_size "
            "block_ram_buffer_max replication_factor consistency_mode "
            "replication_mode rpc_secret rpc_secret_file rpc_bind_addr "
            "rpc_bind_outgoing rpc_public_addr rpc_public_addr_subnet "
            "rpc_timeout_msec rpc_ping_timeout_msec "
            "bootstrap_peers allow_world_readable_secrets "
            "metadata_auto_snapshot_interval metadata_snapshots_dir "
            "disable_scrub use_local_tz allow_punycode log_format"
        ).split()
    }
    for k, v in raw.items():
        if k in simple:
            setattr(cfg, k, v)
        elif k == "compression_level":
            # "none" disables; any integer (incl. 0) is a zstd level
            # (reference src/util/config.rs:288-315)
            if v == "none":
                cfg.compression_level = None
            elif isinstance(v, bool) or not isinstance(v, int):
                raise ValueError(f"bad compression_level {v!r}")
            else:
                cfg.compression_level = v
        elif k == "data_dir":
            if isinstance(v, str):
                cfg.data_dir = [DataDir(path=v)]
            else:
                cfg.data_dir = [
                    DataDir(
                        path=d["path"],
                        capacity=_parse_capacity(d.get("capacity")),
                        read_only=bool(d.get("read_only", False)),
                    )
                    for d in v
                ]
        elif k == "meta":
            cfg.meta = MetaConfig(**_known(v, MetaConfig))
        elif k == "s3_api":
            cfg.s3_api = S3ApiConfig(**_known(v, S3ApiConfig))
        elif k == "k2v_api":
            cfg.k2v_api = K2VApiConfig(**_known(v, K2VApiConfig))
        elif k == "s3_web":
            cfg.s3_web = WebConfig(**_known(v, WebConfig))
        elif k == "admin":
            cfg.admin = AdminConfig(**_known(v, AdminConfig))
        elif k == "block":
            cfg.block = BlockConfig(**_known(v, BlockConfig))
        elif k == "tpu":
            cfg.tpu = TpuConfig(**_known(v, TpuConfig))
        elif k == "repair":
            cfg.repair = RepairPlanConfig(**_known(v, RepairPlanConfig))
        elif k == "durability":
            cfg.durability = DurabilityConfig(**_known(v, DurabilityConfig))
        elif k == "overload":
            cfg.overload = OverloadConfig(**_known(v, OverloadConfig))
        elif k == "consul_discovery":
            cfg.consul_discovery = ConsulDiscoveryConfig(
                **_known(v, ConsulDiscoveryConfig)
            )
        elif k == "kubernetes_discovery":
            cfg.kubernetes_discovery = KubernetesDiscoveryConfig(
                **_known(v, KubernetesDiscoveryConfig)
            )
        elif k == "tenants":
            if not isinstance(v, dict):
                raise ValueError(
                    "[tenants] must be a table of [tenants.<class>] "
                    "sections"
                )
            cfg.tenants = {
                str(name): TenantClassConfig(**_known(tc, TenantClassConfig))
                for name, tc in v.items()
            }
        # unknown sections are ignored (forward compat)
    # metadata_fsync is tri-state, not stringly-typed: anything else (a
    # "goup" typo, "yes", 2) used to fall through as a truthy value and
    # silently select per-commit sync — validate at load, fail loudly
    if cfg.metadata_fsync not in (True, False, "group"):
        raise ValueError(
            f"invalid metadata_fsync {cfg.metadata_fsync!r}: accepted values "
            'are true, false, or "group" (group commit, native engine only)'
        )
    # SLO knobs: a target of 100.0 would make the allowed-error fraction
    # zero (every request burns infinite budget) — refuse the footgun at
    # load time along with plainly-invalid values
    if not (0.0 < float(cfg.admin.slo_availability_target) < 100.0):
        raise ValueError(
            f"invalid slo_availability_target "
            f"{cfg.admin.slo_availability_target!r}: want a percentage in "
            "(0, 100), e.g. 99.9"
        )
    if float(cfg.admin.slo_latency_p99_target_msec) <= 0:
        raise ValueError("slo_latency_p99_target_msec must be > 0")
    if float(cfg.admin.slo_window_secs) <= 0:
        raise ValueError("slo_window_secs must be > 0")
    # canary knobs: an interval of 0 would busy-loop synthetic traffic
    # through the full S3 stack; an empty bucket name can't be created
    if float(cfg.admin.canary_interval_secs) <= 0:
        raise ValueError("canary_interval_secs must be > 0")
    if int(cfg.admin.canary_object_bytes) < 1:
        raise ValueError("canary_object_bytes must be >= 1")
    if not str(cfg.admin.canary_bucket).strip():
        raise ValueError("canary_bucket must be a non-empty bucket name")
    # traffic observatory: a tiny top-K can't rank anything, a zero/
    # negative halflife breaks the decay math at the first sweep
    if int(cfg.admin.traffic_topk) < 8:
        raise ValueError("traffic_topk must be >= 8")
    if float(cfg.admin.traffic_halflife_secs) <= 0:
        raise ValueError("traffic_halflife_secs must be > 0")
    # rebalance observatory: a non-positive skew threshold would flag
    # every node SKEW! on the first status exchange
    if float(cfg.admin.clock_skew_warn_msec) <= 0:
        raise ValueError("clock_skew_warn_msec must be > 0")
    # tenant observatory: a tiny top-K can't rank anything; a hog
    # threshold below 1 would flag tenants consuming LESS than their
    # fair share
    if int(cfg.admin.tenant_topk) < 8:
        raise ValueError("tenant_topk must be >= 8")
    if float(cfg.admin.tenant_hog_share) < 1:
        raise ValueError("tenant_hog_share must be >= 1")
    # `[tenants.<class>]` SLO classes: same footguns as the global slo_*
    # knobs — a 100% availability target makes the allowed-error
    # fraction zero, and a key id claimed by two classes would make
    # per-tenant burn depend on dict iteration order
    seen_keys: dict[str, str] = {}
    for name, tc in cfg.tenants.items():
        if not str(name).strip():
            raise ValueError("[tenants] class names must be non-empty")
        # class names become a metric LABEL value (api_tenant_class_*):
        # the shape contract enrolled in BOUNDED_LABEL_VALUES
        # (script/dashboard_lint.py) is enforced here, at config load
        if not re.fullmatch(r"[a-zA-Z0-9][a-zA-Z0-9_.\-]{0,63}", str(name)):
            raise ValueError(
                f"invalid tenants class name {name!r}: want "
                "[a-zA-Z0-9][a-zA-Z0-9_.-]{0,63}"
            )
        if not (0.0 < float(tc.availability_target) < 100.0):
            raise ValueError(
                f"invalid tenants.{name}.availability_target "
                f"{tc.availability_target!r}: want a percentage in "
                "(0, 100), e.g. 99.9"
            )
        if float(tc.latency_target_msec) <= 0:
            raise ValueError(
                f"tenants.{name}.latency_target_msec must be > 0"
            )
        for kid in tc.keys or []:
            other = seen_keys.get(kid)
            if other is not None:
                raise ValueError(
                    f"key {kid!r} listed in both tenant classes "
                    f"{other!r} and {name!r}"
                )
            seen_keys[kid] = str(name)
    # durability observatory knobs: a zero batch can never finish a
    # pass, a non-positive interval busy-loops full rc-tree walks
    du = cfg.durability
    if int(du.scan_batch) < 1:
        raise ValueError("durability.scan_batch must be >= 1")
    if float(du.interval_secs) <= 0:
        raise ValueError("durability.interval_secs must be > 0")
    if int(du.tranquility) < 0:
        raise ValueError("durability.tranquility must be >= 0")
    if float(du.stuck_error_secs) <= 0:
        raise ValueError("durability.stuck_error_secs must be > 0")
    # overload knobs: refuse values that would wedge admission at load
    # time (a zero rate admits nothing forever; inverted hysteresis
    # thresholds would make the ladder oscillate by construction)
    ov = cfg.overload
    if int(ov.max_in_flight) < 1:
        raise ValueError("overload.max_in_flight must be >= 1")
    for knob in ("key_rate", "bucket_rate"):
        if float(getattr(ov, knob)) <= 0:
            raise ValueError(f"overload.{knob} must be > 0")
    # a burst below 1 caps the bucket under one whole token: take(1)
    # can never succeed and every tenant wedges permanently
    for knob in ("key_burst", "bucket_burst"):
        if float(getattr(ov, knob)) < 1:
            raise ValueError(f"overload.{knob} must be >= 1")
    if float(ov.queue_wait_msec) < 0 or int(ov.queue_depth) < 0:
        raise ValueError("overload queue_wait_msec/queue_depth must be >= 0")
    if not (0 <= float(ov.ladder_burn_down) < float(ov.ladder_burn_up)):
        raise ValueError(
            "overload.ladder_burn_down must be < ladder_burn_up (hysteresis)"
        )
    if float(ov.check_interval_secs) <= 0 or float(ov.ladder_hold_secs) <= 0:
        raise ValueError(
            "overload check_interval_secs/ladder_hold_secs must be > 0"
        )
    if float(ov.loop_lag_p99_msec) <= 0:
        raise ValueError("overload.loop_lag_p99_msec must be > 0")
    # block-layer batching knobs: refuse values that would wedge the
    # batcher at load time (a zero-block batch cap can never dispatch;
    # a negative linger is a time-travel request)
    blk = cfg.block
    if float(blk.batch_linger_msec) < 0:
        raise ValueError("block.batch_linger_msec must be >= 0")
    if int(blk.batch_max_blocks) < 1:
        raise ValueError("block.batch_max_blocks must be >= 1")
    if int(blk.batch_max_bytes) < 1:
        raise ValueError("block.batch_max_bytes must be >= 1")
    if blk.batch_impl not in ("auto", "host", "xla"):
        raise ValueError(
            f"invalid block.batch_impl {blk.batch_impl!r}: "
            'want "auto", "host" or "xla"'
        )
    if int(blk.cpu_offload_min_bytes) < 0:
        raise ValueError("block.cpu_offload_min_bytes must be >= 0")
    # read-path knobs: a negative cache budget is nonsense
    # (0 = disabled is fine); a zero/negative hedge multiplier would
    # hedge every read unconditionally the moment any EWMA exists
    if int(blk.read_cache_bytes) < 0:
        raise ValueError("block.read_cache_bytes must be >= 0")
    if float(blk.read_hedge_min_msec) < 0:
        raise ValueError("block.read_hedge_min_msec must be >= 0")
    if float(blk.read_hedge_rtt_mult) <= 0:
        raise ValueError("block.read_hedge_rtt_mult must be > 0")
    # resolve secrets
    cfg.rpc_secret = _get_secret(
        cfg.rpc_secret,
        cfg.rpc_secret_file,
        "GARAGE_RPC_SECRET",
        cfg.allow_world_readable_secrets,
    )
    cfg.admin.admin_token = _get_secret(
        cfg.admin.admin_token,
        cfg.admin.admin_token_file,
        "GARAGE_ADMIN_TOKEN",
        cfg.allow_world_readable_secrets,
    )
    cfg.admin.metrics_token = _get_secret(
        cfg.admin.metrics_token,
        cfg.admin.metrics_token_file,
        "GARAGE_METRICS_TOKEN",
        cfg.allow_world_readable_secrets,
    )
    # parity with reference legacy replication_mode values
    # ("1"|"2"|"3"|"2-dangerous"|"3-degraded"|"3-dangerous",
    #  src/rpc/replication_mode.rs:74-80); "ec:k:m" is the rebuild extension
    if cfg.replication_mode and not cfg.replication_mode.startswith("ec:"):
        legacy = {
            "1": (1, "consistent"),
            "2": (2, "consistent"),
            "2-dangerous": (2, "dangerous"),
            "3": (3, "consistent"),
            "3-degraded": (3, "degraded"),
            "3-dangerous": (3, "dangerous"),
        }
        if cfg.replication_mode not in legacy:
            raise ValueError(
                f"invalid replication_mode {cfg.replication_mode!r} "
                "(want 1|2|3[-degraded|-dangerous] or ec:k:m)"
            )
        cfg.replication_factor, cfg.consistency_mode = legacy[cfg.replication_mode]
        cfg.replication_mode = None
    ec = cfg.ec_params()  # validates ec:k:m syntax at parse time
    if ec is not None:
        # every block needs k+m distinct nodes: the layout's replication
        # factor IS the stripe width (shard placement constraint).  An
        # explicitly configured mismatching value is an error, not a
        # silent override (it would change metadata quorums invisibly).
        k, m = ec
        if "replication_factor" in raw and cfg.replication_factor != k + m:
            raise ValueError(
                f"replication_mode {cfg.replication_mode!r} requires "
                f"replication_factor = {k + m} (or omit it); got "
                f"{cfg.replication_factor}"
            )
        cfg.replication_factor = k + m
    # metadata plane: validated AFTER the mode resolution
    # above so cfg.replication_factor is final.  The layout needs at
    # least `replication_factor` storage nodes, so that is the smallest
    # cluster this config can run — an EXPLICIT meta factor above it
    # could never place its ring and is a config error, not a silent
    # runtime clamp.  The unconfigured default (3) clamps instead
    # (replica modes "1"/"2" fall back to the full partition node list,
    # table/replication.py).
    mt = cfg.meta
    if int(mt.replication_factor) < 1:
        raise ValueError("meta.replication_factor must be >= 1")
    if (
        "meta" in raw
        and "replication_factor" in raw["meta"]
        and int(mt.replication_factor) > cfg.replication_factor
    ):
        raise ValueError(
            f"meta.replication_factor {mt.replication_factor} exceeds the "
            f"cluster replication factor {cfg.replication_factor} (the "
            "minimum cluster size): the metadata ring could never place "
            f"{mt.replication_factor} distinct replicas"
        )
    if float(mt.coalesce_linger_msec) < 0:
        raise ValueError("meta.coalesce_linger_msec must be >= 0")
    if int(mt.coalesce_max_entries) < 1:
        raise ValueError("meta.coalesce_max_entries must be >= 1")
    if int(mt.version_cache_entries) < 0:
        raise ValueError("meta.version_cache_entries must be >= 0")
    return cfg


def _known(d: dict[str, Any], cls: type) -> dict[str, Any]:
    fields = cls.__dataclass_fields__  # type: ignore[attr-defined]
    return {k: v for k, v in d.items() if k in fields}


_CAP_RE = re.compile(r"^\s*([0-9.]+)\s*([kKmMgGtT]?)(i?)[bB]?\s*$")
_CAP_DEC = {"": 1, "k": 10**3, "m": 10**6, "g": 10**9, "t": 10**12}
_CAP_BIN = {"": 1, "k": 2**10, "m": 2**20, "g": 2**30, "t": 2**40}


def _parse_capacity(v: Any) -> int | None:
    """'1T' = 10^12, '1TiB' = 2^40 — same semantics as the reference's
    bytesize crate (decimal for plain suffix, binary for the 'i' forms)."""
    if v is None:
        return None
    if isinstance(v, int):
        return v
    m = _CAP_RE.match(str(v))
    if not m:
        raise ValueError(f"bad capacity {v!r}")
    mult = (_CAP_BIN if m.group(3) else _CAP_DEC)[m.group(2).lower()]
    return int(float(m.group(1)) * mult)
