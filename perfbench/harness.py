"""One run of one cell: set-up, warm-up, the measured window, the trace,
the metrics and the check.

Everything a cell needs is found by name: its configuration in the file
`BENCHMARK.json` gives it, its traffic mix in `traffic/<name>.json`
(parameters only; its `kind` names `kinds/<kind>.py`, whose `drive`
runs that kind of traffic and whose `compare` judges what it kept),
each metric in `metrics/<name>.py`, and each kernel's work count in
`roofline/<kernel>.py`.  The program under test is the port's
codec plane (`garage_tpu_torch`): its batcher, codec, device API and
kernels, and its piece wrapping.  The benchmark times the calls it makes
into those layers with spans of its own (`Spans`).
"""

from __future__ import annotations

import asyncio
import gc
import hashlib
import importlib.util
import json
import random
import re
import sys
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path
from types import SimpleNamespace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "garage_tpu")
KIND = re.compile(r"^[a-z_][a-z0-9_]{0,63}$")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is the JAX stack or the JAX
    package, compared whole (`garage_tpu_torch` is the port)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(BENCHMARK.json, the cell's entry, its configuration, its traffic)."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}: {sorted(cells)}")
    cell = cells[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    cfg = load_json(root / cfgs[cell["config"]]["file"])
    traffic = load_json(BENCH_DIR / "traffic" / f"{cell['traffic']}.json")
    return bench, cell, cfg, traffic


def metrics_of(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics this cell reports: end-to-end ones without the trace,
    per-layer ones with it; a metric with a `workloads` list only in
    those cells."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """`metrics/<name>.py`'s `read(run)`."""
    return _load(BENCH_DIR / "metrics" / f"{name}.py", f"perfbench_metric_{name}").read


def kind_of(traffic: dict):
    """`kinds/<kind>.py` for the traffic's `kind`: its `drive` and its
    `compare`.  A kind with no such file fails the run."""
    kind = str(traffic.get("kind"))
    path = BENCH_DIR / "kinds" / f"{kind}.py"
    if not KIND.match(kind) or not path.is_file():
        raise SystemExit(f"traffic kind {kind!r} has no file kinds/{kind}.py")
    return _load(path, f"perfbench_kind_{kind}")


# --- the benchmark's own spans --------------------------------------------------


class Spans:
    """Host-clock spans around the calls the benchmark makes into each
    layer, summed while the window is open: seconds and blocks by name, and with `keep` every interval (for the trace's idle gaps).
    Calls come from the event loop and the dispatch threads, so the sums
    are taken under a lock."""

    def __init__(self):
        self.open = False
        self.keep = False
        self.sums: dict[str, list] = defaultdict(lambda: [0.0, 0])
        self.intervals: list[tuple[str, float, float]] = []
        self.work: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str, blocks: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            t1 = time.perf_counter()
            if self.open:
                with self._lock:
                    s = self.sums[name]
                    s[0] += t1 - t0
                    s[1] += blocks
                    if self.keep:
                        self.intervals.append((name, t0, t1))

    def add_work(self, **amounts: float) -> None:
        if self.open:
            with self._lock:
                for k, v in amounts.items():
                    self.work[k] += v

    def secs(self, name: str) -> float:
        return self.sums[name][0] if name in self.sums else 0.0

    def blocks(self, name: str) -> int:
        return self.sums[name][1] if name in self.sums else 0


class TimedCodec:
    """The port's codec with a span around each batched call, and the
    work each call asks of the kernels counted by the benchmark's own
    roofline functions (`roofline/`)."""

    def __init__(self, codec, spans: Spans, roofline):
        self._codec = codec
        self._spans = spans
        self._roof = roofline
        self.k, self.m = codec.k, codec.m

    def encode_batch_hashed(self, blocks, impl="auto"):
        n = self.k + self.m
        self._spans.add_work(
            k1_bytes=sum(self._roof["k1"].bytes_moved(self.k, self.m, self._codec.piece_len(len(b)))
                         for b in blocks),
            k2_ops=sum(n * self._roof["k2"].int_ops(self._codec.piece_len(len(b))) for b in blocks),
        )
        with self._spans.span("codec.encode_batch_hashed", len(blocks)):
            return self._codec.encode_batch_hashed(blocks, impl)

    def decode_batch(self, items, impl="auto"):
        k = self.k
        moved = 0
        for pieces, blen in items:
            missing = sum(1 for i in range(k) if i not in pieces)
            if missing:
                moved += self._roof["k1"].bytes_moved(k, missing, self._codec.piece_len(blen))
        self._spans.add_work(k1_bytes=moved)
        with self._spans.span("codec.decode_batch", len(items)):
            return self._codec.decode_batch(items, impl)

    def reconstruct_batch(self, batches, impl="auto"):
        self._spans.add_work(k1_bytes=sum(
            self._roof["k1"].bytes_moved(self.k, len(w), self._codec.piece_len(blen))
            for _p, w, blen in batches))
        with self._spans.span("codec.reconstruct_batch", len(batches)):
            return self._codec.reconstruct_batch(batches, impl)

    def piece_len(self, block_len: int) -> int:
        return self._codec.piece_len(block_len)


def load_roofline() -> dict:
    """Every kernel's work count (`roofline/<kernel>.py`) by its name,
    and the card's peaks."""
    out = {path.stem: _load(path, f"perfbench_roofline_{path.stem}")
           for path in sorted((BENCH_DIR / "roofline").glob("*.py"))}
    out["peaks"] = load_json(BENCH_DIR / "roofline" / "peaks.json")
    return out


# --- the registry, read around the window ----------------------------------------


def registry_snapshot(registry) -> tuple[dict, dict]:
    """Counters and (count, sum) of every histogram.  The dispatch
    threads may add a key while this copies, so a copy that races one is
    taken again."""
    for _ in range(100):
        try:
            counters = dict(registry.counters)
            durations = {k: (v[0], v[1]) for k, v in list(registry.durations.items())}
            return counters, durations
        except RuntimeError:
            continue
    raise RuntimeError("registry kept changing while it was read")


class RegistryDiff:
    """What the program's registry counted while the window was open."""

    def __init__(self, before: tuple[dict, dict], after: tuple[dict, dict]):
        self.counters = {k: v - before[0].get(k, 0.0) for k, v in after[0].items()}
        self.durations = {}
        for k, (n, s) in after[1].items():
            n0, s0 = before[1].get(k, (0, 0.0))
            self.durations[k] = (n - n0, s - s0)

    @staticmethod
    def _match(labels: tuple, want: dict) -> bool:
        d = dict(labels)
        return all(d.get(k) == v for k, v in want.items())

    def counter(self, name: str, **labels) -> float:
        return sum(v for (n, lb), v in self.counters.items()
                   if n == name and self._match(lb, labels))

    def histogram(self, name: str, **labels) -> tuple[int, float]:
        """(observations, their sum) over the label sets that match."""
        cnt, tot = 0, 0.0
        for (n, lb), (c, s) in self.durations.items():
            if n == name and self._match(lb, labels):
                cnt += c
                tot += s
        return cnt, tot


# --- inputs from the seed ----------------------------------------------------------


def make_pool(cfg: dict, traffic: dict, seed: int, device) -> list[bytes]:
    """Distinct blocks of the configuration's size, `pool_bytes` in all,
    made from the seed on the device in one call and handed to the host
    as the block manager hands blocks to the codec: as bytes.  The
    card's copy is freed: the traffic never reads it there."""
    import torch

    bs = cfg["block_size"]
    n = max(1, traffic["pool_bytes"] // bs)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    data = torch.randint(0, 256, (n, bs), dtype=torch.uint8, device=device,
                         generator=gen).cpu().numpy()
    pool = [data[i].tobytes() for i in range(n)]
    del data
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return pool


def check_set(n_pool: int, block_size: int, traffic: dict, rng: random.Random) -> set[int]:
    """`check_bytes` of pool entries, drawn from the seed, whose
    completions are compared with the reference."""
    want = max(1, min(n_pool, traffic["check_bytes"] // block_size))
    return set(rng.sample(range(n_pool), want))


def entry(value: int, limit: int, rule: str) -> dict:
    """A number compared, its limit, and whether it holds."""
    ok = value <= limit if rule == "<=" else value >= limit
    return {"value": value, "limit": f"{rule} {limit}", "ok": ok}


def per_second(done: list[tuple[float, int]], t0: float, t1: float) -> str:
    """MiB done in each whole second of the window, for the notes."""
    bins = [0] * max(1, int(t1 - t0))
    for t, n in done:
        i = int(t - t0)
        if 0 <= i < len(bins):
            bins[i] += n
    return " ".join(f"{b / (1 << 20):.0f}" for b in bins)


# --- the run ---------------------------------------------------------------------


def _stamped(log, t_start: float):
    return lambda line: log(f"[{time.perf_counter() - t_start:9.3f} s] {line}")


def run_cell(cell: dict, cfg: dict, traffic: dict, bench: dict, seed: int,
             seconds: float, trace: bool, device: str = "cuda", impl: str = "auto",
             t_start: float | None = None, codec_factory=None, log=print) -> dict:
    """Run one cell once and return the result object the command prints.

    `codec_factory(k, m, device)` replaces the port's codec (the control
    and the fault tests put the reference or a broken codec there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = _stamped(log, t_start)
    import torch

    from . import profiling as tracing

    kind = kind_of(traffic)
    torch.set_num_threads(4)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    log(f"torch {torch.__version__} and the {dev.type} device ready")
    chips = int(cell.get("chips", 1))

    from garage_tpu_torch.block.codec.ec import EcCodec
    from garage_tpu_torch.utils.metrics import registry

    k, m = cfg["k"], cfg["m"]
    if codec_factory is None:
        codec = EcCodec(k, m, device=device, n_devices=1)
    else:
        codec = codec_factory(k, m, device)
    rng = random.Random(seed)
    pool = make_pool(cfg, traffic, seed, dev)
    log(f"pool: {len(pool)} blocks of {cfg['block_size']} B, made by "
        f"{time.perf_counter() - t_start:.3f} s")
    spans = Spans()
    roof = load_roofline()
    timed = TimedCodec(codec, spans, roof)

    executor = ThreadPoolExecutor(max_workers=4, thread_name_prefix="perfbench")
    loop = asyncio.new_event_loop()
    loop.set_default_executor(executor)
    window: dict = {}

    # the profiler starts before the warm-up (its start takes seconds and
    # would stall the loop at the window's edge); its events are clipped
    # to the window
    profiler = tracing.start() if trace else None
    spans.keep = trace
    log("traffic starts")

    async def open_window():
        if dev.type == "cuda":
            # the peak of the window's own work, not of the set-up's
            torch.cuda.reset_peak_memory_stats(dev)
        window["before"] = registry_snapshot(registry)
        window["t0"] = time.perf_counter()
        window["setup_s"] = window["t0"] - t_start
        log(f"window opens at {window['setup_s']:.3f} s")
        spans.open = True
        return window["t0"]

    async def close_window():
        spans.open = False
        window["t1"] = time.perf_counter()
        window["after"] = registry_snapshot(registry)
        return window["t1"]

    try:
        out = loop.run_until_complete(kind.drive(
            codec=timed, cfg=cfg, traffic=traffic, pool=pool, rng=rng, seconds=seconds,
            impl=impl, spans=spans,
            open_window=open_window, close_window=close_window, log=log))
    finally:
        loop.run_until_complete(loop.shutdown_default_executor())
        loop.close()
        executor.shutdown(wait=True)
    if trace:
        window["trace"] = tracing.stop(profiler, window["t0"], window["t1"], spans.intervals)

    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips,
                   "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))
                   if dev.type == "cuda" else 0}
    tr = window.get("trace")
    if tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
    run = SimpleNamespace(kind=traffic["kind"], cfg=cfg, traffic=traffic, seed=seed,
                          setup_s=window["setup_s"], window_s=window["t1"] - window["t0"],
                          reg=RegistryDiff(window["before"], window["after"]), spans=spans,
                          trace=tr, roofline=roof, **out["measured"])
    for line in out["notes"]:
        log(line)
    log(f"device dispatches in the window: {run.reg.counter('tpu_codec_dispatch_total'):.0f}")
    if tr is not None:
        log(f"trace: device busy {tr['busy_s']:.6f} s of {tr['window_s']:.6f} s, "
            f"kernels alone {tr['kernel_s']:.6f} s "
            f"({100 * tr['kernel_s'] / tr['window_s']:.4f}% of the window), "
            f"copies {tr['copy_s']:.6f} s, device events {tr['events']}")

    metrics = {}
    for mdef in metrics_of(bench, cell["name"], trace):
        value = reader(mdef["name"])(run)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}

    # the program's state goes before the reference runs
    del timed, codec
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    compared = kind.compare(cfg, pool, out["kept"], log=log)
    compared["failed"] = {"value": out["failed"], "limit": "<= 0", "ok": out["failed"] == 0}
    correct = all(c["ok"] for c in compared.values())
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if tr is not None:
        result["breakdown"] = tr["breakdown"]
    result["compared"] = {name: {"value": c["value"], "limit": c["limit"]}
                          for name, c in compared.items()}
    for name, c in compared.items():
        log(f"compared {name}: {c['value']} limit {c['limit']}")
    return result


def content_hashes(pool: list[bytes]) -> list[bytes]:
    """The blocks' content hashes (BLAKE2b-512 cut to 32 bytes, the
    system's block identity), made with the standard library."""
    with ThreadPoolExecutor(max_workers=4) as ex:
        return list(ex.map(lambda b: hashlib.blake2b(b).digest()[:32], pool))


def seeded_ranks(n: int, n_pieces: int, rng: random.Random) -> list[int]:
    """Lost ranks of n blocks: every rank as often as the others (to one
    block), in an order drawn from the seed, so every seed asks for the
    same work."""
    ranks = [i % n_pieces for i in range(n)]
    rng.shuffle(ranks)
    return ranks
