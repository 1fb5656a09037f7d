"""The port's static-analysis plane (garage_tpu_torch/analysis) against
the reference's (garage_tpu/analysis).

  1. The eight generic rule families, run as the reference package
     (`package="garage_tpu"`), report exactly the reference's violations
     (rule, path, line, symbol, detail, message) on garage_tpu/, on a
     copy of garage_tpu/ with every pragma taken out (where they have
     findings to agree on), and on tests/fixtures/lint/.
  2. Each torch/CUDA-flavoured family fires on a source written to
     `tmp_path` and stays silent on its fixed twin.
  3. garage_tpu_torch/ is clean against its committed baseline, which
     holds no stale entry, and the CLI says so.
  4. The port's wire surface is the reference's snapshot,
     script/wire_schema.json.
  5. Pragmas are comments with a known kind and a reason.

Each tree is analyzed once per module (fixtures)."""

import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from garage_tpu.analysis import analyze as j_analyze
from garage_tpu_torch.analysis import analyze
from garage_tpu_torch.analysis.core import Project, diff_baseline, load_baseline
from garage_tpu_torch.analysis.wire_compat import SCHEMA_PATH, build_schema
from torch_mirror import time_limit

ROOT = Path(__file__).resolve().parents[1]
FIXTURES = "tests/fixtures/lint"
BASELINE = ROOT / "garage_tpu_torch" / "analysis" / "lint_baseline.json"
GENERIC = ["loop-blocker", "orphan-task", "swallowed-exception", "resource-discipline",
           "cancel-safety", "lock-await", "trust-boundary", "wire-compat"]
PRAGMA = re.compile(r"#\s*graft-lint:\s*allow-[a-z-]+\([^)]*\)")

_limit = time_limit(150)


def fields(vs):
    return [(v.rule, v.path, v.line, v.symbol, v.detail, v.message) for v in vs]


@pytest.fixture(scope="module")
def stripped_root(tmp_path_factory):
    """A copy of garage_tpu/ with every pragma comment removed (and the
    wire snapshot beside it)."""
    root = tmp_path_factory.mktemp("stripped")
    for src in (ROOT / "garage_tpu").rglob("*.py"):
        dst = root / src.relative_to(ROOT)
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(PRAGMA.sub("#", src.read_text()))
    (root / "script").mkdir()
    shutil.copy(ROOT / SCHEMA_PATH, root / SCHEMA_PATH)
    return root


TREES = {
    "garage_tpu": lambda stripped: (str(ROOT), ["garage_tpu"]),
    "garage_tpu_without_pragmas": lambda stripped: (str(stripped), ["garage_tpu"]),
    "fixtures": lambda stripped: (str(ROOT), [FIXTURES, "garage_tpu/utils/config.py"]),
}


@pytest.mark.parametrize("tree", sorted(TREES))
def test_generic_families_match_the_reference(tree, stripped_root):
    root, paths = TREES[tree](stripped_root)
    want = j_analyze(root, paths, GENERIC)
    got = analyze(root, paths, GENERIC, package="garage_tpu")
    assert fields(got) == fields(want)
    if tree != "garage_tpu":  # the reference's own tree is clean: the others are not
        assert len({v.rule for v in want}) >= 5, sorted({v.rule for v in want})


# --- 2. the torch/CUDA-flavoured families on fixtures --------------------------

WRAPPER = '''
    import torch
    from . import _build

    def gf_launch(bitmat, x):
        out = torch.empty_like(x)
        _build.count_launch(gf_launch)
        return out
'''

CASES = {
    "host_sync_item_in_coroutine": (
        "host-sync", "item", {"api/h.py": '''
            import torch

            async def total(x, dev):
                t = x.to(dev)
                return t.sum().item()
        '''}, {"api/h.py": '''
            import asyncio

            import torch

            def _total(x, dev):
                t = x.to(dev)
                return t.sum().item()

            async def total(x, dev):
                return await asyncio.to_thread(_total, x, dev)
        '''}),
    "host_sync_synchronize_via_helper": (
        "host-sync", "synchronize|_wait", {"api/s.py": '''
            import torch

            def _wait():
                torch.cuda.synchronize()

            async def handler():
                _wait()
        '''}, {"api/s.py": '''
            import asyncio

            import torch

            def _wait():
                torch.cuda.synchronize()

            async def handler():
                await asyncio.to_thread(_wait)
        '''}),
    "host_sync_wrapper_result_to_cpu": (
        "host-sync", "to-cpu", {"ops/_build.py": "def count_launch(w):\n    pass\n",
                                "ops/k.py": WRAPPER, "api/w.py": '''
            from ..ops.k import gf_launch

            async def handler(bm, x):
                return gf_launch(bm, x).to("cpu")
        '''}, {"ops/_build.py": "def count_launch(w):\n    pass\n",
               "ops/k.py": WRAPPER, "api/w.py": '''
            import asyncio

            from ..ops.k import gf_launch

            def _run(bm, x):
                return gf_launch(bm, x).to("cpu")

            async def handler(bm, x):
                return await asyncio.to_thread(_run, bm, x)
        '''}),
    "recompile_unbucketed_launch": (
        "recompile-hazard", "unbucketed-dispatch:gf_launch",
        {"ops/_build.py": "def count_launch(w):\n    pass\n", "ops/k.py": WRAPPER, "ops/c.py": '''
            import torch

            from .k import gf_launch

            def encode(bm, data, dev):
                return gf_launch(bm, torch.from_numpy(data).to(dev))
        '''}, {"ops/_build.py": "def count_launch(w):\n    pass\n", "ops/k.py": WRAPPER,
               "ops/c.py": '''
            import torch

            from .bucketing import bucket_batch, pad_to_bucket
            from .k import gf_launch

            def encode(bm, data, dev):
                x = pad_to_bucket(torch.from_numpy(data).to(dev), bucket_batch(len(data)))
                return gf_launch(bm, x)
        '''}),
    "recompile_branch_in_captured_def": (
        "recompile-hazard", "captured-branch:x", {"tools/g.py": '''
            import torch

            def step(x):
                if x.any():
                    x.mul_(2)

            def capture(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    step(x)
                return g
        '''}, {"tools/g.py": '''
            import torch

            def step(x):
                if x.shape[0] > 0:
                    x.copy_(torch.where(x.any(), x * 2, x))

            def capture(x):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g):
                    step(x)
                return g
        '''}),
    "recompile_branch_in_def_handed_to_a_capturer": (
        "recompile-hazard", "captured-branch:u", {"tools/g.py": '''
            import torch

            def graph_ms(fn, iters):
                g = torch.cuda.CUDAGraph()
                g.capture_begin()
                for _ in range(iters):
                    fn()
                g.capture_end()

            def bench(x, dev):
                t = x.to(dev)

                def body():
                    u = t.cuda()
                    while u.sum() > 0:
                        u = u - 1

                return graph_ms(body, 50)
        '''}, {"tools/g.py": '''
            import torch

            def graph_ms(fn, iters):
                g = torch.cuda.CUDAGraph()
                g.capture_begin()
                for _ in range(iters):
                    fn()
                g.capture_end()

            def bench(x, dev):
                t = x.to(dev)

                def body():
                    u = t.cuda()
                    u.sub_(torch.clamp(u, max=1))

                return graph_ms(body, 50)
        '''}),
    "donation_cross_stream_use": (
        "use-after-donation", "cross-stream-use:side:t", {"parallel/s.py": '''
            import torch

            def fan(x, dev):
                side = torch.cuda.Stream(device=dev)
                t = x.to(dev)
                with torch.cuda.stream(side):
                    y = t * 2
                return y
        '''}, {"parallel/s.py": '''
            import torch

            def fan(x, dev):
                side = torch.cuda.Stream(device=dev)
                t = x.to(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    y = t * 2
                t.record_stream(side)
                return y
        '''}),
    "backend_gate_cuda_compare_outside_telemetry": (
        "backend-gate", "platform-compare:cuda", {"block/b.py": '''
            def on_card(x):
                return x.device.type == "cuda"
        '''}, {"block/b.py": '''
            from ..ops import telemetry

            def on_card(x):
                return not telemetry.is_host_platform(telemetry.resolved_platform(x))
        ''', "ops/telemetry.py": '''
            def resolved_platform(x):
                return x.device.type

            def is_host_platform(platform):
                return platform in ("cpu", "unknown", "")
        '''}),
    "backend_gate_uncounted_ec_dispatch": (
        "backend-gate", "uncounted-codec-path:encode_batch", {"block/codec/ec.py": '''
            class EcCodec:
                def encode_batch(self, data):
                    return self._ec.encode(data)
        '''}, {"block/codec/ec.py": '''
            def _count(op, path, blocks, nbytes):
                pass

            class EcCodec:
                def encode_batch(self, data):
                    _count("encode", "cuda", len(data), data.nbytes)
                    return self._ec.encode(data)
        '''}),
}


def write_pkg(root: Path, files: dict) -> None:
    for rel, src in files.items():
        p = root / "pkg" / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        for d in [p.parent, *p.parent.parents]:
            if d == root:
                break
            (d / "__init__.py").touch()
        p.write_text(textwrap.dedent(src))


@pytest.mark.parametrize("case", sorted(CASES))
def test_torch_family_fires_on_its_fixture_and_not_on_the_fix(tmp_path, case):
    rule, detail, bad, good = CASES[case]
    write_pkg(tmp_path / "bad", bad)
    write_pkg(tmp_path / "good", good)
    fired = analyze(str(tmp_path / "bad"), ["pkg"], [rule], package="pkg")
    assert [v.detail for v in fired] == [detail], fields(fired)
    assert analyze(str(tmp_path / "good"), ["pkg"], [rule], package="pkg") == []


def test_mesh_streams_are_the_negative_case():
    """parallel/mesh.py runs each entry under its own stream, ordered by
    wait_stream and kept alive by record_stream: silent."""
    src = (ROOT / "garage_tpu_torch/parallel/mesh.py").read_text()
    assert "torch.cuda.stream(" in src and "record_stream" in src and "wait_stream" in src
    assert analyze(str(ROOT), ["garage_tpu_torch/parallel/mesh.py"], ["use-after-donation"]) == []


# --- 3. the port's gate --------------------------------------------------------


@pytest.fixture(scope="module")
def port_violations():
    return analyze(str(ROOT))


def test_port_is_clean_against_its_baseline(port_violations):
    new, stale = diff_baseline(port_violations, load_baseline(str(BASELINE)))
    assert not new, "\n".join(v.render() for v in new)
    assert not stale, stale


def test_port_baseline_is_empty():
    """Every finding on the port was triaged: restored pragma, repair or
    reasoned pragma; nothing is carried as debt."""
    assert load_baseline(str(BASELINE)) == {}


def test_cli_exit_codes(tmp_path):
    cmd = [sys.executable, "-m", "garage_tpu_torch.analysis"]
    r = subprocess.run(cmd + ["--rules", "loop-blocker,orphan-task", "--strict"],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 0 and "clean" in r.stdout, r.stdout + r.stderr
    r = subprocess.run(cmd + [FIXTURES, "--json"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 1
    rules = {v["rule"] for v in json.loads(r.stdout)["new"]}
    assert {"loop-blocker", "orphan-task", "swallowed-exception"} <= rules
    r = subprocess.run(cmd + ["--rules", "no-such-rule"], capture_output=True, text=True,
                       cwd=ROOT, timeout=120)
    assert r.returncode == 2


# --- 4. the wire ---------------------------------------------------------------


def test_port_wire_is_the_reference_snapshot():
    p = Project(str(ROOT))
    p.add_tree("garage_tpu_torch")
    got = build_schema(p)
    want = json.loads((ROOT / SCHEMA_PATH).read_text())
    for key in ("digest_version", "digest_keys", "frame_meta_keys", "migratable_markers"):
        assert got[key] == want[key], key
    assert got["digest_keys"] and got["migratable_markers"]


def test_wire_drift_in_the_port_is_a_port_fault(tmp_path):
    """A digest key the port drops is reported at the port's own module."""
    digest = (ROOT / "garage_tpu_torch/rpc/telemetry_digest.py").read_text()
    key = next(k for k in json.loads((ROOT / SCHEMA_PATH).read_text())["digest_keys"]
               if "." not in k and f'"{k}":' in digest)
    top = key
    dst = tmp_path / "garage_tpu_torch/rpc/telemetry_digest.py"
    dst.parent.mkdir(parents=True)
    dst.write_text(digest.replace(f'"{top}":', f'"{top}_renamed":', 1))
    (tmp_path / "script").mkdir()
    shutil.copy(ROOT / SCHEMA_PATH, tmp_path / SCHEMA_PATH)
    vs = analyze(str(tmp_path), ["garage_tpu_torch"], ["wire-compat"])
    assert vs and all(v.path == "garage_tpu_torch/rpc/telemetry_digest.py" for v in vs)
    assert f"digest-key-removed:{key}" in {v.detail for v in vs}


# --- 5. pragmas ----------------------------------------------------------------


def test_port_pragmas_are_well_formed(port_violations):
    assert not [v for v in port_violations if v.rule == "pragma"]
    count = sum(len(PRAGMA.findall(p.read_text()))
                for p in (ROOT / "garage_tpu_torch").rglob("*.py")
                if "analysis" not in p.parts)
    assert count >= 40


def test_bad_pragmas_are_violations(tmp_path):
    (tmp_path / "p.py").write_text(
        "import time\n"
        "async def f():\n"
        "    # graft-lint: allow-blocking()\n"
        "    time.sleep(1)\n"
        "def g(x):\n"
        "    pass  # graft-lint: allow-everything(nope)\n"
    )
    kinds = {v.detail for v in analyze(str(tmp_path), ["p.py"]) if v.rule == "pragma"}
    assert {"empty-reason:blocking", "unknown:everything"} <= kinds


def test_pragma_in_a_string_does_not_suppress(tmp_path):
    (tmp_path / "q.py").write_text(
        "import torch\n"
        "async def f(x, dev):\n"
        '    s = "# graft-lint: allow-host-sync(quoted, not a pragma)"\n'
        "    return x.to(dev).item(), s\n"
    )
    assert [v.rule for v in analyze(str(tmp_path), ["q.py"])] == ["host-sync"]
