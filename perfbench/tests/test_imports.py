"""The benchmark loads neither the JAX stack nor the JAX package, and its
reference loads nothing of the program.  Module names are compared by
their top-level name, whole: the port `garage_tpu_torch` begins with the
JAX package's name."""

from __future__ import annotations

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "garage_tpu"}


def _fresh(code: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_every_file_of_the_benchmark_imports_clean():
    loaded = _fresh("""
        import importlib, importlib.util, json, pathlib, sys
        bench = pathlib.Path("perfbench")
        for mod in ("perfbench.run", "perfbench.harness", "perfbench.profiling",
                    "perfbench.control", "perfbench.reference.codec"):
            importlib.import_module(mod)
        for sub in ("kinds", "metrics", "roofline"):
            for path in sorted((bench / sub).glob("*.py")):
                spec = importlib.util.spec_from_file_location("m_" + path.stem, path)
                spec.loader.exec_module(importlib.util.module_from_spec(spec))
        for sub in ("configs", "traffic"):
            for path in sorted((bench / sub).glob("*.json")):
                json.loads(path.read_text())
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not FORBIDDEN & set(loaded)
    assert "garage_tpu_torch" not in loaded  # nothing of the program at import


def test_the_reference_and_the_comparisons_import_nothing_of_the_program():
    """The reference, and each kind's module (its `compare`; its
    `drive` imports the program only when it runs)."""
    loaded = _fresh("""
        import json, pathlib, sys
        import perfbench.reference.codec
        from perfbench import harness
        for path in sorted(pathlib.Path("perfbench/kinds").glob("*.py")):
            harness.kind_of({"kind": path.stem})
        print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
    """)
    assert not (FORBIDDEN | {"garage_tpu_torch", "torch"}) & set(loaded)


@pytest.mark.parametrize("kind", ["ingest", "repair"])
def test_a_run_loads_nothing_forbidden(kind):
    """A whole run on the CPU at a tiny size, then the process's modules."""
    out = _fresh(f"""
        import json, sys
        from perfbench import harness
        from perfbench.tests.conftest import tiny_run
        result = tiny_run({kind!r})
        print(json.dumps({{"correct": result["correct"],
                          "forbidden": harness.forbidden_modules(),
                          "loaded": sorted({{m.split(".")[0] for m in sys.modules}})}}))
    """)
    assert out["correct"]
    assert out["forbidden"] == []
    assert not FORBIDDEN & set(out["loaded"])
    assert "garage_tpu_torch" in out["loaded"]


def test_forbidden_names_are_compared_whole():
    from perfbench import harness

    fake = {"garage_tpu_torch_like": sys, "garage_tpux": sys, "garage_tpu.sub": sys}
    saved = {n: sys.modules.get(n) for n in fake}
    try:
        sys.modules.update({n: sys for n in ("garage_tpu_torch_like", "garage_tpux")})
        assert "garage_tpu" not in harness.forbidden_modules()
        sys.modules["garage_tpu.sub"] = sys
        assert "garage_tpu" in harness.forbidden_modules()
    finally:
        for n, mod in saved.items():
            if mod is None:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod
