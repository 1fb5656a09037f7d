"""garage_tpu_torch stands alone: an AST scan shows that no file of the
package, and not chip_smoke.py, imports `jax` or any `garage_tpu`
module (module names matched exactly: `garage_tpu_torch` is not
`garage_tpu`); the card path holds no try/except that could fall back
to a plain version; and the entry points raise when CUDA is absent
unless the caller asks for the CPU."""

import ast
from pathlib import Path

import pytest
import torch

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "garage_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
# modules on the card path: a try/except there could hide a failed kernel
CARD_PATH = [
    "garage_tpu_torch/ops/_build.py", "garage_tpu_torch/ops/ec_cuda.py",
    "garage_tpu_torch/ops/hash_cuda.py", "garage_tpu_torch/block/codec/ec.py",
    "garage_tpu_torch/models/pipeline.py", "garage_tpu_torch/parallel/mesh.py",
    "garage_tpu_torch/graft_entry.py",
]
FORBIDDEN_TOP = ("jax", "jaxlib", "garage_tpu")


def forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN_TOP


def absolute_imports(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            names += [a.value for a in node.args if isinstance(a, ast.Constant)]
    return names


def test_scan_matches_module_names_exactly():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("garage_tpu.ops.gf")
    assert not forbidden("garage_tpu_torch.ops.gf")
    assert not forbidden("jaxtyping") and not forbidden("torch")
    assert len(PORT_FILES) > 15


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_no_jax_and_no_reference(rel):
    bad = [n for n in absolute_imports(ROOT / rel) if forbidden(n)]
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", CARD_PATH)
def test_card_path_has_no_fallback(rel):
    tree = ast.parse((ROOT / rel).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)], rel


def test_entry_points_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from garage_tpu_torch import graft_entry
    from garage_tpu_torch.block.codec import get_codec
    from garage_tpu_torch.block.codec.ec import EcCodec
    from garage_tpu_torch.models.pipeline import ScrubRepairPipeline
    from garage_tpu_torch.ops.ec_cuda import EcCuda
    from garage_tpu_torch.parallel.mesh import make_mesh

    for make in (lambda: EcCodec(8, 3), lambda: EcCuda(8, 3),
                 lambda: ScrubRepairPipeline(), lambda: get_codec((8, 3)),
                 lambda: EcCodec(8, 3, n_devices=4), lambda: make_mesh(devices=["cuda"] * 4),
                 lambda: graft_entry.entry(), lambda: graft_entry.dryrun_multichip(4)):
        with pytest.raises(RuntimeError):
            make()
    # the CPU is taken only when asked for
    assert EcCodec(8, 3, device="cpu").device.type == "cpu"
