"""garage_tpu_torch stands alone: an AST scan shows that no file of the
package, and not chip_smoke.py, imports `jax` or any `garage_tpu`
module (module names matched exactly: `garage_tpu_torch` is not
`garage_tpu`); every relative import resolves to a module of the port,
apart from the lazy imports of modules not ported yet (`DEFERRED`); the
card path holds no try/except that could fall back to a plain version,
and neither does the scrub's call of kernel K2, nor a node's choice of
its codec's device; the entry points, a node's `Garage` and the daemon
(`python -m garage_tpu_torch.cli server`) among them, raise when CUDA is
absent unless the caller asks for the CPU; and the CLI's client path
touches no CUDA."""

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
# lazy imports, inside functions that the ported paths do not reach, of
# modules a later part of the port brings: (importing file, module).
# Empty: every module of the reference has its counterpart
DEFERRED: set[tuple[str, str]] = set()


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


def _module_path(parts: list[str]) -> Path | None:
    q = ROOT.joinpath(*parts)
    for cand in (q.with_suffix(".py"), q / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _bound_names(path: Path) -> set[str]:
    """Names a module binds at its top level (defs, classes, imports,
    assignments)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names |= {(a.asname or a.name).split(".")[0] for a in node.names}
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names |= {t.id for t in targets if isinstance(t, ast.Name)}
    return names


def unresolved_relative_imports(rel: str) -> list[str]:
    """Relative imports of `rel` that name no module of the port (and no
    name bound by the package they import from)."""
    path = ROOT / rel
    pkg = list(Path(rel).parent.parts)
    bad = []
    for node in ast.walk(ast.parse(path.read_text())):
        if not (isinstance(node, ast.ImportFrom) and node.level > 0):
            continue
        base = pkg[: len(pkg) - (node.level - 1)]
        mod = base + (node.module.split(".") if node.module else [])
        found = _module_path(mod)
        if found is None:
            bad.append(".".join(mod))
            continue
        if found.name != "__init__.py":
            continue
        for a in node.names:
            if _module_path(mod + [a.name]) is None and a.name not in _bound_names(found):
                bad.append(".".join(mod + [a.name]))
    return bad


PORT_MODULES = [r for r in PORT_FILES if r.startswith("garage_tpu_torch/")]


def test_scan_matches_module_names_exactly():
    assert forbidden("jax") and forbidden("jax.numpy") and forbidden("garage_tpu.ops.gf")
    assert not forbidden("garage_tpu_torch.ops.gf")
    assert not forbidden("jaxtyping") and not forbidden("torch")
    assert len(PORT_FILES) > 15


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_imports_no_jax_and_no_reference(rel):
    bad = [n for n in absolute_imports(ROOT / rel) if forbidden(n)]
    assert not bad, f"{rel} imports {bad}"


@pytest.mark.parametrize("rel", PORT_MODULES)
def test_relative_imports_resolve_in_the_port(rel):
    bad = [m for m in unresolved_relative_imports(rel) if (rel, m) not in DEFERRED]
    assert not bad, f"{rel} imports {bad}, which the port does not have"


def test_deferred_imports_are_still_missing():
    """Each DEFERRED entry names a module that is really absent (and
    really imported): the set shrinks as later parts of the port land."""
    for rel, mod in DEFERRED:
        assert mod in unresolved_relative_imports(rel), (rel, mod)


def test_scrub_k2_call_is_not_inside_a_try():
    """The scrub hands K2 lengths to `blake3_batch` with no try around
    the call: a failed launch raises out of the scrub step."""
    tree = ast.parse((ROOT / "garage_tpu_torch/block/repair.py").read_text())
    uses = []

    def walk(node, in_try):
        if isinstance(node, ast.Name) and node.id in ("blake3_batch", "_device_hashes"):
            uses.append((node.id, node.lineno, in_try))
        for child in ast.iter_child_nodes(node):
            walk(child, in_try or isinstance(node, ast.Try))

    walk(tree, False)
    names = {n for n, _l, _t in uses}
    assert names == {"blake3_batch", "_device_hashes"}, uses
    assert not [u for u in uses if u[2]], uses


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


def test_garage_codec_choice_has_no_fallback():
    """`Garage.__init__` and `codec_device` pick the codec's device with no
    try/except around the choice or the codec's construction."""
    tree = ast.parse((ROOT / "garage_tpu_torch/model/garage.py").read_text())
    funcs = {n.name: n for n in ast.walk(tree)
             if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    for name in ("codec_device", "__init__"):
        assert not [n for n in ast.walk(funcs[name]) if isinstance(n, ast.Try)], name


def _garage_config(tmp_path, **tpu):
    from garage_tpu_torch.utils.config import config_from_dict

    d = {"metadata_dir": str(tmp_path / "meta"), "data_dir": str(tmp_path / "data"),
         "db_engine": "memory", "replication_mode": "ec:2:1", "rpc_secret": "aa" * 32,
         "rpc_bind_addr": "127.0.0.1:0"}
    if tpu:
        d["tpu"] = tpu
    return config_from_dict(d)


def test_garage_picks_the_card_unless_asked_for_the_cpu():
    from garage_tpu_torch.model.garage import codec_device
    from garage_tpu_torch.utils.config import TpuConfig

    assert codec_device(TpuConfig(enable=False)) == "cpu"
    assert codec_device(TpuConfig(platform="cpu")) == "cpu"
    for tpu in (TpuConfig(), TpuConfig(platform="cuda"), TpuConfig(platform="tpu")):
        if torch.cuda.is_available():
            assert codec_device(tpu) == "cuda"
        else:
            with pytest.raises(RuntimeError):
                codec_device(tpu)


def test_garage_with_the_default_config_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from garage_tpu_torch.model.garage import Garage

    with pytest.raises(RuntimeError):
        Garage(_garage_config(tmp_path / "default"))
    with pytest.raises(RuntimeError):
        Garage(_garage_config(tmp_path / "enabled", enable=True))
    # nothing was opened before the choice
    assert not (tmp_path / "default" / "meta").exists()
    g = Garage(_garage_config(tmp_path / "cpu", enable=False))
    try:
        assert g.block_manager.codec.device.type == "cpu"
    finally:
        g.db.close()


CLIENT_PATH = ["garage_tpu_torch/cli/main.py", "garage_tpu_torch/cli/__main__.py",
               "garage_tpu_torch/k2v_client/client.py", "garage_tpu_torch/k2v_client/__main__.py",
               "garage_tpu_torch/format_table.py"]


@pytest.mark.parametrize("rel", CLIENT_PATH)
def test_client_path_holds_no_cuda_call(rel):
    """A CLI call is a peer of the daemon, never a device user: the CLI's
    module and the K2V client name neither `torch` nor any `.cuda`."""
    tree = ast.parse((ROOT / rel).read_text())
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    attrs = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    assert "torch" not in names and "cuda" not in attrs, rel


def test_cli_client_call_touches_no_cuda(tmp_path, monkeypatch, capsys):
    """`node id`, a client call, runs with every CUDA entry raising."""
    from garage_tpu_torch.cli.main import main
    from garage_tpu_torch.net.handshake import gen_node_key, node_id_of

    (tmp_path / "meta").mkdir()
    key = gen_node_key()
    (tmp_path / "meta" / "node_key").write_bytes(key)
    cfg = tmp_path / "garage.toml"
    cfg.write_text(f'metadata_dir = "{tmp_path / "meta"}"\ndata_dir = "{tmp_path / "data"}"\n'
                   f'rpc_bind_addr = "127.0.0.1:3901"\nrpc_secret = "{"ab" * 32}"\n')

    def no_cuda(*a, **kw):
        raise AssertionError("the CLI's client path touched CUDA")

    for name in ("is_available", "device_count", "current_device", "_lazy_init", "init"):
        monkeypatch.setattr(torch.cuda, name, no_cuda)
    main(["-c", str(cfg), "node", "id"])
    assert capsys.readouterr().out.strip() == f"{node_id_of(key).hex()}@127.0.0.1:3901"


def test_cli_server_with_the_default_config_exits_naming_cuda(tmp_path):
    """`cli server` on a config with the default `[tpu]` exits non-zero
    when CUDA is absent, naming it, before it opens anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    import subprocess
    import sys

    cfg = tmp_path / "garage.toml"
    cfg.write_text(f'metadata_dir = "{tmp_path / "meta"}"\ndata_dir = "{tmp_path / "data"}"\n'
                   f'replication_mode = "ec:2:1"\nrpc_bind_addr = "127.0.0.1:3901"\n'
                   f'rpc_secret = "{"ab" * 32}"\n')
    r = subprocess.run([sys.executable, "-m", "garage_tpu_torch.cli", "-c", str(cfg), "server"],
                       capture_output=True, text=True, timeout=60, cwd=ROOT)
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "up" not in r.stdout
    assert not (tmp_path / "meta").exists()
