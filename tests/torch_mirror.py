"""`port_mirror`: a reference test file run on the port.

The file's text, with every `garage_tpu` module name pointed at
`garage_tpu_torch`, is loaded as a module of its own, and its nodes'
configs ask for the CPU (`[tpu] enable = false`).  The reference test
modules it takes helpers from are mirrored the same way.  Test files
re-export a mirror's tests under `test_<prefix>_*` with `mirrored_tests`.
"""

import faulthandler
import importlib
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
CPU = {"enable": False}  # the port's nodes run the kernels' plain versions


def on_cpu(make_config):
    """`config_from_dict` that asks for the CPU unless `[tpu]` is given."""

    def wrapped(d, *a, **kw):
        return make_config({"tpu": CPU, **d}, *a, **kw)

    return wrapped


_loading: set[str] = set()


def port_mirror(ref_file: str, leave_out: tuple[str, ...] = ()) -> types.ModuleType:
    """The reference test file `ref_file` with every `garage_tpu` module
    name pointed at `garage_tpu_torch`, loaded as a module of its own;
    its nodes' configs ask for the CPU.  The reference test modules it
    imports its helpers from are mirrored the same way.  `leave_out`
    names tests that need modules the port does not have yet."""
    name = "port_mirror_" + ref_file.removesuffix(".py")
    if name in sys.modules or name in _loading:
        return sys.modules.get(name)  # a helper that imports its importer lazily
    _loading.add(name)
    src = (TESTS / ref_file).read_text()
    src = src.replace("garage_tpu.", "garage_tpu_torch.").replace(
        "from garage_tpu import", "from garage_tpu_torch import")
    for helper in sorted(set(re.findall(r"^\s*from (test_\w+) import", src, flags=re.M))):
        port_mirror(helper + ".py")
        src = re.sub(rf"^(\s*)from {helper} import", rf"\1from port_mirror_{helper} import",
                     src, flags=re.M)
    mod = types.ModuleType(name)
    mod.__file__ = str(TESTS / ref_file)
    mod.mirror_source = src
    sys.modules[name] = mod
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    if "config_from_dict" in mod.__dict__:
        mod.config_from_dict = on_cpu(mod.config_from_dict)
    for t in leave_out:
        delattr(mod, t)
    return mod


def mirrored_tests(mod: types.ModuleType, prefix: str) -> dict:
    """The tests of a mirror, renamed `test_<prefix>_<name>`."""
    return {f"test_{prefix}_{k.removeprefix('test_')}": v
            for k, v in vars(mod).items() if k.startswith("test_") and callable(v)}


def assert_mirror_whole(ref_file: str, mirror: types.ModuleType, left_out: tuple[str, ...],
                        count: int) -> None:
    """`mirror` carries every one of the `count` tests of `ref_file` but
    the ones `left_out` names, and its text names no module of the
    reference package and no reference test module."""
    src = (TESTS / ref_file).read_text()
    want = {line.split("(")[0][4:] for line in src.splitlines() if line.startswith("def test_")}
    assert len(want) == count, f"{ref_file}: {len(want)} tests, not {count}"
    assert set(left_out) <= want, f"{ref_file}: {set(left_out) - want} left out, not there"
    assert {k for k in vars(mirror) if k.startswith("test_")} == want - set(left_out), ref_file
    assert not re.search(r"\bgarage_tpu\b(?!_torch)", mirror.mirror_source), ref_file
    assert not re.search(r"^\s*from test_", mirror.mirror_source, flags=re.M), ref_file


def time_limit(seconds: float):
    """An autouse fixture for a test module: a test still running after
    `seconds` dumps every thread's stack and ends its process, so no test
    can hold the suite past its clock."""

    @pytest.fixture(autouse=True)
    def _time_limit():
        faulthandler.dump_traceback_later(seconds, exit=True)
        yield
        faulthandler.cancel_dump_traceback_later()

    return _time_limit


# --- twins: a reference node and a port node with the same node key ---------


def twin_config(root: Path, name: str, **extra) -> dict:
    """One single-node cluster's config (memory db, 4 KiB blocks, S3 on a
    free port, the CPU for the port's codec)."""
    return {"metadata_dir": str(root / name / "meta"), "data_dir": str(root / name / "data"),
            "db_engine": "memory", "replication_factor": 1, "rpc_bind_addr": "127.0.0.1:0",
            "rpc_secret": "aa" * 32, "block_size": 4096,
            "s3_api": {"api_bind_addr": "127.0.0.1:0", "s3_region": "garage"},
            "tpu": CPU, **extra}


async def twin_node(pkg: str, root: Path, node_key: bytes, **extra):
    """A started single-node `Garage` of package `pkg` ("garage_tpu" or
    "garage_tpu_torch") whose node key is `node_key`, with its layout
    applied and its workers running, and its AdminRpc handler."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")  # noqa: E731
    meta = root / pkg / "meta"
    meta.mkdir(parents=True, exist_ok=True)
    (meta / "node_key").write_bytes(node_key)
    garage = mod("model.garage").Garage(
        mod("utils.config").config_from_dict(twin_config(root, pkg, **extra)))
    await garage.start()
    garage.layout_manager.stage_role(
        garage.node_id, mod("rpc.layout.types").NodeRole(zone="dc1", capacity=10**12))
    garage.layout_manager.apply_staged()
    garage.spawn_workers()
    return garage, mod("cli.admin_rpc").AdminRpcHandler(garage)


def masked(doc, subst: dict[str, str], keys: frozenset = frozenset()):
    """`doc` with each string in `subst` replaced by its placeholder and
    the values under `keys` (times, uptimes) replaced by "<masked>"."""
    if isinstance(doc, dict):
        return {masked(k, subst): "<masked>" if k in keys else masked(v, subst, keys)
                for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [masked(v, subst, keys) for v in doc]
    if isinstance(doc, str):
        for s, p in subst.items():
            doc = doc.replace(s, p)
    return doc


def differences(a, b, path="") -> list[str]:
    """The paths at which two JSON-like documents differ."""
    if type(a) is not type(b):
        return [f"{path}: {a!r} != {b!r}"]
    if isinstance(a, dict):
        out = [f"{path}/{k}: only in one" for k in sorted(set(a) ^ set(b), key=str)]
        for k in sorted(set(a) & set(b), key=str):
            out += differences(a[k], b[k], f"{path}/{k}")
        return out
    if isinstance(a, list):
        if len(a) != len(b):
            return [f"{path}: {len(a)} items != {len(b)}"]
        return [d for i, (x, y) in enumerate(zip(a, b)) for d in differences(x, y, f"{path}[{i}]")]
    return [] if a == b else [f"{path}: {a!r} != {b!r}"]
