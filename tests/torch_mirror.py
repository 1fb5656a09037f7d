"""`port_mirror`: a reference test file run on the port.

The file's text, with every `garage_tpu` module name pointed at
`garage_tpu_torch` (and the modules the port renamed, `ops.ec_tpu` and
`ops.hash_tpu`, at `ops.ec_cuda` and `ops.hash_cuda`), is loaded as a
module of its own, and its nodes' configs ask for the CPU (`[tpu]
enable = false`), those given as dicts and the TOML files its
`write_config` writes for its daemons.  Its `EcCodec` is
`ReferenceEcCodec`, which takes the reference's constructor.  The
reference test modules it takes helpers from are mirrored the same way.
Test files re-export a mirror's tests under `test_<prefix>_*` with
`mirrored_tests`; the tests `RUN_APART` names run in
tests/test_torch_left_out_mirror.py instead, each under its own time
limit.
"""

import functools
import importlib
import os
import re
import sys
import types
from pathlib import Path

import pytest

from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.ops.ec_cuda import EcCuda
from time_limits import time_limit  # noqa: F401 -- re-exported to the port's test files

TESTS = Path(__file__).resolve().parent
CPU = {"enable": False}  # the port's nodes run the kernels' plain versions
CPU_TOML = "\n[tpu]\nenable = false\n"  # the same, as a daemon's TOML table
# tests of mirrored files that run in a file of their own, not beside the
# rest of theirs: a hang there ends only that file's worker
RUN_APART = {
    "test_admin_ops.py": ("test_block_ops",),
    "test_flight.py": ("test_debug_profile_endpoint_captures_hot_function",),
    "test_latency_xray.py": ("test_ec83_cluster_xray_acceptance",),
}

# module names of the reference whose port counterpart has another name
PORT_MODULES = {
    "garage_tpu_torch.ops.ec_tpu": "garage_tpu_torch.ops.ec_cuda",
    "garage_tpu_torch.ops.hash_tpu": "garage_tpu_torch.ops.hash_cuda",
}
# the codec import of a mirror, pointed at the bridge below
CODEC_IMPORT = re.compile(r"\bfrom garage_tpu_torch\.block\.codec\.ec import EcCodec\b(?!\s*,)")
BRIDGED_CODEC_IMPORT = "from torch_mirror import ReferenceEcCodec as EcCodec"

# --- the codec bridge: the reference's constructor on the port ---------------------

TPU_BATCH_MIN = 8  # the reference codec's smallest batch for its device path


def reference_cpu_devices() -> int:
    """How many devices the reference's CPU platform has: the virtual
    devices tests/conftest.py asks XLA for, else one."""
    found = re.search(r"--xla_force_host_platform_device_count=(\d+)",
                      os.environ.get("XLA_FLAGS", ""))
    return int(found.group(1)) if found else 1


class ReferenceCpuEcCuda(EcCuda):
    """`EcCuda` on the CPU whose automatic mesh width is the reference's
    on the CPU platform (`EcTpu._mesh_width`: one entry per device)."""

    def _mesh_width(self) -> int:
        if os.environ.get("GARAGE_EC_MESH", "1") == "0":
            return 1
        if self._n_dev is not None:
            return self._n_dev
        return reference_cpu_devices()


class ReferenceEcCodec(EcCodec):
    """The reference's `EcCodec(k, m, tpu_enable=True, platform=None)` on
    the port: a CPU codec routed the way the reference's routes on its
    CPU platform (garage_tpu/block/codec/ec.py).

      - `tpu_enable=False`: every call takes the native host codec, and
        `_tpu` is None;
      - `tpu_enable=True`: `_tpu` is the port's `EcCuda`; `encode_batch`
        and `reconstruct_batch` take its plain path (impl "xla") for a
        batch of at least `TPU_BATCH_MIN` blocks, the host codec below
        that; `encode_batch_hashed` and `decode_batch` keep their `impl`
        ("auto" is the host codec on the CPU, as the reference's
        `_prefer_xla` decides there), and `decode_batch` under "xla"
        takes the host codec below `TPU_BATCH_MIN` items, as the
        reference's does."""

    def __init__(self, k: int, m: int, tpu_enable: bool = True, platform=None):
        if platform not in (None, "cpu"):
            raise ValueError(f"the bridged codec runs on the CPU, not {platform!r}")
        super().__init__(k, m, device="cpu")
        self._ec = ReferenceCpuEcCuda(k, m, device="cpu")
        self._tpu = self._ec if tpu_enable else None

    def _batch_impl(self, n: int, impl: str) -> str:
        self._on_host(impl)  # an unknown impl still raises
        return "xla" if self._tpu is not None and n >= TPU_BATCH_MIN else "host"

    def encode_batch(self, blocks, impl="auto"):
        return super().encode_batch(blocks, self._batch_impl(len(blocks), impl))

    def reconstruct_batch(self, batches, impl="auto"):
        return super().reconstruct_batch(batches, self._batch_impl(len(batches), impl))

    def encode_batch_hashed(self, blocks, impl="auto"):
        return super().encode_batch_hashed(blocks, impl if self._tpu is not None else "host")

    def decode_batch(self, items, impl="auto"):
        if impl == "xla":
            impl = self._batch_impl(len(items), impl)
        return super().decode_batch(items, impl if self._tpu is not None else "host")


def on_cpu(make_config):
    """`config_from_dict` that asks for the CPU unless `[tpu]` is given."""

    def wrapped(d, *a, **kw):
        return make_config({"tpu": CPU, **d}, *a, **kw)

    return wrapped


def toml_on_cpu(write_config):
    """A mirror's `write_config`, whose TOML file gets `[tpu] enable =
    false` appended as its last table unless it has a `[tpu]` table of
    its own (appended last, the text stays valid TOML)."""

    @functools.wraps(write_config)
    def wrapped(*a, **kw):
        cfg = Path(write_config(*a, **kw))
        text = cfg.read_text()
        if not re.search(r"^\[tpu\]", text, flags=re.M):
            cfg.write_text(text + CPU_TOML)
        return cfg

    return wrapped


_loading: set[str] = set()


def port_mirror(ref_file: str, leave_out: tuple[str, ...] = (),
                drop: tuple[str, ...] = ()) -> types.ModuleType:
    """The reference test file `ref_file` with every `garage_tpu` module
    name pointed at `garage_tpu_torch`, loaded as a module of its own;
    its nodes' configs ask for the CPU and its `EcCodec` is the bridge.
    The reference test modules it imports its helpers from are mirrored
    the same way.  `leave_out` names tests that need modules the port
    does not have; `drop` names lines of the reference's text (imports
    only such tests use) that the mirror goes without."""
    name = "port_mirror_" + ref_file.removesuffix(".py")
    if name in sys.modules or name in _loading:
        return sys.modules.get(name)  # a helper that imports its importer lazily
    _loading.add(name)
    src = (TESTS / ref_file).read_text()
    lines = src.splitlines(keepends=True)
    for line in drop:
        assert line + "\n" in lines, f"{ref_file}: no line {line!r} to drop"
    src = "".join(x for x in lines if x.rstrip("\n") not in drop)
    src = src.replace("garage_tpu.", "garage_tpu_torch.").replace(
        "garage_tpu/", "garage_tpu_torch/").replace(
        "from garage_tpu import", "from garage_tpu_torch import")
    for ref_mod, port_mod in PORT_MODULES.items():
        src = re.sub(rf"\b{re.escape(ref_mod)}\b", port_mod, src)
    src = CODEC_IMPORT.sub(BRIDGED_CODEC_IMPORT, src)
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
    if "write_config" in mod.__dict__:
        mod.write_config = toml_on_cpu(mod.write_config)
    for t in leave_out:
        delattr(mod, t)
    return mod


def mirrored_tests(mod: types.ModuleType, prefix: str, apart: bool = False) -> dict:
    """The tests of a mirror, renamed `test_<prefix>_<name>`: those that
    `RUN_APART` names for its file when `apart`, the others when not."""
    names = RUN_APART.get(Path(mod.__file__).name, ())
    return {f"test_{prefix}_{k.removeprefix('test_')}": v
            for k, v in vars(mod).items()
            if k.startswith("test_") and callable(v) and (k in names) == apart}


def refusing_skips(tests: dict) -> dict:
    """`tests` with each skip turned into a failure that names its reason:
    a mirrored test that skips on the port, for a reason the reference
    does not skip for on the CPU, is not a run."""

    def refusing(test):
        @functools.wraps(test)
        def run(*args, **kwargs):
            try:
                return test(*args, **kwargs)
            except pytest.skip.Exception as e:
                pytest.fail(f"{test.__name__} skipped on the port: {e}")

        return run

    return {name: refusing(test) for name, test in tests.items()}


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
