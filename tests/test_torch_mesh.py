"""garage_tpu_torch mesh fan-out on the CPU against the JAX package's
mesh path (tests/test_mesh_repair.py): the JAX side runs on the
conftest's 8 virtual CPU devices, the port on an 8-entry CPU mesh with
`n_devices=8`.  Inputs come from numpy seeds; the tolerance is zero
(integer math, bit-exact).  Both sides must show their mesh path ran."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
from garage_tpu.block.codec.ec import EcCodec as JaxEcCodec
from garage_tpu.models.pipeline import ScrubRepairPipeline as JaxPipeline
from garage_tpu.ops import bucketing as jbucketing
from garage_tpu.ops.ec_tpu import EcTpu
from garage_tpu.parallel.mesh import make_mesh as jax_make_mesh
from garage_tpu_torch import graft_entry
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.models.pipeline import ScrubRepairPipeline
from garage_tpu_torch.ops import bucketing, ec_cuda
from garage_tpu_torch.ops.ec_cuda import EcCuda
from garage_tpu_torch.parallel.mesh import Mesh, make_mesh
from garage_tpu_torch.utils.metrics import registry

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

N = 8


@pytest.fixture
def mesh_calls(monkeypatch):
    """Counts `_apply_mesh` calls on both sides: {"jax": [...], "port": [...]}
    of (batch, width)."""
    calls = {"jax": [], "port": []}
    jax_orig, port_orig = EcTpu._apply_mesh, EcCuda._apply_mesh

    def jax_wrapper(self, bitmat, x, n, rec=None):
        calls["jax"].append((x.shape[0], n))
        return jax_orig(self, bitmat, x, n, rec)

    def port_wrapper(self, key, x, n, rec):
        calls["port"].append((x.shape[0], n))
        return port_orig(self, key, x, n, rec)

    monkeypatch.setattr(EcTpu, "_apply_mesh", jax_wrapper)
    monkeypatch.setattr(EcCuda, "_apply_mesh", port_wrapper)
    return calls


def test_encode_mesh_uneven_batch_matches_reference(mesh_calls):
    """EC(8,3) encode at b = 21 (not a multiple of 8): pad, split, slice."""
    k, m, s, b = 8, 3, 256, 2 * N + 5
    data = np.random.default_rng(0).integers(0, 256, (b, k, s), dtype=np.uint8)
    want = EcTpu(k, m).encode(data)
    got = EcCuda(k, m, device="cpu", n_devices=N).encode(data)
    assert mesh_calls == {"jax": [(b, N)], "port": [(b, N)]}
    assert np.array_equal(got, want)


def test_reconstruct_mesh_matches_reference(mesh_calls):
    """EC(16,4) reconstruct of ranks [0, 5, 17] (two data, one parity)."""
    k, m, s, b = 16, 4, 128, 2 * N
    rng = np.random.default_rng(1)
    data = rng.integers(0, 256, (b, k, s), dtype=np.uint8)
    full = np.concatenate([data, EcTpu(k, m).encode(data)], axis=1)
    lost = [0, 5, 17]
    present = [i for i in range(k + m) if i not in lost]
    mesh_calls["jax"].clear()
    want = EcTpu(k, m).reconstruct(full[:, present], present, lost)
    got = EcCuda(k, m, device="cpu", n_devices=N).reconstruct(full[:, present], present, lost)
    assert mesh_calls["jax"] and mesh_calls["port"] == [(b, N)]
    assert np.array_equal(got, want) and np.array_equal(got, full[:, lost])


def test_codec_batch_apis_route_through_mesh(mesh_calls):
    """`encode_batch`, `decode_batch` and `reconstruct_batch` fan out at
    2n+1 blocks and agree with the reference codec's mesh path."""
    rng = np.random.default_rng(2)
    blocks = [bytes(rng.integers(0, 256, 4096, dtype=np.uint8)) for _ in range(2 * N + 1)]
    ref = JaxEcCodec(4, 2)
    port = EcCodec(4, 2, device="cpu", n_devices=N)
    enc = port.encode_batch(blocks)
    assert enc == ref.encode_batch(blocks)
    assert mesh_calls["jax"] and mesh_calls["port"]
    items = [({i: p for i, p in enumerate(pieces) if i not in (0, 3)}, len(b))
             for b, pieces in zip(blocks, enc)]
    n_port = len(mesh_calls["port"])
    assert port.decode_batch(items) == blocks
    assert len(mesh_calls["port"]) == n_port + 1
    batches = [(have, [0, 3], n) for have, n in items]
    recs = port.reconstruct_batch(batches)
    assert recs == ref.reconstruct_batch(batches)
    assert recs == [{0: pieces[0], 3: pieces[3]} for pieces in enc]
    assert len(mesh_calls["port"]) == n_port + 2


@pytest.mark.parametrize("b", [16, 19])
def test_sharded_apply_matches_reference(b):
    k, m, s = 8, 3, 1024
    data = np.random.default_rng(b).integers(0, 256, (b, k, s), dtype=np.uint8)
    want = JaxPipeline(k, m, s).sharded_apply(jax_make_mesh(N), data)
    pipe = ScrubRepairPipeline(k, m, s, device="cpu")
    got = pipe.sharded_apply(make_mesh(N, device="cpu"), data)
    for g, w in zip(got, want):
        assert np.array_equal(g, np.asarray(w))
    assert int(got[2][0]) == b
    # the single-device step gives the same parity, hashes and stats
    single = pipe.encode_and_hash_fn()(torch.from_numpy(data))
    for g, w in zip(got, single):
        assert np.array_equal(g, w.numpy())


@pytest.mark.parametrize("n", [1, 3, 8])
def test_pad_for_mesh_matches_reference(n):
    """`mesh_rows` is the reference's `pad_for_mesh` rule, and the slices
    `Mesh.scatter` places on the entries are the reference's padded
    batch, in order."""
    mesh = make_mesh(n, device="cpu")
    for b in list(range(0, 40)) + [255, 256, 259]:
        x = np.arange(b * 2, dtype=np.uint8).reshape(b, 2)
        want = jbucketing.pad_for_mesh(x, n)
        rows = bucketing.mesh_rows(b, n)
        assert rows == want.shape[0], (b, n)
        parts = mesh.scatter(torch.from_numpy(x), rows)
        assert len({p.shape[0] for p in parts}) == 1
        assert np.array_equal(torch.cat(parts).numpy(), want), (b, n)
    with pytest.raises(ValueError):
        mesh.scatter(torch.zeros((5, 2)), 4)


def test_mesh_width_and_engage_threshold(monkeypatch, mesh_calls):
    data = np.random.default_rng(3).integers(0, 256, (8, 4, 128), dtype=np.uint8)
    assert EcCuda(4, 2, device="cpu")._mesh_width() == 1  # a CPU codec: 1
    pinned = EcCuda(4, 2, device="cpu", n_devices=4)
    assert pinned._mesh_width() == 4
    monkeypatch.setenv("GARAGE_EC_MESH", "0")
    assert pinned._mesh_width() == 1
    pinned.encode(data)
    assert mesh_calls["port"] == []
    monkeypatch.delenv("GARAGE_EC_MESH")
    # pinned: engages at n
    pinned.encode(data[:3])
    assert mesh_calls["port"] == []
    pinned.encode(data[:4])
    assert mesh_calls["port"] == [(4, 4)]
    # auto-detected: engages at 2n
    auto = EcCuda(4, 2, device="cpu")
    monkeypatch.setattr(auto, "_mesh_width", lambda: 4)
    auto.encode(data[:7])
    assert mesh_calls["port"] == [(4, 4)]
    want = ec_cuda.gf_bitmatmul(auto._enc_bitmat, torch.from_numpy(data)).numpy()
    assert np.array_equal(auto.encode(data), want)
    assert mesh_calls["port"] == [(4, 4), (8, 4)]
    # the auto width of a CUDA codec is the number of visible cards
    cuda_like = EcCuda(4, 2, device="cpu")
    cuda_like.device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert cuda_like._mesh_width() == 3


def test_failed_mesh_dispatch_raises_without_fallback(monkeypatch):
    ec = EcCuda(4, 2, device="cpu", n_devices=4)
    launches = []

    def broken(bitmat, x, out=None):
        launches.append(x.shape[0])
        raise RuntimeError("injected launch failure")

    monkeypatch.setattr(ec_cuda, "gf_bitmatmul_cuda", broken)
    with pytest.raises(RuntimeError, match="injected"):
        ec.encode(np.zeros((4, 4, 128), dtype=np.uint8))
    assert launches == [1]  # the first entry failed; no single-device retry


def test_make_mesh_raises_rather_than_using_the_cpu(monkeypatch):
    cpu = make_mesh(3, device="cpu")
    assert cpu.size == 3 and cpu.devices == (torch.device("cpu"),) * 3
    assert cpu.streams == (None,) * 3
    assert make_mesh(device="cpu").size == 1
    assert make_mesh(devices=["cpu", "cpu"]).size == 2
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"])
    with pytest.raises(ValueError):
        Mesh([])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match="torch sees 2"):
        make_mesh(4)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError):
        make_mesh()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            make_mesh(devices=["cuda:0"] * 4)
        with pytest.raises(RuntimeError):
            EcCodec(8, 3, n_devices=4)


def test_mesh_rejects_a_codec_of_another_device_type():
    with pytest.raises(ValueError):
        EcCuda(4, 2, device="cpu", n_devices=2, mesh=make_mesh(3, device="cpu"))
    ec = EcCuda(4, 2, device="cpu", mesh=make_mesh(3, device="cpu"))
    assert ec._mesh_width() == 3


def test_entry_matches_reference_entry():
    jfn, (jex,) = jax_entry.entry()
    fn, (ex,) = graft_entry.entry(device="cpu")
    assert np.array_equal(ex.numpy(), np.asarray(jex))
    for g, w in zip(fn(ex), jfn(jex)):
        assert np.array_equal(g.numpy(), np.asarray(w))


def test_dryrun_multichip_on_cpu_mesh():
    before = registry.counter_family_sum("tpu_mesh_engaged_total")
    summary = graft_entry.dryrun_multichip(N, device="cpu")
    assert summary["mesh"] == ["cpu"] * N and summary["ec164_batch"] == N + 3
    assert registry.counter_family_sum("tpu_mesh_engaged_total") >= before + 2


def test_a_device_with_no_kernel_is_refused():
    """The wrappers and the entry points share one device check
    (`telemetry.runs_on_host`): the CPU takes the plain version, and a
    device that is neither the CPU nor CUDA raises instead of falling
    back."""
    from garage_tpu_torch.ops import telemetry
    from garage_tpu_torch.ops.hash_cuda import blake3_batch, blake3_pieces
    from garage_tpu_torch.parallel.mesh import resolve_device

    assert telemetry.runs_on_host("cpu") and telemetry.runs_on_host(torch.zeros(1))
    assert not telemetry.runs_on_host("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    meta = torch.empty((2, 4, 64), dtype=torch.uint8, device="meta")
    bitmat = torch.empty((16, 32), dtype=torch.uint8, device="meta")
    for call in (lambda: resolve_device("meta"),
                 lambda: ec_cuda.gf_bitmatmul_cuda(bitmat, meta),
                 lambda: blake3_batch(meta[:, 0]),
                 lambda: blake3_pieces(meta, meta[:, :2])):
        with pytest.raises(ValueError, match="unsupported device meta"):
            call()
