"""The port's host codec on the CPU, held to the reference's.

  - `_native.gf8_apply` (the port's copy of `_native/gf8.cpp`) against
    the reference's `_native.gf8_apply` and the numpy oracle
    `gf.apply_matrix_ref`: r from 1 to 8, q in {1, 2, 8, 16}, shard
    lengths that cover the SIMD tails and the thread split, matrices with
    zero entries;
  - `ops/gf.apply_matrix` on 2-D and 3-D operands;
  - `EcCodec(k, m, device="cpu")` under each `impl` ("auto", "host",
    "xla") against the reference's `EcCodec(k, m, tpu_enable=False)`:
    `encode_batch_hashed`, `decode_batch`, `reconstruct_batch` and the
    scalar paths, ragged sizes included;
  - the policy: on a CPU codec, "auto" and "host" never call EcCuda,
    "xla" does; a failed native build raises;
  - the counters and dispatch records equal the reference's;
  - the port's copy of tests/test_ec.py::test_native_matches_reference.

Tolerance: zero (integer math; bytes compared exactly).
"""

import numpy as np
import pytest
import torch

from garage_tpu import _native as j_native
from garage_tpu.block.codec.ec import EcCodec as JEcCodec
from garage_tpu.ops import gf as jgf
from garage_tpu.utils.metrics import registry as j_registry
from garage_tpu_torch import _native
from garage_tpu_torch.block.codec.ec import EcCodec
from garage_tpu_torch.ops import gf
from garage_tpu_torch.ops.blake3_ref import blake3 as py_blake3
from garage_tpu_torch.ops.ec_cuda import EcCuda, blake3_supported_len
from garage_tpu_torch.utils.metrics import registry

torch.set_num_threads(1)  # one thread per suite worker

IMPLS = ("auto", "host", "xla")
GEOMETRIES = [(2, 1), (4, 2), (8, 3)]
SIZES = (1, 64, 255, 1000, 4096, 5000, 8192, 8191)  # ragged: padded splits and tails


def _blocks(rng, sizes):
    return [bytes(rng.integers(0, 256, n, dtype=np.uint8)) for n in sizes]


def _matrices(rng, r: int, q: int) -> list[np.ndarray]:
    """Random entries with zeros forced in, an all-zero row, ones (the
    XOR-only path), and a dense random matrix."""
    sparse = rng.integers(0, 256, (r, q), dtype=np.uint8)
    sparse[rng.random((r, q)) < 0.3] = 0
    sparse[r // 2] = 0
    ones = np.ones((r, q), dtype=np.uint8)
    dense = rng.integers(1, 256, (r, q), dtype=np.uint8)
    return [sparse, ones, dense]


# --- the native codec ------------------------------------------------------------


@pytest.mark.parametrize("s", [1, 15, 16, 31, 32, 33, 4103, 131072])
@pytest.mark.parametrize("q", [1, 2, 8, 16])
def test_gf8_apply_matches_reference_and_oracle(q, s):
    rng = np.random.default_rng(q * 1000 + s)
    shards = rng.integers(0, 256, (q, s), dtype=np.uint8)
    for r in range(1, 9):
        for mat in _matrices(rng, r, q):
            got = _native.gf8_apply(mat, shards)
            assert got.dtype == np.uint8 and got.shape == (r, s)
            assert np.array_equal(got, j_native.gf8_apply(mat, shards)), (r, q, s)
            assert np.array_equal(got, jgf.apply_matrix_ref(mat, shards)), (r, q, s)


def test_gf8_apply_takes_strided_and_readonly_operands():
    rng = np.random.default_rng(3)
    mat = gf.cauchy_parity_matrix(8, 3)
    wide = rng.integers(0, 256, (8, 2 * 4099), dtype=np.uint8)
    strided = wide[:, ::2]
    ro = np.frombuffer(bytes(wide[:, :4099]), dtype=np.uint8).reshape(8, 4099)
    for shards in (strided, ro):
        assert np.array_equal(_native.gf8_apply(mat, shards), gf.apply_matrix_ref(mat, shards))
    with pytest.raises(ValueError):
        _native.gf8_apply(mat, wide[:7])
    with pytest.raises(ValueError):
        _native.gf8_apply(mat, wide[None])


@pytest.mark.parametrize("shape", [(8, 5000), (3, 8, 1000), (2, 2, 8, 64)])
def test_apply_matrix_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    mat = gf.cauchy_parity_matrix(8, 3)
    shards = rng.integers(0, 256, shape, dtype=np.uint8)
    got = gf.apply_matrix(mat, shards)
    assert np.array_equal(got, jgf.apply_matrix(mat, shards))
    assert np.array_equal(got, gf.apply_matrix_ref(mat, shards))


def test_native_matches_reference():
    """tests/test_ec.py::test_native_matches_reference on the port: the
    C++ host codec and BLAKE3 are bit-identical to the oracles."""
    assert _native.available()
    rng = np.random.default_rng(5)
    mat = gf.cauchy_parity_matrix(8, 3)
    shards = rng.integers(0, 256, (8, 5000), dtype=np.uint8)
    assert np.array_equal(_native.gf8_apply(mat, shards), gf.apply_matrix_ref(mat, shards))
    for n in [0, 1, 64, 1023, 1024, 1025, 4096, 5000, 100000]:
        d = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        assert _native.blake3(d) == py_blake3(d), f"len {n}"
    batch = rng.integers(0, 256, (7, 2048), dtype=np.uint8)
    got = _native.blake3_batch(batch)
    for i in range(7):
        assert bytes(got[i]) == py_blake3(bytes(batch[i]))


def test_failed_native_build_raises(monkeypatch, tmp_path):
    """Without g++ the library cannot be built: the host codec raises
    `NativeBuildError`, never a slower path."""
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(_native.shutil, "which", lambda _name: None)
    mat = gf.cauchy_parity_matrix(2, 1)
    with pytest.raises(_native.NativeBuildError):
        _native.gf8_apply(mat, np.zeros((2, 64), dtype=np.uint8))
    with pytest.raises(_native.NativeBuildError):
        EcCodec(2, 1, device="cpu").encode(b"x" * 100)


# --- the codec against the reference's host codec ----------------------------------


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_encode_batch_hashed_matches_reference_host(k, m, impl):
    rng = np.random.default_rng(k * 10 + m)
    blocks = _blocks(rng, SIZES + (3 * 1024 * k,))
    port = EcCodec(k, m, device="cpu")
    ref = JEcCodec(k, m, tpu_enable=False)
    got = port.encode_batch_hashed(blocks, impl)
    want = ref.encode_batch_hashed(blocks)
    assert [p for p, _h in got] == [p for p, _h in want]
    if impl == "xla":
        # the card path's hashes: None where the batched hasher does not
        # take the shard length, else the reference's
        for blk, (_p, h), (_q, w) in zip(blocks, got, want):
            assert h == (w if blake3_supported_len(port.piece_len(len(blk))) else None)
    else:
        assert [h for _p, h in got] == [h for _p, h in want]
        assert all(h == [py_blake3(x) for x in p] for p, h in got[:3])


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("lost", [(0,), (1, 2), (0, 2, 9), (8, 9, 10), (3,)])
def test_decode_batch_matches_reference_host(lost, impl):
    k, m = 8, 3
    rng = np.random.default_rng(sum(lost) + len(lost))
    blocks = _blocks(rng, SIZES)
    port = EcCodec(k, m, device="cpu")
    ref = JEcCodec(k, m, tpu_enable=False)
    items = [({i: p for i, p in enumerate(ref.encode(b)) if i not in lost}, len(b))
             for b in blocks]
    got = port.decode_batch(items, impl)
    assert got == ref.decode_batch(items) == blocks
    assert [port.decode(p, n) for p, n in items] == blocks


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_reconstruct_batch_matches_reference_host(k, m, impl):
    rng = np.random.default_rng(100 + k)
    blocks = _blocks(rng, SIZES)
    port = EcCodec(k, m, device="cpu")
    ref = JEcCodec(k, m, tpu_enable=False)
    wants = [[i % (k + m)] for i in range(len(blocks))]
    wants[1] = list(range(m))[::-1]  # several ranks, not in order
    wants[2] = [k + m - 1, 0][:m]
    batches = []
    for blk, want in zip(blocks, wants):
        pieces = ref.encode(blk)
        batches.append(({i: p for i, p in enumerate(pieces) if i not in want}, want, len(blk)))
    got = port.reconstruct_batch(batches, impl)
    assert got == ref.reconstruct_batch(batches)
    for (have, want, n), blk, rec in zip(batches, blocks, got):
        full = ref.encode(blk)
        assert rec == {w: full[w] for w in want}
        assert port.reconstruct_pieces(have, want, n) == ref.reconstruct_pieces(have, want, n)


@pytest.mark.parametrize("k,m", GEOMETRIES)
def test_scalar_paths_match_reference_host(k, m):
    rng = np.random.default_rng(7 * k)
    port = EcCodec(k, m, device="cpu")
    ref = JEcCodec(k, m, tpu_enable=False)
    blocks = _blocks(rng, SIZES)
    assert port.encode_batch(blocks) == ref.encode_batch(blocks)
    for impl in IMPLS:
        assert port.encode_batch(blocks, impl) == ref.encode_batch(blocks)
    for blk in blocks:
        pieces = port.encode(blk)
        assert pieces == ref.encode(blk)
        have = {i: p for i, p in enumerate(pieces) if i != 0}
        assert port.decode(have, len(blk)) == ref.decode(have, len(blk)) == blk
        assert port.decode(dict(enumerate(pieces)), len(blk)) == blk


def test_host_paths_reject_too_few_or_short_pieces():
    codec = EcCodec(4, 2, device="cpu")
    pieces = codec.encode(b"x" * 1000)
    with pytest.raises(ValueError):
        codec.decode({0: pieces[0], 5: pieces[5]}, 1000)
    with pytest.raises(ValueError):
        codec.reconstruct_batch([({i: pieces[i] for i in range(3)}, [4], 1000)], "host")
    short = {1: pieces[1], 2: pieces[2], 3: pieces[3][:-1], 4: pieces[4]}
    with pytest.raises(ValueError):
        codec.decode_batch([(short, 1000)], "host")
    with pytest.raises(ValueError):
        codec.encode_batch_hashed([b"x"], "gpu")


# --- the policy ----------------------------------------------------------------------


@pytest.fixture
def ec_cuda_calls(monkeypatch):
    """EcCuda's entry points, recorded; `raising=True` makes them raise."""
    calls = []
    state = {"raise": False}
    for name in ("encode", "encode_and_hash", "reconstruct"):
        orig = getattr(EcCuda, name)

        def wrapper(self, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            if state["raise"]:
                raise AssertionError(f"EcCuda.{_name} called on the host path")
            return _orig(self, *a, **kw)

        monkeypatch.setattr(EcCuda, name, wrapper)
    return calls, state


def _drive(codec: EcCodec, impl: str) -> None:
    rng = np.random.default_rng(0)
    blocks = _blocks(rng, (4096, 4096, 1000))
    hashed = codec.encode_batch_hashed(blocks, impl)
    pieces = codec.encode_batch(blocks, impl)
    assert [p for p, _h in hashed] == pieces
    items = [({i: p for i, p in enumerate(ps) if i != 0}, len(b)) for b, ps in zip(blocks, pieces)]
    assert codec.decode_batch(items, impl) == blocks
    batches = [(have, [0], n) for have, n in items]
    assert codec.reconstruct_batch(batches, impl) == [{0: ps[0]} for ps in pieces]


@pytest.mark.parametrize("impl", ["auto", "host"])
def test_cpu_codec_host_policy_never_calls_ec_cuda(impl, ec_cuda_calls):
    calls, state = ec_cuda_calls
    state["raise"] = True
    codec = EcCodec(4, 2, device="cpu")
    _drive(codec, impl)
    # the scalar paths of a CPU codec are the host codec's too
    pieces = codec.encode(b"y" * 3000)
    assert codec.decode({i: p for i, p in enumerate(pieces) if i != 1}, 3000) == b"y" * 3000
    assert codec.reconstruct_pieces({i: p for i, p in enumerate(pieces) if i != 4}, [4], 3000) \
        == {4: pieces[4]}
    assert calls == []


def test_cpu_codec_xla_policy_calls_ec_cuda(ec_cuda_calls):
    calls, _state = ec_cuda_calls
    _drive(EcCodec(4, 2, device="cpu"), "xla")
    # two shard-size groups: each batched call dispatches twice
    assert calls == ["encode_and_hash"] * 2 + ["encode"] * 2 + ["reconstruct"] * 4


def test_cuda_codec_policy_without_a_card(monkeypatch):
    """The policy table's CUDA row, decided without a card: "auto" and
    "xla" take EcCuda, "host" the native host codec."""
    codec = EcCodec(2, 1, device="cpu")
    monkeypatch.setattr(codec, "device", torch.device("cuda", 0))
    assert not codec._on_host("auto") and not codec._on_host("xla")
    assert codec._on_host("host")


# --- labels ------------------------------------------------------------------------------

FAMILIES = ("block_codec_blocks_total", "block_codec_bytes_total", "tpu_codec_dispatch_total",
            "tpu_codec_bytes_total", "tpu_codec_pad_requested_total",
            "tpu_codec_pad_padded_total")
HISTOGRAMS = ("tpu_codec_batch_size", "tpu_codec_dispatch_duration",
              "tpu_codec_compute_duration")


def _snapshot(reg) -> tuple[dict, dict]:
    counters = {k: v for k, v in reg.counters.items() if k[0] in FAMILIES}
    hists = {k: d[0] for k, d in reg.durations.items() if k[0] in HISTOGRAMS}
    return counters, hists


def _delta(before: dict, after: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def test_counters_and_dispatch_labels_equal_the_references():
    rng = np.random.default_rng(9)
    blocks = _blocks(rng, (4096, 4096, 1000, 64))

    def drive(codec, reg):
        c0, h0 = _snapshot(reg)
        out = codec.encode_batch_hashed(blocks)
        pieces = [p for p, _h in out]
        items = [({i: p for i, p in enumerate(ps) if i != 1}, len(b))
                 for b, ps in zip(blocks, pieces)]
        items.append((dict(enumerate(pieces[0])), len(blocks[0])))  # a systematic join
        codec.decode_batch(items)
        codec.reconstruct_batch([(have, [1], n) for have, n in items[:2]])
        codec.encode(blocks[2])
        codec.decode(*items[3])
        codec.reconstruct_pieces(items[0][0], [1], items[0][1])
        c1, h1 = _snapshot(reg)
        return _delta(c0, c1), _delta(h0, h1)

    port = drive(EcCodec(4, 2, device="cpu"), registry)
    ref = drive(JEcCodec(4, 2, tpu_enable=False), j_registry)
    assert port == ref
    counters, _hists = port
    assert counters[("block_codec_blocks_total", (("op", "encode"), ("path", "numpy")))] == 5
    assert counters[("tpu_codec_dispatch_total",
                     (("kernel", "ec_encode_host"), ("platform", "host")))] == 1
    assert counters[("tpu_codec_dispatch_total",
                     (("kernel", "ec_decode_host"), ("platform", "host")))] == 1
    assert ("jax_backend_platform", (("platform", "host"),)) in registry._gauge_fns
