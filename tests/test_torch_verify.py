"""tools/verify.py and tools/sanitize_cuda.py on the CPU.

verify's checks run through the plain versions and must print ALL-OK;
its encode and repair outputs equal the JAX package's LUT codec
(`garage_tpu.ops.gf.apply_matrix`) and its einsum coding body
(`ec_apply_fn(None, "einsum")`) on the same seeded numpy inputs,
tolerance 0 (integer math).  The case list reaches every path of the two
kernels, read from the shapes with the kernels' own rules.  The
compute-sanitizer command sets the tool, the caching-off environment and
the kernel filter, and the report parser passes only a clean summary and
a canary that was caught.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_verify.py
"""

import numpy as np
import pytest
import torch

from garage_tpu.ops import gf as jgf
from garage_tpu.ops.ec_tpu import ec_apply_fn
from garage_tpu_torch.tools import sanitize_cuda as sc
from garage_tpu_torch.tools import verify

# the suite runs in parallel worker processes: one torch thread each keeps
# them from oversubscribing the cores (it is no slower at these sizes)
torch.set_num_threads(1)

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def encode_inputs():
    return verify.encode_inputs(np.random.default_rng(verify.SEED))


@pytest.fixture(scope="module")
def repair_pieces():
    rng = np.random.default_rng(verify.SEED)
    verify.encode_inputs(rng)  # the draws verify makes before the repair inputs
    return verify.coded_pieces(rng, verify.REPAIR_BATCH, verify.REPAIR_K, verify.REPAIR_M,
                               verify.REPAIR_S)


def test_verify_on_cpu_prints_all_ok(capsys):
    assert verify.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "ALL-OK"
    ok = [ln for ln in lines if ln.endswith(": OK")]
    assert len(ok) == len(lines) - 1
    assert sum(ln.startswith("encode ") for ln in ok) == 18
    assert sum(ln.startswith("repair ") for ln in ok) == 12
    assert sum(ln.startswith("pipeline ") for ln in ok) == 1
    k2 = [c for c in verify.CASES if c.kind in ("k2", "pieces")]
    assert all(f"case {c.name}: OK" in ok for c in k2)


def test_verify_reports_a_mismatch(monkeypatch, capsys):
    """A wrong kernel output is a MISMATCH line, FAILURES=n and exit 1."""
    real = verify.IMPLS["kernel"]
    monkeypatch.setitem(verify.IMPLS, "kernel", lambda bm, x: real(bm, x) ^ 1)
    monkeypatch.setattr(verify, "CASES", [])
    assert verify.main(["--device", "cpu"]) == 1
    lines = capsys.readouterr().out.splitlines()
    assert lines[-1] == "FAILURES=9"
    assert "encode k=8 m=3 s=128 impl=kernel: MISMATCH" in lines


@pytest.mark.parametrize("index", range(9))
@pytest.mark.parametrize("impl", list(verify.IMPLS))
def test_encode_equals_the_jax_package(encode_inputs, index, impl):
    k, m, s, data = encode_inputs[index]
    got = verify.port_encode(k, m, data, impl, CPU)
    coding = jgf.cauchy_parity_matrix(k, m)
    assert np.array_equal(got, jgf.apply_matrix(coding, data))
    einsum = np.asarray(ec_apply_fn(None, "einsum")(jgf.bitmatrix_of(coding), data))
    assert np.array_equal(got, einsum)


@pytest.mark.parametrize("lost", verify.REPAIR_LOST, ids=str)
def test_repair_equals_the_jax_package(repair_pieces, lost):
    k, m = verify.REPAIR_K, verify.REPAIR_M
    codec = verify.EcCuda(k, m, device="cpu")
    got = verify.port_repair(codec, repair_pieces, lost)
    present = [i for i in range(k + m) if i not in lost][:k]
    rmat = jgf.reconstruction_matrix(k, m, present, lost)
    surv = repair_pieces[:, present]
    assert np.array_equal(got, jgf.apply_matrix(rmat, surv))
    einsum = np.asarray(ec_apply_fn(None, "einsum")(jgf.bitmatrix_of(rmat), surv))
    assert np.array_equal(got, einsum)
    assert np.array_equal(got, repair_pieces[:, lost])


def test_pipeline_parity_equals_the_jax_package():
    from garage_tpu.models.pipeline import ScrubRepairPipeline as JaxPipeline

    k, m, s = verify.PIPELINE_K, verify.PIPELINE_M, verify.PIPELINE_S
    data = np.random.default_rng(verify.SEED).integers(0, 256, (2, k, s), dtype=np.uint8)
    port = verify.ScrubRepairPipeline(k, m, s, device="cpu").encode_and_hash_fn()
    p, h, st = port(torch.from_numpy(data))
    jp, jh, jst = JaxPipeline(k=k, m=m, shard_bytes=s).jitted()(data)
    assert np.array_equal(p.numpy(), np.asarray(jp))
    assert np.array_equal(h.numpy(), np.asarray(jh))
    assert np.array_equal(st.numpy(), np.asarray(jst).astype(np.int64))


# --- the case list reaches every path -------------------------------------------

PATHS = {
    "K1 W=4 (r <= 4)": lambda c: c.kind == "k1" and verify.k1_width(c.m) == 4,
    "K1 W=8 (r > 4)": lambda c: c.kind == "k1" and verify.k1_width(c.m) == 8,
    "K1 two output groups (r > 8)": lambda c: c.kind == "k1" and c.m > 8,
    "K1 vector path": lambda c: c.kind == "k1" and c.k1_vec() and c.s >= 16,
    "K1 byte path, ragged tail": lambda c: c.kind == "k1" and c.k1_vec() and c.s % 16 != 0,
    "K1 byte path, misaligned view": lambda c: c.kind == "k1" and c.offset % 16 != 0,
    "K1 W=8 byte path": lambda c: c.kind == "k1" and c.m > 4 and c.k1_byte_path(),
    "K1 strided out=": lambda c: c.kind == "k1" and c.strided_out,
    "K1 every EC(8,3) erasure": lambda c: c.kind == "repair" and (c.k, c.m) == (8, 3),
    "K2 small kernel": lambda c: c.hash_len() is not None and c.hash_len() <= 1024,
    "K2 small kernel, part-empty block": lambda c: c.kind == "k2" and c.s <= 1024
    and c.b % 128 != 0 and c.b > 128,
    "K2 lpr < 32, part-empty last warp": lambda c: c.kind == "k2"
    and verify.k2_lanes_per_row(c.s) < 32 and verify.k2_part_empty_warp(c.b, c.s),
    "K2 one subtree per row": lambda c: c.kind == "k2" and c.s == 32 * 1024,
    "K2 ns > 1": lambda c: c.kind == "k2" and verify.k2_subtrees(c.s) > 1,
    "K2 ns = 32": lambda c: c.kind == "k2" and verify.k2_subtrees(c.s) == 32,
    "K2 ns > 32 (in-place reduction)": lambda c: c.kind == "k2" and verify.k2_subtrees(c.s) > 32,
    "K2 two strided sources": lambda c: c.kind == "pieces",
    "K2 two sources with subtrees": lambda c: c.kind == "pieces" and verify.k2_subtrees(c.s) > 1,
    "K3 EC(8,3) 1 MiB blocks, B=1": lambda c: c.kind == "k3" and c.b == 1 and c.k * c.s == 1 << 20,
    "K3 EC(8,3) 1 MiB blocks, B=3": lambda c: c.kind == "k3" and c.b == 3 and c.k * c.s == 1 << 20,
    "K5 eager": lambda c: c.kind == "k5",
    "K6 4 entries": lambda c: c.kind == "k6",
}


@pytest.mark.parametrize("path", list(PATHS))
def test_case_list_reaches(path):
    assert any(PATHS[path](c) for c in verify.CASES), path


@pytest.mark.parametrize("kernel", verify.KERNELS)
def test_light_cases_reach_every_kernel(kernel):
    """racecheck and initcheck run the light cases only: they still
    launch each kernel."""
    light = [c for c in verify.CASES if not c.heavy]
    kernels = {verify.K1_KERNELS[verify.k1_width(r)] for c in light for r in c.k1_rows()}
    kernels |= {verify.k2_kernel(c.hash_len()) for c in light if c.hash_len()}
    assert kernel in kernels


def test_path_rules_follow_the_kernels():
    # 17 rows of 2 chunks: 2 lanes a row, 16 rows a warp, 1 row in warp 2
    assert verify.k2_lanes_per_row(2048) == 2
    assert verify.k2_part_empty_warp(17, 2048)
    assert not verify.k2_part_empty_warp(16, 2048)
    assert verify.k2_subtrees(1 << 20) == 32 and verify.k2_subtrees(2 << 20) == 64
    assert verify.k2_subtrees(32 * 1024) == 1 and verify.k2_lanes_per_row(32 * 1024) == 32
    assert verify.k2_kernel(1024) == "blake3_small_kernel"
    assert verify.k2_kernel(2048) == "blake3_warp_kernel"
    assert (verify.k1_width(4), verify.k1_width(5)) == (4, 8)
    aligned = verify.Case("a", "k1", b=2, s=4096, k=8, m=3)
    assert aligned.k1_vec() and not aligned.k1_byte_path()
    assert verify.Case("t", "k1", b=2, s=4099, k=8, m=3).k1_byte_path()
    assert not verify.Case("o", "k1", b=2, s=4096, k=8, m=3, offset=1).k1_vec()
    assert not verify.Case("p", "k1", b=2, s=4104, k=3, m=3, strided_out=True).k1_vec()


def test_case_shapes_match_their_k1_views():
    """The strides `k1_vec` reads are those of the views the case builds."""
    for c in (c for c in verify.CASES if c.kind == "k1"):
        x, out = verify.k1_views(c, CPU)
        for view, (base, batch, row) in zip((x, out), c.k1_strides()):
            assert view.stride() == (batch, row, 1), c.name
            assert view.storage_offset() == base, c.name
        assert x.shape == (c.b, c.k, c.s) and out.shape == (c.b, c.m, c.s)


def test_light_cases_stay_small():
    """The racecheck and initcheck cases move at most a few MiB each."""
    for c in verify.CASES:
        if c.heavy:
            continue
        rows = c.b * (c.k + c.m + 1) if c.kind != "k2" else c.b
        assert rows * (c.s + c.offset + c.row_pad) <= (2 << 20) + 4096, c.name


def test_run_cases_on_cpu_counts_no_launch(capsys):
    fails, launches = verify.run_cases("cpu")
    assert fails == 0
    assert launches == dict.fromkeys(verify.KERNELS, 0)
    out = capsys.readouterr().out
    assert all(f"case {c.name}" in out for c in verify.CASES)


# --- compute-sanitizer: the command and the report --------------------------------


@pytest.mark.parametrize("tool", sc.TOOLS)
def test_sanitizer_command(tool):
    cmd = sc.sanitizer_command(tool, ["--child", tool], exe="/cuda/bin/compute-sanitizer")
    assert cmd[0] == "/cuda/bin/compute-sanitizer"
    assert cmd[cmd.index("--tool") + 1] == tool
    assert int(cmd[cmd.index("--error-exitcode") + 1]) != 0
    filters = [cmd[i + 1] for i, a in enumerate(cmd) if a == sc.KERNEL_FILTER_OPTION]
    for name in ("gf_bitplane_kernel", "blake3_small_kernel", "blake3_warp_kernel",
                 "sanitizer_canary_kernel"):
        assert any(name in f for f in filters), name
    assert cmd[-5:] == [sc.sys.executable, "-m", "garage_tpu_torch.tools.sanitize_cuda",
                        "--child", tool]
    assert "graph" not in " ".join(cmd)


def test_sanitizer_command_rejects_an_unknown_tool():
    with pytest.raises(ValueError):
        sc.sanitizer_command("leakcheck", [], exe="cs")


def test_sanitizer_env_turns_the_caching_allocator_off():
    env = sc.sanitizer_env({"PATH": "/bin"})
    assert env["PYTORCH_NO_CUDA_MEMORY_CACHING"] == "1"
    assert env["PATH"] == "/bin"


def test_compute_sanitizer_found_like_nvcc(tmp_path, monkeypatch):
    exe = tmp_path / "bin" / "compute-sanitizer"
    exe.parent.mkdir()
    exe.write_text("")
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert sc.compute_sanitizer() == str(exe)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if not (sc.Path("/usr/local/cuda/bin/compute-sanitizer")).exists():
        with pytest.raises(sc.SanitizerFailure):
            sc.compute_sanitizer()


LAUNCHES = ('launches: {"gf_bitplane_kernel<4>": 3, "gf_bitplane_kernel<8>": 2, '
            '"blake3_small_kernel": 2, "blake3_warp_kernel": 9}\n')
CLEAN = "========= COMPUTE-SANITIZER\n" + LAUNCHES + "========= ERROR SUMMARY: 0 errors\n"
ONE = ("========= Invalid __global__ read of size 1 bytes\n" + LAUNCHES
       + "========= ERROR SUMMARY: 1 error\n")
RACE_CLEAN = ("========= COMPUTE-SANITIZER\n" + LAUNCHES
              + "========= RACECHECK SUMMARY: 0 hazards displayed (0 errors, 0 warnings)\n")
RACE_WARN = ("========= COMPUTE-SANITIZER\n" + LAUNCHES
             + "========= RACECHECK SUMMARY: 1 hazard displayed (0 errors, 1 warning)\n")


def test_report_parser_passes_a_clean_summary():
    for text, tool in ((CLEAN, "memcheck"), (RACE_CLEAN, "racecheck")):
        run = sc.ToolRun(tool, 0, text, 1.0)
        assert run.errors == 0
        assert run.launches["blake3_warp_kernel"] == 9
        sc.check_tool_run(run, verify.KERNELS)


@pytest.mark.parametrize("text,rc", [(ONE, sc.ERROR_EXITCODE), (ONE, 0), (RACE_WARN, 0),
                                     (CLEAN.replace("ERROR SUMMARY: 0 errors", ""), 0),
                                     (CLEAN, sc.ERROR_EXITCODE), (CLEAN, None)],
                         ids=["one-error", "one-error-rc0", "race-warning", "no-summary",
                              "nonzero-rc", "timeout"])
def test_report_parser_fails_a_report(text, rc):
    with pytest.raises(sc.SanitizerFailure):
        sc.check_tool_run(sc.ToolRun("memcheck", rc, text, 1.0), verify.KERNELS)


def test_report_parser_fails_a_kernel_with_no_launch():
    text = CLEAN.replace('"blake3_small_kernel": 2', '"blake3_small_kernel": 0')
    with pytest.raises(sc.SanitizerFailure, match="blake3_small_kernel"):
        sc.check_tool_run(sc.ToolRun("memcheck", 0, text, 1.0), verify.KERNELS)
    with pytest.raises(sc.SanitizerFailure):
        sc.check_tool_run(sc.ToolRun("memcheck", 0, CLEAN.replace(LAUNCHES, ""), 1.0),
                          verify.KERNELS)


def test_canary_must_be_caught():
    caught = ("========= Invalid __global__ read of size 1 bytes\n"
              "=========     at sanitizer_canary_kernel(const unsigned char *, long long, "
              "unsigned char *)+0x60\n"
              "=========     Address 0x7f0000001001 is out of bounds\n"
              "========= ERROR SUMMARY: 1 error\n")
    sc.check_canary_run(sc.ToolRun("memcheck", sc.ERROR_EXITCODE, caught, 1.0))
    for text, rc in (("========= ERROR SUMMARY: 0 errors\n", 0),  # reported nothing
                     ("========= ERROR SUMMARY: 0 errors\n", sc.ERROR_EXITCODE),
                     ("canary: launch code 0\n", 0),  # no summary at all
                     (caught, 0), (caught, None)):
        with pytest.raises(sc.SanitizerFailure):
            sc.check_canary_run(sc.ToolRun("memcheck", rc, text, 1.0))


def test_unsupported_card_is_named():
    text = ("========= COMPUTE-SANITIZER\n"
            "========= Error: Device not supported. Please refer to the \"Supported Devices\" "
            "section of the sanitizer documentation\n"
            "========= ERROR SUMMARY: 3 errors\n")
    run = sc.ToolRun("memcheck canary", sc.ERROR_EXITCODE, text, 1.0)
    assert run.unsupported
    assert not sc.ToolRun("memcheck", 0, CLEAN, 1.0).unsupported
    with pytest.raises(sc.SanitizerFailure):
        sc.check_canary_run(run)  # an unsupported card is no caught canary


GUARD_OK = ('guard: {"allocs": 812, "frees": 800, "violations": 0, "failed_allocs": 0, '
            '"bytes_live": 0, "bytes_peak": 1, "last_error": 0}\n')


def test_guard_run_passes_only_a_clean_child():
    stats = sc.check_guard_run(sc.ToolRun("guard-after", 0, LAUNCHES + GUARD_OK, 1.0),
                               verify.KERNELS)
    assert stats["allocs"] == 812
    bad = [
        (LAUNCHES + GUARD_OK.replace('"violations": 0', '"violations": 1'), 0),
        (LAUNCHES + GUARD_OK.replace('"failed_allocs": 0', '"failed_allocs": 2'), 0),
        (LAUNCHES + GUARD_OK.replace('"allocs": 812', '"allocs": 0'), 0),
        (LAUNCHES, 0),  # no stats: the allocator never reported
        (LAUNCHES + GUARD_OK, 1),
        (LAUNCHES + GUARD_OK, None),
        (LAUNCHES + "RuntimeError: CUDA error: an illegal memory access was encountered\n"
         + GUARD_OK, 0),
        (GUARD_OK, 0),  # no launches
    ]
    for text, rc in bad:
        with pytest.raises(sc.SanitizerFailure):
            sc.check_guard_run(sc.ToolRun("guard-after", rc, text, 1.0), verify.KERNELS)


def test_guard_canary_must_fault():
    faulted = (GUARD_OK + "canary: launch code 0\ncanary: synchronize raised CUDA error: "
               "an illegal memory access was encountered\n")
    sc.check_guard_canary(sc.ToolRun("guard-after canary", 0, faulted, 1.0))
    for text, rc in ((GUARD_OK + "canary: launch code 0\n", 0),  # read the guard, no fault
                     (faulted.replace(GUARD_OK, ""), 0),  # the allocator was not in use
                     (faulted, None)):
        with pytest.raises(sc.SanitizerFailure):
            sc.check_guard_canary(sc.ToolRun("guard-after canary", rc, text, 1.0))


def test_sanitized_field():
    runs = {mode: {"violations": 0} for mode in ("guard_after", "guard_before")}
    unsupported = sc.sanitized_field({"compute_sanitizer": {"supported": False}, **runs})
    assert unsupported == {"memcheck": None, "racecheck": None, "synccheck": None,
                           "initcheck": None, "compute_sanitizer": sc.UNSUPPORTED,
                           "guard_after": 0, "guard_before": 0}
    tools = {t: {"errors": 0} for t in sc.TOOLS}
    full = sc.sanitized_field({"compute_sanitizer": {"supported": True}, **tools, **runs})
    assert full == {"memcheck": 0, "racecheck": 0, "synccheck": 0, "initcheck": 0,
                    "guard_after": 0, "guard_before": 0}
