"""tools/cuda_on_host.py on the CPU: the port's two kernel sources
compiled for the host against `tools/cuda_on_host.h` and run under
AddressSanitizer + UBSan and under ThreadSanitizer on every light case of
`tools/verify.py` that launches a kernel, each output bit-exact against
the oracles.  Then four faults put into a copy of a source, each of a
kind compute-sanitizer's tools look for, must each fail its run: a
missing barrier after K1's table build (racecheck: a data race), spare
lanes of K2's warp kernel that return before its full-mask shuffles
(synccheck), K1's byte path reading one column past the tail (memcheck:
a heap overflow), and K2's arrival counters left unzeroed (initcheck: the
poisoned counters leave the rows unfinished).

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_cuda_on_host.py
"""

import shutil

import pytest

from garage_tpu_torch.ops import _build
from garage_tpu_torch.tools import cuda_on_host as coh
from garage_tpu_torch.tools import verify


@pytest.fixture
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ unavailable: the host builds need it")


@pytest.mark.parametrize("name,launches", [("gf_bitplane", 1), ("blake3", 2)])
def test_translate_turns_every_launch_into_a_call(name, launches):
    text = coh.translate(name, _build.source(name).read_text())
    assert "<<<" not in text and ">>>" not in text
    assert text.count("cuda_on_host_launch(") == launches
    for _old, new in coh.SUBSTITUTIONS[name]:
        assert new in text


def test_translate_refuses_a_source_that_moved():
    text = _build.source("blake3").read_text().replace('asm("mad.lo.u32', 'asm("mad.lo.s32')
    with pytest.raises(coh.TranslationError):
        coh.translate("blake3", text)


def test_checked_cases_reach_every_kernel():
    kinds = {c.kind for c in coh.checked_cases()}
    assert kinds == {"k1", "repair", "k2", "pieces"}
    assert not any(c.heavy for c in coh.checked_cases())
    assert [c.name for c in coh.checked_cases(["k2_small_64"])] == ["k2_small_64"]


@pytest.mark.parametrize("mode", list(coh.MODES))
def test_every_light_case_is_clean(gxx, mode):
    res = coh.run_mode(mode)
    assert coh.clean(res), res["output"][-4000:]
    assert f"{mode}: synchronisation errors 0, mismatches 0" in res["output"]
    for case in coh.checked_cases():
        assert f"{mode} case {case.name}: OK" in res["output"]
    assert set(res["launches"]) == set(verify.KERNELS)


FAULTS = {
    # (mode, case, source, exact text, its replacement, what the run must print)
    "k1 table barrier missing": (
        "tsan", "k1_w4_ec16_4", "gf_bitplane",
        "    set_basis(tab[(j * 2 + (a >> 2)) * 16 + (1 << (a & 3))], w);\n  }\n  __syncthreads();",
        "    set_basis(tab[(j * 2 + (a >> 2)) * 16 + (1 << (a & 3))], w);\n  }\n",
        "ThreadSanitizer: data race"),
    "k2 spare lanes return before the shuffles": (
        "asan", "k2_warp_lpr2_part_empty", "blake3",
        "    row = R.n - 1;  // a spare lane: it hashes a real row and stores nothing",
        "    return;", "synccheck: __shfl_down_sync names a lane that has exited"),
    "k1 byte path reads past the tail": (
        "asan", "k1_w4_byte_tail", "gf_bitplane",
        "  for (int c = 0; c < n; ++c) {", "  for (int c = 0; c <= n; ++c) {",
        "AddressSanitizer: heap-buffer-overflow"),
    "k2 arrival counters left unzeroed": (
        "asan", "k2_warp_2_subtrees", "blake3",
        "      err = cudaMemsetAsync(arrivals, 0, (size_t)R.n * sizeof(unsigned int), st);",
        "      err = cudaSuccess;", "asan case k2_warp_2_subtrees: MISMATCH"),
}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_fault_put_in_fails_its_run(gxx, fault):
    mode, case, name, old, new, report = FAULTS[fault]
    text = _build.source(name).read_text()
    assert text.count(old) == 1, f"csrc/{name}.cu no longer holds the text of {fault!r}"
    res = coh.run_mode(mode, cases=[case], texts={name: text.replace(old, new)},
                       tag="-fault")
    assert res["rc"] not in (0, None), res["output"][-4000:]
    assert report in res["output"], res["output"][-4000:]
