"""Share, in %, of the card's least time for the encode work in the
device time of the window's kernels: K1's bytes over HBM bandwidth plus
K2's int32 operations over the card's issue rate, for the blocks the
window's dispatches asked for (`roofline/`), against the traced
kernels' time (every kernel and memset, no copy)."""


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0:
        return None
    p = run.roofline["peaks"]
    int_rate = p["int32_lanes_per_sm_cycle"] * p["sms"] * p["sm_clock_hz"]
    least = (run.spans.work["k1_bytes"] / p["hbm_bytes_per_s"]
             + run.spans.work["k2_ops"] / int_rate)
    return 100 * least / run.trace["kernel_s"] if least > 0 else None
