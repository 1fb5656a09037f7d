"""Share, in %, of the card's least time for the repair's coding work
in the device time of the window's kernels: K1's bytes over HBM
bandwidth, for the verification's reconstructions and the rebuilt
pieces the rounds asked for (`roofline/`), against the traced kernels'
time (every kernel and memset, no copy)."""


def read(run):
    if run.trace is None or run.trace["kernel_s"] <= 0:
        return None
    least = run.spans.work["k1_bytes"] / run.roofline["peaks"]["hbm_bytes_per_s"]
    return 100 * least / run.trace["kernel_s"] if least > 0 else None
