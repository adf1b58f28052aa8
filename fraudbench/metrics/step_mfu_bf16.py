"""The whole step's share of the card's bfloat16 tensor-core peak: the
configuration's operations per scored row (``counts/dsv2.py``) times the
rows landed in the untraced window, over that window's seconds times
989.4 TFLOP/s, the H100 SXM's dense bfloat16 rate (NVIDIA's data sheet).
A traced run serves the untraced window before the traced one, so the
profiler's cost does not enter."""

BF16_OPS_PER_S = 989.4e12


def read(ctx):
    w = ctx["untraced"]
    if w["window_s"] <= 0 or not w["rows"]:
        return None
    ops = ctx["kind"].ops_per_row() * w["rows"]
    return 100.0 * ops / (w["window_s"] * BF16_OPS_PER_S)
