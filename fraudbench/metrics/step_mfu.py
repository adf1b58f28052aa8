"""The whole step's share of the card's float32 peak (67 TFLOP/s outside
the tensor cores): the configuration's operations per scored row
(``counts/step.py``) times the rows landed in the untraced window, over
that window's seconds (a traced run serves it before the traced one, so
the profiler's cost on the host does not enter)."""


def read(ctx):
    from fraudbench.counts.leaf_sum import F32_OPS_PER_S

    w = ctx["untraced"]
    if w["window_s"] <= 0 or not w["rows"]:
        return None
    ops = ctx["kind"].ops_per_row() * w["rows"]
    return 100.0 * ops / (w["window_s"] * F32_OPS_PER_S)
