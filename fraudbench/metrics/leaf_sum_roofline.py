"""The leaf sum's share of its roofline: the least time of one launch
on the bucket (``counts/leaf_sum.py``: the larger of its bytes at
3.35 TB/s and its operations at 67 T/s) over its mean device time per
launch in the traced window."""


def read(ctx):
    red, counts = ctx["trace"], ctx["kernel_counts"].get("leaf_sum")
    if red is None or counts is None:
        return None
    hits = [v for k, v in red["ops"].items() if "leaf_sum_kernel" in k]
    s, n = sum(v["s"] for v in hits), sum(v["n"] for v in hits)
    if not n or s <= 0:
        return None
    return 100.0 * counts["bound_s"] / (s / n)
