"""The 95th percentile over every row of the untraced window (the one a
``--trace 1`` run serves before its traced one) of the time from the
poll that returned the row to the engine to its score's landing in the
sink (host clock). The replay saturates the engine, so the tail is a
reading of the serving loop, not of the end to end."""


def read(ctx):
    w = ctx["untraced"]
    if not len(w["latency_ms"]):
        return None
    return ctx["quantile"](w["latency_ms"], w["latency_rows"], 0.95)
