"""Share of the window's rows that the sequence step scored through its
fused kernel (``csrc/fused_sequence.cu``): the program's
``rtfds_sequence_rows_scored_total{path}`` over the window, fused over
fused and plain, from ``run``'s ``trace`` entry, which only a traced run
has. A program without the counter gives nothing to read."""


def read(ctx):
    rows = ctx["stats"].get("trace", {}).get("counters", {}).get(
        "sequence_rows_scored")
    total = sum(rows.values()) if rows else 0.0
    return rows.get("fused", 0.0) / total if total > 0 else None
