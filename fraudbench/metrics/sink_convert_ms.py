"""Median ms of a batch's column conversion in the sink (the program's
``sink_write/convert`` span: ``MemorySink``'s ``_result_to_columns``),
from ``run``'s ``trace`` entry, which only a traced run has."""


def read(ctx):
    span = ctx["stats"].get("trace", {}).get("spans", {}).get(
        "sink_write/convert")
    return span["median_ms"] if span else None
