"""Median ms of a batch's dedup in the window (the program's
``host_prep/dedup`` span: the latest-wins mask and the filter of every
column), from ``run``'s ``trace`` entry, which only a traced run has."""


def read(ctx):
    span = ctx["stats"].get("trace", {}).get("spans", {}).get(
        "host_prep/dedup")
    return span["median_ms"] if span else None
