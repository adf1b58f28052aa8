"""Median ms of a batch's pack in the window (the program's
``host_prep/pack`` span: the native pack into pinned staging), from
``run``'s ``trace`` entry, which only a traced run has."""


def read(ctx):
    span = ctx["stats"].get("trace", {}).get("spans", {}).get(
        "host_prep/pack")
    return span["median_ms"] if span else None
