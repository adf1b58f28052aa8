"""Median ms of a batch's dispatch in the window (``stage_ms_p50.
dispatch``: the host-to-device copy, the graph's replay, the result
copies' issue)."""


def read(ctx):
    return ctx["stats"]["stage_ms_p50"]["dispatch"] or None
