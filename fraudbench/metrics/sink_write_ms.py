"""Median ms of a batch's sink append in the window (``stage_ms_p50.
sink_write``: the port's ``MemorySink``)."""


def read(ctx):
    return ctx["stats"]["stage_ms_p50"]["sink_write"] or None
