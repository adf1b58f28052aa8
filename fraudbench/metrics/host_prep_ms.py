"""Median ms of a batch's host prep in the window (``stage_ms_p50.
host_prep``: dedup, validation, the native pack into pinned staging)."""


def read(ctx):
    return ctx["stats"]["stage_ms_p50"]["host_prep"] or None
