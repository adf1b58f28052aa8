"""Median ms the loop waited for a batch's result copies in the window
(``stage_ms_p50.result_wait``)."""


def read(ctx):
    return ctx["stats"]["stage_ms_p50"]["result_wait"] or None
