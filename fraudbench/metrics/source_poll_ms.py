"""Median ms of a source poll in the window (``ScoringEngine.run``'s
``stage_ms_p50.source_poll``: the port's ``ReplaySource``)."""


def read(ctx):
    return ctx["stats"]["stage_ms_p50"]["source_poll"] or None
