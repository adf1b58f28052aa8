"""Rows scored and landed in the sink during the window, over the
window's seconds (host clock: from the window's start to the return of
``run``, once every batch in flight has landed)."""


def read(ctx):
    return ctx["rows"] / ctx["window_s"] if ctx["window_s"] > 0 else None
