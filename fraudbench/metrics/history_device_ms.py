"""Device milliseconds per step of the traced window: the union of every
operation the card ran (the history step's sorts, gathers and scatters,
the transformer, the copies) over the window's steps."""


def read(ctx):
    red = ctx["trace"]
    if red is None or red["busy_s"] <= 0 or not ctx["batches"]:
        return None
    return 1e3 * red["busy_s"] / ctx["batches"]
