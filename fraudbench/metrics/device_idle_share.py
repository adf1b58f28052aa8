"""Share of the traced window in which the card ran no operation: one
minus the union of its operations' intervals over the window."""


def read(ctx):
    red = ctx["trace"]
    if red is None or red["busy_s"] <= 0 or red["window_s"] <= 0:
        return None
    return 1.0 - red["busy_s"] / red["window_s"]
