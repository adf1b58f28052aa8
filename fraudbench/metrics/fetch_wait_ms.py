"""Mean ms the loop waited on a batch's result copies in the window (the
program's ``result_wait/fetch_wait`` span: the synchronize on the copies'
event alone; a leaf, so its self time is its whole time), from ``run``'s
``trace`` entry, which only a traced run has. A mean, not a median: most
batches find their copies landed and a few wait, and the few are what a
change to the wait moves."""


def read(ctx):
    span = ctx["stats"].get("trace", {}).get("spans", {}).get(
        "result_wait/fetch_wait")
    return span["self_ms"] / span["count"] if span else None
