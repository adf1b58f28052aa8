"""Mean device ms of one recency compaction in the window (the program's
``device/compact`` track: from the captured graph's first node to an
event behind its last kernel), from ``run``'s ``trace`` entry, which only a
traced run on the card has."""


def read(ctx):
    dev = ctx["stats"].get("trace", {}).get("device", {}).get(
        "device/compact")
    return dev["mean_ms"] if dev else None
