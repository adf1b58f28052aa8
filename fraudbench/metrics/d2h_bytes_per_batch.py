"""Bytes of results copied from the device to the host in the window,
per batch (the program's ``rtfds_transfer_bytes_total{direction="d2h"}``
over the window, from ``run``'s ``trace`` entry, which only a traced run
has)."""


def read(ctx):
    stats = ctx["stats"]
    moved = stats.get("trace", {}).get("counters", {}).get(
        "transfer_bytes")
    if not moved or not stats["batches"]:
        return None
    return moved["d2h"] / stats["batches"]
