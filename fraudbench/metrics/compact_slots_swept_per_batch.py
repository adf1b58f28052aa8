"""Hot-tier slots recency compaction read in the window, per batch (the
program's ``rtfds_feature_compact_slots_swept_total`` over the window,
from ``run``'s ``trace`` entry, which only a traced run has)."""


def read(ctx):
    stats = ctx["stats"]
    swept = stats.get("trace", {}).get("counters", {}).get(
        "compact_slots_swept")
    if not swept or not stats["batches"]:
        return None
    return sum(swept.values()) / stats["batches"]
