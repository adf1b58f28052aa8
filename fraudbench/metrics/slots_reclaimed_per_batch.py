"""Hot-tier slots that recency compaction reclaimed in the window, per
batch (``rtfds_feature_slots_reclaimed_total`` over the window)."""


def read(ctx):
    if ctx["after"]["tier.dense"] is None or not ctx["batches"]:
        return None
    key = "rtfds_feature_slots_reclaimed_total"
    return (ctx["after"][key] - ctx["before"][key]) / ctx["batches"]
