"""Share of the window's row × key-space reads that the hot tier
answered (``rtfds_feature_tier_rows_total{tier}`` over the window)."""


def read(ctx):
    b, a = ctx["before"], ctx["after"]
    if a["tier.dense"] is None:
        return None
    dense = a["tier.dense"] - (b["tier.dense"] or 0.0)
    cms = a["tier.cms"] - (b["tier.cms"] or 0.0)
    return dense / (dense + cms) if dense + cms > 0 else None
