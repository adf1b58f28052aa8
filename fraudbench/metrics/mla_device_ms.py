"""Median device ms a step spends in DeepSeek-V2's latent attention, all
its layers' from the q and kv_a projections to W_o (the program's
``device/mla`` track: stamps of the card's clock that each step returns
with its outputs, summed per step), from ``run``'s ``trace`` entry, which
only a traced run on the card has. A program without the span gives
nothing to read."""


def read(ctx):
    dev = ctx["stats"].get("trace", {}).get("device", {}).get("device/mla")
    return dev["median_ms"] if dev else None
