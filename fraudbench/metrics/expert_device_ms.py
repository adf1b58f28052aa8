"""Median device ms a step spends in DeepSeek-V2's expert layers, from
the router to the combine with the shared experts (the program's
``device/experts`` track: stamps of the card's clock that each step
returns with its outputs, summed per step), from ``run``'s ``trace``
entry, which only a traced run on the card has. A program without the
span gives nothing to read."""


def read(ctx):
    dev = ctx["stats"].get("trace", {}).get("device", {}).get(
        "device/experts")
    return dev["median_ms"] if dev else None
