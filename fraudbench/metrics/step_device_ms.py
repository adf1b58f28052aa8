"""Median device ms of one step in the window (the program's
``device/step`` track: from the captured graph's first kernel to an event
behind its last, after the host-to-device copy), from ``run``'s ``trace``
entry, which only a traced run on the card has. Listed for the sequence
cell alone (``.seq``): in the profiled window a graph launched onto an
idle stream has its kernels spread over the launch, so a forest step's
span there holds launch time (9.4-11 ms against 5.5 of kernels)."""


def read(ctx):
    dev = ctx["stats"].get("trace", {}).get("device", {}).get("device/step")
    return dev["median_ms"] if dev else None
