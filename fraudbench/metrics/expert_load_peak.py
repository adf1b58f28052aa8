"""How unevenly DeepSeek-V2's router loads its experts in the traced
window: per expert layer the busiest expert's token-slots over the mean
of the layer's experts, the worst layer's (1 is even). From the
program's ``rtfds_sequence_expert_slots_total``, in ``run``'s ``trace``
entry as ``counters.expert_slots`` (layer → one count per expert), which
only a traced run has. A program without the counter gives nothing to
read."""


def read(ctx):
    layers = ctx["stats"].get("trace", {}).get("counters", {}).get(
        "expert_slots")
    peaks = [max(c) * len(c) / sum(c) for c in (layers or {}).values()
             if c and sum(c) > 0]
    return max(peaks) if peaks else None
