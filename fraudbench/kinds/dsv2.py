"""DeepSeek-V2's block as the sequence scorer (``kind: dsv2``): its
weights from the seed, the program's engine for a configuration file, the
comparison with the plain reference, and its counts.

The weights are drawn here, by the reference's names and shapes
(``reference/deepseek_v2.py::leaf_shapes``); the reference computes from
the float32 draw and the program serves its bfloat16 cast. The model is
the program's (``models/deepseek_v2.py``: the served params from the
weights by name, the forward), imported from the program when the kind is
built; the kind holds no model code, so a program without the model
cannot serve the cell.
"""

from __future__ import annotations

import math

import torch

from fraudbench.counts.dsv2 import ops_per_row
from fraudbench.kinds.common import port_config, weight_generator
from fraudbench.reference.deepseek_v2 import leaf_shapes, probs
from fraudbench.reference.hashing import fold_key
from fraudbench.reference.sequence import histories

# the configuration file's groups; every other key is the published
# config.json's (``model`` overrides them: the CPU tests' small sizes)
GROUPS = ("name", "kind", "source", "precision", "features", "runtime",
          "model", "reduced", "published", "cut", "guarantees", "assumed")


def model_settings(cfg: dict) -> dict:
    """The model's settings: the file's published keys, ``model`` over
    them."""
    return {**{k: v for k, v in cfg.items() if k not in GROUPS},
            **cfg["model"]}


def _stream_events(stream_rows, g_last: int, device) -> torch.Tensor:
    """float64 [n, channels]: the event channels of every stream row up
    to batch ``g_last``, each at its own place in its card's history
    (the Δt since the card's event before it)."""
    s = stream_rows(g_last)
    cust = fold_key(s["customer_id"])
    batch = torch.arange(g_last + 1, device=device) \
        .repeat_interleave(s["batch_rows"])
    rows = torch.arange(cust.shape[0], device=device)
    ev, length = histories(cust, batch, s["tod_s"], s["day"], s["amount"],
                           rows, 2)
    return ev[rows, length - 1]


def make_leaves(model: dict, seed: int, device,
                events: torch.Tensor) -> dict:
    """float32 weights by ``leaf_shapes``' names, drawn on ``device``
    from the seed: N(0, 1) times ``1/sqrt(fan_in)`` (fan_in the
    next-to-last dimension), norm gains 1.

    The event embedding then takes each channel centred and scaled by
    its mean and standard deviation over ``events`` [n, channels], as a
    trained scorer's first layer would, with a bias of 0 (as the small
    scorer's biases are, ``kinds/sequence.py``): channel i's row over its
    deviation, and the constant channel's row (1 at every real position,
    so the embedding's bias) minus the sum of mean_i / deviation_i times
    row i. Raw, the log-amount and constant channels give every position
    nearly the same hidden state, and the router sends nearly every
    position to the same six experts."""
    gen = weight_generator(seed, device)
    out = {}
    for name, shape in leaf_shapes(model).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=gen, device=device) \
                / math.sqrt(shape[-2])
    mean = events.mean(0)
    std = events.std(0)
    const = std == 0
    if int(const.sum()) != 1 or not bool((events[:, const] == 1).all()):
        raise ValueError("expected one constant channel, 1 at every event")
    w = out["embed_w"].double()
    scale = torch.where(const, torch.ones_like(std), std)
    shift = torch.where(const, torch.zeros_like(mean), mean / scale)
    folded = w / scale[:, None]
    folded[const] = -(shift[:, None] * w).sum(0)
    out["embed_w"] = folded.float()
    return out


class Kind:
    """``kind: dsv2`` configurations."""

    def __init__(self, cfg: dict, traffic, stream, seed: int, device,
                 registry, stream_rows):
        from real_time_fraud_detection_system_tpu_torch.models.deepseek_v2 \
            import DSV2Config, params_from_leaves
        from real_time_fraud_detection_system_tpu_torch.models.scaler import (
            Scaler,
        )
        from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
            ScoringEngine,
        )

        self.cfg = cfg
        self.model = model_settings(cfg)
        self.device = device
        self.k = cfg["features"]["history_len"]
        # the float32 draw, kept for the check; the program serves its
        # bfloat16 cast (float32 where ``model`` says so: the CPU tests'
        # planted faults, which bfloat16 at a small width would hide)
        self.leaves = make_leaves(
            self.model, seed, device,
            _stream_events(stream_rows, traffic.warm_batches - 1, device))
        served = getattr(torch, self.model.get("served_dtype", "bfloat16"))
        params = params_from_leaves(DSV2Config.from_dict(self.model),
                                    self.leaves, served)
        n_feat = 15  # the engine's emitted schema (zeros for this kind)
        self.engine = ScoringEngine(
            port_config(cfg), kind="sequence", params=params,
            scaler=Scaler(torch.zeros(n_feat, device=device),
                          torch.ones(n_feat, device=device)),
            device=device, metrics=registry)

    def release(self) -> None:
        self.engine = None

    def ops_per_row(self) -> int:
        return ops_per_row(self.model, self.k)

    def kernel_counts(self, rows: int) -> dict:
        return {}

    def compare(self, got: dict, sample: dict, runs, stream_rows,
                tiers: dict, control: bool = False) -> dict:
        """``prob_gap``: the widest gap of a sampled row's score from the
        reference's (float32). ``control`` puts the reference with every
        product's inputs in float8 e4m3 in the program's place."""
        g_last = runs[-1][1]
        s = stream_rows(g_last)
        r = s["batch_rows"]
        cust = fold_key(s["customer_id"])
        cap = self.cfg["features"]["customer_capacity"]
        if int(cust.max()) >= cap:
            raise ValueError("direct keys past the capacity share a history")
        batch = torch.arange(g_last + 1, device=self.device) \
            .repeat_interleave(r)
        row = sample["g"] * r + sample["i"]
        ev, length = histories(cust, batch, s["tod_s"], s["day"],
                               s["amount"], row, self.k)
        del s, cust, batch
        p = probs(self.model, self.leaves, ev, length)
        g_p = (probs(self.model, self.leaves, ev, length, quant=True)
               if control else got["probs"])
        return {"prob_gap": float((g_p - p).abs().max())}
