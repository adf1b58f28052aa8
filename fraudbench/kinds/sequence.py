"""The sequence scorer over per-card histories: its weights from the
seed, the program's engine for a configuration file, the comparison with
the plain reference, and its counts."""

from __future__ import annotations

import math

import torch

from fraudbench.counts.step import transformer_ops_per_row
from fraudbench.kinds.common import port_config, weight_generator
from fraudbench.reference.hashing import fold_key
from fraudbench.reference.sequence import histories, sequence_probs

BLOCK_LEAVES = ("ln1_g", "ln1_b", "wq", "wk", "wv", "wo", "ln2_g", "ln2_b",
                "w1", "b1", "w2", "b2")


def make_params(model: dict, seed: int, device) -> dict:
    """The transformer's leaves by name (``b<i>.<leaf>`` for block i),
    drawn on ``device`` from the seed at the shapes and scales of
    ``models/sequence.py::init_transformer``: dense weights N(0, 1) times
    ``1/sqrt(fan_in)`` (the attention projections ``1/sqrt(d_model)``),
    norms' gains 1, biases 0."""
    gen = weight_generator(seed, device)
    d, h, f = model["d_model"], model["n_heads"], model["d_ff"]
    n_in, dh = model["n_in"], model["d_model"] // model["n_heads"]

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[0])
        return torch.randn(shape, generator=gen, device=device) * scale

    def ones(n):
        return torch.ones(n, device=device)

    def zeros(n):
        return torch.zeros(n, device=device)

    p = {"embed_w": dense((n_in, d), 1 / math.sqrt(n_in)),
         "head_w": dense((d, 1))}
    s = 1 / math.sqrt(d)
    for i in range(model["n_layers"]):
        blk = {"ln1_g": ones(d), "ln1_b": zeros(d),
               "wq": dense((d, h, dh), s), "wk": dense((d, h, dh), s),
               "wv": dense((d, h, dh), s), "wo": dense((h, dh, d), s),
               "ln2_g": ones(d), "ln2_b": zeros(d),
               "w1": dense((d, f)), "b1": zeros(f),
               "w2": dense((f, d)), "b2": zeros(d)}
        p.update({f"b{i}.{k}": v for k, v in blk.items()})
    p.update(embed_b=zeros(d), lnf_g=ones(d), lnf_b=zeros(d),
             head_b=zeros(1))
    return p


class Kind:
    """``kind: sequence`` configurations."""

    def __init__(self, cfg: dict, traffic, stream, seed: int, device,
                 registry, stream_rows):
        from real_time_fraud_detection_system_tpu_torch.models.scaler import (
            Scaler,
        )
        from real_time_fraud_detection_system_tpu_torch.models.sequence import (  # noqa: E501
            BlockParams,
            TransformerParams,
        )
        from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
            ScoringEngine,
        )

        self.cfg = cfg
        self.model = cfg["model"]
        self.device = device
        self.params = make_params(self.model, seed, device)
        p = self.params
        blocks = tuple(
            BlockParams(*[p[f"b{i}.{k}"].clone() for k in BLOCK_LEAVES])
            for i in range(self.model["n_layers"]))
        tp = TransformerParams(
            embed_w=p["embed_w"].clone(), embed_b=p["embed_b"].clone(),
            blocks=blocks, lnf_g=p["lnf_g"].clone(),
            lnf_b=p["lnf_b"].clone(), head_w=p["head_w"].clone(),
            head_b=p["head_b"].clone())
        n_feat = 15  # the engine's emitted schema (zeros for this kind)
        self.engine = ScoringEngine(
            port_config(cfg), kind="sequence", params=tp,
            scaler=Scaler(torch.zeros(n_feat, device=device),
                          torch.ones(n_feat, device=device)),
            device=device, metrics=registry)

    def release(self) -> None:
        self.engine = None

    def ops_per_row(self) -> int:
        m = self.model
        return transformer_ops_per_row(
            m["n_in"], m["d_model"], m["n_heads"], m["n_layers"], m["d_ff"],
            self.cfg["features"]["history_len"])

    def kernel_counts(self, rows: int) -> dict:
        return {}

    def compare(self, got: dict, sample: dict, runs, stream_rows,
                tiers: dict, control: bool = False) -> dict:
        """``prob_gap``: the widest gap of a sampled row's score from the
        reference's. ``control`` puts the reference in bfloat16 in the
        program's place."""
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
                               s["amount"], row,
                               self.cfg["features"]["history_len"])
        del s, cust, batch
        n_layers = self.model["n_layers"]
        p = sequence_probs(self.params, ev, length, n_layers)
        g_p = (sequence_probs(self.params, ev, length, n_layers,
                              dtype=torch.bfloat16) if control
               else got["probs"])
        return {"prob_gap": float((g_p - p).abs().max())}
