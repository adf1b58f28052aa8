"""The forest on the tiered store: its weights from the seed, the
program's engine for a configuration file, the comparison with the plain
reference, and its counts."""

from __future__ import annotations

import numpy as np
import torch

from fraudbench.counts.leaf_sum import leaf_sum_counts
from fraudbench.counts.step import forest_ops_per_row
from fraudbench.kinds.common import port_config, weight_generator
from fraudbench.reference.forest import forest_probs
from fraudbench.reference.tiered_store import features as ref_features

# the 15 features, in the order the reference and the sink's columns
# give them
FEATURE_COLUMNS = (
    "tx_amount", "tx_during_weekend", "tx_during_night",
    "customer_id_nb_tx_1day_window", "customer_id_avg_amount_1day_window",
    "customer_id_nb_tx_7day_window", "customer_id_avg_amount_7day_window",
    "customer_id_nb_tx_30day_window", "customer_id_avg_amount_30day_window",
    "terminal_id_nb_tx_1day_window", "terminal_id_risk_1day_window",
    "terminal_id_nb_tx_7day_window", "terminal_id_risk_7day_window",
    "terminal_id_nb_tx_30day_window", "terminal_id_risk_30day_window",
)
FLT_MIN = np.finfo(np.float32).tiny
# a score is the float32 mean of 100 leaves in [0, 1): rounding moves it
# by a few 1e-8; one tree on another branch moves it by up to 1e-2
SCORE_TOL = 1e-6


def make_trees(model: dict, seed: int, device) -> dict:
    """Complete binary trees of ``max_depth`` levels with random feature
    indices, N(0, 1) thresholds and U[0, 1) leaf probabilities: the
    shapes of ``models/forest.py::synthetic_ensemble``, drawn on
    ``device`` from the seed (denormal thresholds replaced by their
    flush-safe stand-ins, +0 and -FLT_MIN, as that maker does)."""
    gen = weight_generator(seed, device)
    t, d, f = model["n_trees"], model["max_depth"], model["n_features"]
    n = 2 ** (d + 1) - 1
    idx = torch.arange(n, dtype=torch.int32, device=device)
    leaf = idx >= 2 ** d - 1
    feat = torch.where(leaf, 0, torch.randint(0, f, (t, n), generator=gen,
                                              device=device,
                                              dtype=torch.int32))
    thresh = torch.where(leaf, 0.0, torch.randn((t, n), generator=gen,
                                                device=device))
    tiny = (thresh != 0) & (thresh.abs() < FLT_MIN)
    thresh = torch.where(tiny & (thresh > 0), 0.0, thresh)
    thresh = torch.where(tiny & (thresh < 0), -FLT_MIN, thresh)
    prob = torch.rand((t, n), generator=gen, device=device)
    left = torch.where(leaf, idx, 2 * idx + 1).expand(t, n).contiguous()
    right = torch.where(leaf, idx, 2 * idx + 2).expand(t, n).contiguous()
    return {"feat": feat.to(torch.int32), "thresh": thresh, "left": left,
            "right": right, "prob": prob, "max_depth": d}


class Kind:
    """``kind: forest`` configurations."""

    def __init__(self, cfg: dict, traffic, stream, seed: int, device,
                 registry, stream_rows):
        from real_time_fraud_detection_system_tpu_torch.models.forest import (
            TreeEnsemble,
        )
        from real_time_fraud_detection_system_tpu_torch.models.scaler import (
            Scaler,
        )
        from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
            ScoringEngine,
        )

        self.cfg = cfg
        self.fcfg = cfg["features"]
        self.model = cfg["model"]
        self.device = device
        self.trees = make_trees(self.model, seed, device)
        self.mean, self.scale = self._scaler(traffic, stream_rows)
        ens = TreeEnsemble(
            feat=self.trees["feat"], thresh=self.trees["thresh"],
            left=self.trees["left"], right=self.trees["right"],
            prob=self.trees["prob"], max_depth=self.model["max_depth"])
        self.engine = ScoringEngine(
            port_config(cfg), kind="forest", params=ens,
            scaler=Scaler(self.mean.clone(), self.scale.clone()),
            device=device, metrics=registry)

    def _scaler(self, traffic, stream_rows):
        """Mean and standard deviation (zero-variance columns 1) of the
        owed features of rows of the last warm batch, every key taken as
        held since the stream's start: the standardization both sides
        are handed."""
        g = traffic.warm_batches - 1
        rows = min(4096, traffic.batch_rows)
        sample = {"g": torch.full((rows,), g, dtype=torch.int64,
                                  device=self.device),
                  "i": torch.arange(rows, device=self.device)}
        x = ref_features(stream_rows(g), sample, self.fcfg, [(0, g)],
                         simulate=False)["features"]
        mean = x.mean(0)
        std = x.std(0, unbiased=False)
        std = torch.where(std > 0, std, torch.ones_like(std))
        return mean.to(torch.float32), std.to(torch.float32)

    def release(self) -> None:
        self.engine = None

    # -- counts ----------------------------------------------------------

    def ops_per_row(self) -> int:
        f = self.fcfg
        return forest_ops_per_row(f["n_day_buckets"], len(f["windows"]),
                                  self.model["n_features"],
                                  self.model["n_trees"],
                                  self.model["max_depth"])

    def kernel_counts(self, rows: int) -> dict:
        return {"leaf_sum": leaf_sum_counts(
            rows, self.model["n_features"], self.model["n_trees"],
            self.model["max_depth"])}

    # -- the comparison --------------------------------------------------

    def compare(self, got: dict, sample: dict, runs, stream_rows,
                tiers: dict, control: bool = False) -> dict:
        """The numbers compared: ``feat_gap`` (the widest gap of a sampled
        row's feature, as a share of the owed value or of 1 where that is
        smaller), ``prob_mismatch_share`` (the share of sampled rows whose
        score is off the reference's by more than ``SCORE_TOL``: a tree
        that took another branch) and ``tier_gap`` (rows answered by the
        hot tier and by the sketch over the window, against the
        reference's counts). ``control`` puts the reference in bfloat16
        in the program's place."""
        ref = ref_features(stream_rows(runs[-1][1]), sample, self.fcfg,
                           runs)
        x = ref["features"]
        p = forest_probs(x, self.mean, self.scale, self.trees)
        if control:
            g_x = x.to(torch.float32).to(torch.bfloat16).to(torch.float64)
            g_p = forest_probs(x, self.mean, self.scale, self.trees,
                               dtype=torch.bfloat16)
            g_tiers = {"dense": ref["dense_rows"], "cms": ref["cms_rows"]}
        else:
            g_x, g_p, g_tiers = got["features"], got["probs"], tiers
        feat_gap = ((g_x - x).abs() / x.abs().clamp(min=1.0)).max()
        return {
            "feat_gap": float(feat_gap),
            "prob_mismatch_share": float(
                ((g_p - p).abs() > SCORE_TOL).double().mean()),
            "tier_gap": float(abs(g_tiers["dense"] - ref["dense_rows"])
                              + abs(g_tiers["cms"] - ref["cms_rows"])),
        }
