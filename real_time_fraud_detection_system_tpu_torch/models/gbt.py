"""Gradient-boosted trees — port of the JAX package's ``models/gbt.py``.

A boosted ensemble is the forest's node tables with raw leaf scores in
``prob`` (learning rate applied) and an initial logit: the probability is
``sigmoid(base_score + Σ_t leaf score)``.

The trainer is the JAX package's first-party histogram booster, NumPy on
the host in both packages (the same operations in the same order, so the
same data gives bit-identical node tables): features quantile-binned
once, level-wise growth with the logistic loss's Newton leaf weights,

    gain = ½·(GL²/(HL+λ) + GR²/(HR+λ) − G²/(H+λ)),  w* = −G/(H+λ).

:func:`gbt_from_xgboost` imports a fitted ``xgboost.XGBClassifier``
through the pure dump parser :func:`_trees_from_xgb_dump`.
"""

from __future__ import annotations

import json as _json
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    TreeEnsemble,
    _f32_round_down,
    ensemble_leaf_values,
    for_device,
    ftz_safe_thresholds,
    gemm_leaf_sum,
    synthetic_ensemble,
)


class GBTModel(NamedTuple):
    # prob/leaf_val field holds raw leaf scores (lr pre-applied)
    trees: "TreeEnsemble | GemmEnsemble"
    base_score: torch.Tensor  # float32 [] — initial logit

    def to(self, device) -> "GBTModel":
        return GBTModel(self.trees.to(device), self.base_score.to(device))


def gbt_predict_proba(model: GBTModel, x: torch.Tensor,
                      z_mode: Optional[str] = None) -> torch.Tensor:
    if isinstance(model.trees, GemmEnsemble):
        raw = gemm_leaf_sum(model.trees, x, z_mode)
    else:
        raw = torch.sum(ensemble_leaf_values(model.trees, x), dim=1)
    return torch.sigmoid(model.base_score + raw)


def gbt_for_device(model: GBTModel, n_features: int) -> GBTModel:
    """GEMM-form trees where their depth allows it (see ``for_device``)."""
    if isinstance(model.trees, TreeEnsemble):
        return model._replace(trees=for_device(model.trees, n_features))
    return model


def synthetic_gbt(n_trees: int = 4, max_depth: int = 3,
                  n_features: int = 15, seed: int = 0,
                  device=None) -> GBTModel:
    """Shape-faithful GBT with no training dependency: the trees of
    ``synthetic_ensemble`` (the same seed gives the JAX package's tables)
    and a base logit of -2. The leaf scores are arbitrary: do not score
    real traffic with it."""
    device = resolve_device(device)
    return GBTModel(
        trees=synthetic_ensemble(n_trees, max_depth, n_features, seed,
                                 device=device),
        base_score=torch.tensor(-2.0, dtype=torch.float32, device=device),
    )


class _Node(NamedTuple):
    feat: int
    thresh: float
    left: int
    right: int
    value: float


def _bin_features(x: np.ndarray, n_bins: int) -> Tuple[np.ndarray, np.ndarray]:
    """Quantile-bin each feature. Returns (binned uint8 [N,F], edges [F, n_bins-1])."""
    n, f = x.shape
    edges = np.zeros((f, n_bins - 1), dtype=np.float64)
    binned = np.zeros((n, f), dtype=np.int32)
    qs = np.linspace(0, 1, n_bins + 1)[1:-1]
    for j in range(f):
        e = np.unique(np.quantile(x[:, j], qs))
        pad = np.full(n_bins - 1, np.inf)
        pad[: len(e)] = e
        edges[j] = pad
        binned[:, j] = np.searchsorted(e, x[:, j], side="left")
    return binned, edges


def train_gbt(
    x: np.ndarray,
    y: np.ndarray,
    n_trees: int = 100,
    max_depth: int = 5,
    learning_rate: float = 0.1,
    n_bins: int = 64,
    reg_lambda: float = 1.0,
    min_child_weight: float = 1.0,
    gamma: float = 0.0,
    device=None,
) -> GBTModel:
    """Fit the histogram booster on the host (NumPy, float64); the node
    tables and the base logit land on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    n, f = x.shape
    binned, edges = _bin_features(x, n_bins)

    p0 = float(np.clip(y.mean(), 1e-6, 1 - 1e-6))
    base = float(np.log(p0 / (1 - p0)))
    logits = np.full(n, base)

    all_trees = []
    depth_used = 0
    for _ in range(n_trees):
        p = 1.0 / (1.0 + np.exp(-logits))
        g = p - y  # gradient of logistic loss
        h = p * (1.0 - p)  # hessian

        nodes, sample_leaf_value, d = _grow_tree(
            binned, edges, g, h, f, n_bins, max_depth, reg_lambda,
            min_child_weight, gamma, learning_rate,
        )
        depth_used = max(depth_used, d)
        all_trees.append(nodes)
        logits += sample_leaf_value

    # pack into flat node tables
    t = len(all_trees)
    nmax = max(len(tr) for tr in all_trees)
    feat = np.zeros((t, nmax), dtype=np.int32)
    thresh = np.zeros((t, nmax), dtype=np.float32)
    left = np.zeros((t, nmax), dtype=np.int32)
    right = np.zeros((t, nmax), dtype=np.int32)
    prob = np.zeros((t, nmax), dtype=np.float32)
    for ti, tr in enumerate(all_trees):
        for ni, nd in enumerate(tr):
            feat[ti, ni] = nd.feat
            # Round the float64 split edge DOWN to float32 so float32
            # inference reproduces the training-time partition.
            thresh[ti, ni] = _f32_round_down(np.asarray([nd.thresh]))[0]
            left[ti, ni] = nd.left if nd.left >= 0 else ni
            right[ti, ni] = nd.right if nd.right >= 0 else ni
            prob[ti, ni] = nd.value
    trees = TreeEnsemble(*(torch.as_tensor(a, device=device)
                           for a in (feat, thresh, left, right, prob)),
                         max_depth=max(depth_used, 1))
    return GBTModel(trees=trees, base_score=torch.tensor(
        base, dtype=torch.float32, device=device))


def _grow_tree(
    binned: np.ndarray,  # int32 [N, F]
    edges: np.ndarray,  # [F, n_bins-1]
    g: np.ndarray,
    h: np.ndarray,
    f: int,
    n_bins: int,
    max_depth: int,
    lam: float,
    min_child_weight: float,
    gamma: float,
    lr: float,
):
    """Level-wise growth. Returns (node list, per-sample value, depth used)."""
    n = len(g)
    node_of = np.zeros(n, dtype=np.int64)  # current node id per sample
    nodes = [_Node(0, 0.0, -1, -1, 0.0)]  # placeholder root
    frontier = [0]  # node ids at current level
    depth_used = 0

    for depth in range(max_depth):
        if not frontier:
            break
        k = len(frontier)
        remap = -np.ones(len(nodes), dtype=np.int64)
        for i, nid in enumerate(frontier):
            remap[nid] = i
        slot = remap[node_of]  # [-1 for settled samples]
        active = slot >= 0
        # histogram over (active-node-slot, feature, bin)
        idx = (
            slot[active, None] * (f * n_bins)
            + np.arange(f)[None, :] * n_bins
            + binned[active]
        ).ravel()
        size = k * f * n_bins
        gh = np.bincount(idx, weights=np.repeat(g[active], f), minlength=size)
        hh = np.bincount(idx, weights=np.repeat(h[active], f), minlength=size)
        gh = gh.reshape(k, f, n_bins)
        hh = hh.reshape(k, f, n_bins)

        gl = np.cumsum(gh, axis=2)[:, :, :-1]  # left sums per split bin
        hl = np.cumsum(hh, axis=2)[:, :, :-1]
        gt = gh.sum(axis=2, keepdims=True)  # [k, f, 1] (same total per feature)
        ht = hh.sum(axis=2, keepdims=True)
        gr = gt - gl
        hr = ht - hl
        gain = 0.5 * (
            gl**2 / (hl + lam) + gr**2 / (hr + lam) - gt**2 / (ht + lam)
        ) - gamma
        ok = (hl >= min_child_weight) & (hr >= min_child_weight)
        gain = np.where(ok, gain, -np.inf)

        flat = gain.reshape(k, -1)
        best = flat.argmax(axis=1)
        best_gain = flat[np.arange(k), best]
        best_feat = best // (n_bins - 1)
        best_bin = best % (n_bins - 1)

        new_frontier = []
        for i, nid in enumerate(frontier):
            gsum = float(gt[i, 0, 0])
            hsum = float(ht[i, 0, 0])
            if best_gain[i] <= 0 or not np.isfinite(best_gain[i]):
                nodes[nid] = _Node(0, 0.0, -1, -1,
                                   -lr * gsum / (hsum + lam))
                continue
            fj = int(best_feat[i])
            bj = int(best_bin[i])
            lid = len(nodes)
            rid = lid + 1
            nodes[nid] = _Node(fj, float(edges[fj, bj]), lid, rid, 0.0)
            nodes.append(_Node(0, 0.0, -1, -1, 0.0))
            nodes.append(_Node(0, 0.0, -1, -1, 0.0))
            sel = active & (node_of == nid)
            go_left = binned[:, fj] <= bj
            node_of[sel & go_left] = lid
            node_of[sel & ~go_left] = rid
            new_frontier += [lid, rid]
        frontier = new_frontier
        depth_used = depth + 1

    # settle any remaining frontier nodes as leaves
    for nid in frontier:
        sel = node_of == nid
        gsum = float(g[sel].sum())
        hsum = float(h[sel].sum())
        nodes[nid] = _Node(0, 0.0, -1, -1, -lr * gsum / (hsum + lam))

    value_of_node = np.asarray([nd.value for nd in nodes])
    return nodes, value_of_node[node_of], depth_used


def _trees_from_xgb_dump(dumps, n_features: int,
                         device=None) -> TreeEnsemble:
    """Compile xgboost JSON tree dumps into flat node tables.

    Pure parser (no xgboost import), so it is unit-testable on images
    without the dependency. xgboost routes LEFT ("yes") iff
    ``x < split_condition`` (strict); the descent tests
    ``x <= thresh``, so each threshold becomes the largest f32 strictly
    below the stored f32 condition — decisions stay bit-identical for
    f32 inputs. Leaf values are the raw logit contributions (learning
    rate pre-applied by xgboost). The ``missing`` branch is ignored:
    engine features are never NaN.
    """
    device = resolve_device(device)
    parsed = [_json.loads(d) if isinstance(d, str) else d for d in dumps]

    def walk(node, acc, d):
        # derive depth structurally — the "depth" field is not present in
        # every dump variant (leaves omit it)
        acc.append((node, d))
        for ch in node.get("children", ()):
            walk(ch, acc, d + 1)
        return acc

    t = len(parsed)
    all_nodes = [walk(p, [], 0) for p in parsed]
    n = max(max(nd["nodeid"] for nd, _ in nodes) + 1 for nodes in all_nodes)
    feat = np.zeros((t, n), dtype=np.int32)
    thresh = np.zeros((t, n), dtype=np.float32)
    left = np.zeros((t, n), dtype=np.int32)
    right = np.zeros((t, n), dtype=np.int32)
    prob = np.zeros((t, n), dtype=np.float32)
    depth = 1
    # default: every slot self-loops as a zero-valued leaf (unreferenced
    # ids in a sparse dump stay inert)
    idx = np.arange(n, dtype=np.int32)
    left[:] = idx[None, :]
    right[:] = idx[None, :]
    for ti, nodes in enumerate(all_nodes):
        for nd, d in nodes:
            i = int(nd["nodeid"])
            depth = max(depth, d)
            if "leaf" in nd:
                prob[ti, i] = np.float32(nd["leaf"])
                continue
            split = nd["split"]
            if not (isinstance(split, str) and split.startswith("f")
                    and split[1:].isdigit()):
                raise ValueError(
                    f"unsupported split name {split!r}: train on plain "
                    "arrays so xgboost emits f<index> feature names")
            fi = int(split[1:])
            if fi >= n_features:
                raise ValueError(
                    f"split on feature {fi} >= n_features {n_features}")
            feat[ti, i] = fi
            # strict-< emulation under the kernel's <= test
            thresh[ti, i] = np.nextafter(
                np.float32(nd["split_condition"]), np.float32(-np.inf),
                dtype=np.float32)
            left[ti, i] = int(nd["yes"])
            right[ti, i] = int(nd["no"])
    # nextafter below a condition of exactly 0.0 yields a denormal:
    # map denormal thresholds to their flush-to-zero-safe stand-ins, as
    # the JAX package does, so both packages hold the same tables.
    thresh = ftz_safe_thresholds(thresh)
    return TreeEnsemble(*(torch.as_tensor(a, device=device)
                          for a in (feat, thresh, left, right, prob)),
                        # deepest leaf level = descent trip count
                        max_depth=max(depth, 1))


def gbt_from_xgboost(model, n_features: int, device=None) -> GBTModel:
    """Serve a fitted ``xgboost.XGBClassifier`` through the port's GBT path.

    The reference trains XGBoost as one of its 5 classifiers
    (``model_training.ipynb · cell 50``); this imports the fitted model
    into the same flat-table inference the first-party booster uses
    (``gbt_predict_proba`` — leaf-sum + base logit + sigmoid), so a
    reference user's existing model artifact serves unchanged. Binary
    logistic objectives only. Raises ``ImportError`` without xgboost.
    """
    import xgboost  # noqa: F401  (the model's own package)

    device = resolve_device(device)
    booster = model.get_booster()
    cfg = _json.loads(booster.save_config())
    objective = (cfg.get("learner", {}).get("objective", {})
                 .get("name", "binary:logistic"))
    if not str(objective).startswith("binary:logistic"):
        raise ValueError(
            f"only binary:logistic models import cleanly, got {objective}")
    p0 = float(cfg["learner"]["learner_model_param"]["base_score"])
    base = float(np.log(p0 / (1.0 - p0))) if 0.0 < p0 < 1.0 else 0.0
    trees = _trees_from_xgb_dump(
        booster.get_dump(dump_format="json"), n_features, device)
    return GBTModel(trees=trees, base_score=torch.tensor(
        base, dtype=torch.float32, device=device))
