"""Tree-ensemble inference — port of the JAX package's ``models/forest.py``.

Two exact device forms of a depth-bounded forest:

- the **descent form** (:class:`TreeEnsemble`, :func:`ensemble_leaf_values`):
  flat node tables; all B rows × T trees advance one level per step;
- the **GEMM form** (:class:`GemmEnsemble`, :func:`gemm_leaf_sum`): three
  contractions ``proj = x·sel``, ``z = d·path``, leaf gather where
  ``z == target``.

Both are decision-exact against sklearn on float32 inputs, given the
thresholds that :func:`ftz_safe_thresholds` builds. The GEMM form here is
the plain version that the CUDA kernel of the serving path
(``ops/forest_kernels.py``) is held against.

Training stays on the host, as in the JAX package: :func:`fit_forest`
fits sklearn (imported only there) and :func:`ensemble_from_sklearn`
compiles the fitted estimator into the node tables, with thresholds
rounded down to float32 (:func:`_f32_round_down`) so float32 inputs take
sklearn's float64 decisions.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device


class TreeEnsemble(NamedTuple):
    """Flat node tables, padded to (T trees × N nodes). Leaves self-loop."""

    feat: torch.Tensor  # int32 [T, N] — feature index tested at node
    thresh: torch.Tensor  # float32 [T, N] — go left iff x[feat] <= thresh
    left: torch.Tensor  # int32 [T, N] — left child (node itself at leaves)
    right: torch.Tensor  # int32 [T, N]
    prob: torch.Tensor  # float32 [T, N] — P(class 1) at node (leaves used)
    max_depth: int  # trip count of the descent loop

    @property
    def n_trees(self) -> int:
        return int(self.feat.shape[0])

    def to(self, device) -> "TreeEnsemble":
        return TreeEnsemble(*(t.to(device) for t in self[:5]),
                            max_depth=self.max_depth)


class GemmEnsemble(NamedTuple):
    """Matmul ("Hummingbird GEMM") formulation — see :func:`to_gemm`."""

    sel: torch.Tensor  # float32 [T, F, I] one-hot feature selector per node
    thresh: torch.Tensor  # float32 [T, I]
    path: torch.Tensor  # float32 [T, I, L] — +1 left, -1 right, 0 off-path
    target: torch.Tensor  # float32 [T, L] — #left-required per leaf (pad 1e9)
    leaf_val: torch.Tensor  # float32 [T, L]

    @property
    def n_trees(self) -> int:
        return int(self.sel.shape[0])

    def to(self, device) -> "GemmEnsemble":
        return GemmEnsemble(*(t.to(device) for t in self))


def ftz_safe_thresholds(t32: np.ndarray) -> np.ndarray:
    """Replace denormal thresholds with their flush-to-zero-safe stand-in:
    positive denormal → 0.0, negative denormal → -FLT_MIN.

    The JAX package builds its thresholds this way because XLA flushes
    denormals in comparisons; the port keeps the same tables so both
    packages decide alike. The CUDA kernel is built without
    ``-ftz=true``, so it compares denormals as they are: the stand-ins are
    exact whenever the inputs are normals or zero, which the engineered
    features guarantee in practice."""
    t32 = np.asarray(t32, dtype=np.float32).copy()
    tiny = np.float32(np.finfo(np.float32).tiny)
    denorm = (t32 != 0.0) & (np.abs(t32) < tiny)
    t32[denorm & (t32 > 0)] = np.float32(0.0)
    t32[denorm & (t32 < 0)] = -tiny
    return t32


def _f32_round_down(t64: np.ndarray) -> np.ndarray:
    """Round float64 thresholds DOWN to float32 so that for any float32
    input x: (x <= t32) == (x <= t64) — decisions stay bit-identical to
    sklearn on float32 features."""
    t32 = t64.astype(np.float32)
    over = t32.astype(np.float64) > t64
    t32[over] = np.nextafter(t32[over], np.float32(-np.inf), dtype=np.float32)
    return ftz_safe_thresholds(t32)


def ensemble_from_sklearn(model, n_features: int,
                          device=None) -> TreeEnsemble:
    """Compile a fitted sklearn DecisionTree/RandomForest/ExtraTrees into
    flat node tables on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    trees = getattr(model, "estimators_", None)
    if trees is None:
        trees = [model]
    else:
        trees = [t for t in np.asarray(trees).ravel()]

    T = len(trees)
    N = max(t.tree_.node_count for t in trees)
    feat = np.zeros((T, N), dtype=np.int32)
    thresh = np.zeros((T, N), dtype=np.float32)
    left = np.zeros((T, N), dtype=np.int32)
    right = np.zeros((T, N), dtype=np.int32)
    prob = np.zeros((T, N), dtype=np.float32)
    depth = 0
    for ti, est in enumerate(trees):
        tr = est.tree_
        n = tr.node_count
        is_leaf = tr.children_left == -1
        feat[ti, :n] = np.where(is_leaf, 0, tr.feature)
        thresh[ti, :n] = _f32_round_down(np.where(is_leaf, 0.0, tr.threshold))
        idx = np.arange(n, dtype=np.int32)
        left[ti, :n] = np.where(is_leaf, idx, tr.children_left).astype(np.int32)
        right[ti, :n] = np.where(is_leaf, idx,
                                 tr.children_right).astype(np.int32)
        v = tr.value[:, 0, :]  # [n, n_classes] (fractions or counts)
        if v.shape[1] > 1:
            tot = v.sum(axis=1)
            prob[ti, :n] = np.where(tot > 0,
                                    v[:, -1] / np.maximum(tot, 1e-12), 0.0)
        else:
            prob[ti, :n] = v[:, 0]
        depth = max(depth, int(tr.max_depth))
    return TreeEnsemble(*(torch.as_tensor(a, device=device)
                          for a in (feat, thresh, left, right, prob)),
                        max_depth=depth)


def fit_forest(x: np.ndarray, y: np.ndarray, n_trees: int = 100,
               max_depth: int = 8, seed: int = 0, kind: str = "forest",
               device=None) -> TreeEnsemble:
    """Host-side fit (sklearn, imported here; ``random_state=seed``),
    then the node tables on ``device``."""
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.tree import DecisionTreeClassifier

    if kind == "tree":
        clf = DecisionTreeClassifier(max_depth=max_depth, random_state=seed)
    else:
        clf = RandomForestClassifier(n_estimators=n_trees,
                                     max_depth=max_depth, random_state=seed,
                                     n_jobs=-1)
    clf.fit(x, y)
    return ensemble_from_sklearn(clf, x.shape[1], device)


def ensemble_leaf_values(ens: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    """[B, F] → per-tree leaf value [B, T] by level-synchronous descent:
    leaves self-loop, so ``max_depth`` steps land every lane on its leaf."""
    b = x.shape[0]
    t, n = ens.feat.shape
    tree_base = (torch.arange(t, device=x.device) * n)[None, :]  # [1, T]
    feat = ens.feat.reshape(-1).long()
    thresh = ens.thresh.reshape(-1)
    left = ens.left.reshape(-1).long()
    right = ens.right.reshape(-1).long()
    node = torch.zeros((b, t), dtype=torch.long, device=x.device)
    for _ in range(ens.max_depth):
        flat = tree_base + node
        xv = torch.gather(x, 1, feat[flat])
        node = torch.where(xv <= thresh[flat], left[flat], right[flat])
    return ens.prob.reshape(-1)[tree_base + node]


def ensemble_predict_proba(ens: TreeEnsemble, x: torch.Tensor) -> torch.Tensor:
    """[B, F] → fraud probability [B] (bagging: mean of per-tree probs)."""
    return torch.mean(ensemble_leaf_values(ens, x), dim=1)


def to_gemm(ens: TreeEnsemble, n_features: int) -> GemmEnsemble:
    """Compile node tables into the 3-matmul formulation (host numpy).

    Leaf l is reached iff every on-path node decision matches; with the ±1
    path encoding, Z[l] = Σ path[i,l]·D[i] equals target[l] (= #left-required)
    exactly in that case and only then.
    """
    feat = ens.feat.cpu().numpy()
    thresh = ens.thresh.cpu().numpy()
    left = ens.left.cpu().numpy()
    right = ens.right.cpu().numpy()
    prob = ens.prob.cpu().numpy()
    T, N = feat.shape

    per_tree = []
    for t in range(T):
        is_leaf = left[t] == np.arange(N)
        # restrict to reachable nodes of this tree (padding is unreachable)
        internal = []
        leaves = []
        stack = [0]
        seen = set()
        while stack:
            nd = stack.pop()
            if nd in seen:
                continue
            seen.add(nd)
            if is_leaf[nd]:
                leaves.append(nd)
            else:
                internal.append(nd)
                stack.append(int(left[t, nd]))
                stack.append(int(right[t, nd]))
        i_of = {nd: i for i, nd in enumerate(sorted(internal))}
        l_of = {nd: i for i, nd in enumerate(sorted(leaves))}
        I, L = len(internal), len(leaves)
        sel = np.zeros((n_features, max(I, 1)), dtype=np.float32)
        th = np.full(max(I, 1), np.float32(np.inf))
        path = np.zeros((max(I, 1), max(L, 1)), dtype=np.float32)
        target = np.zeros(max(L, 1), dtype=np.float32)
        leaf_val = np.zeros(max(L, 1), dtype=np.float32)
        # iterative root→leaf walk collecting requirements
        stack2 = [(0, [])]
        while stack2:
            nd, req = stack2.pop()
            if is_leaf[nd]:
                li = l_of[nd]
                for i, sign in req:
                    path[i, li] = sign
                target[li] = sum(1 for _, s in req if s > 0)
                leaf_val[li] = prob[t, nd]
            else:
                i = i_of[nd]
                sel[feat[t, nd], i] = 1.0
                th[i] = thresh[t, nd]
                stack2.append((int(left[t, nd]), req + [(i, +1)]))
                stack2.append((int(right[t, nd]), req + [(i, -1)]))
        per_tree.append((sel, th, path, target, leaf_val))

    I = max(p[0].shape[1] for p in per_tree)
    L = max(p[2].shape[1] for p in per_tree)
    F = n_features
    sel = np.zeros((T, F, I), dtype=np.float32)
    th = np.full((T, I), np.float32(np.inf))
    path = np.zeros((T, I, L), dtype=np.float32)
    target = np.full((T, L), 1e9, dtype=np.float32)
    leaf_val = np.zeros((T, L), dtype=np.float32)
    for t, (s, t_, p, tg, lv) in enumerate(per_tree):
        i, l = s.shape[1], p.shape[1]
        sel[t, :, :i] = s
        th[t, :i] = t_
        path[t, :i, :l] = p
        target[t, :l] = tg
        leaf_val[t, :l] = lv
    dev = ens.feat.device
    return GemmEnsemble(*(torch.as_tensor(a, device=dev)
                          for a in (sel, th, path, target, leaf_val)))


def resolve_z_mode(mode: Optional[str], device) -> str:
    """``RuntimeConfig.z_mode`` → a concrete :func:`gemm_leaf_sum` mode.

    ``"auto"`` (and None) picks int8 on CUDA — the smallest path table;
    the serving kernel's z is an exact integer whatever the table dtype —
    and f32 elsewhere. Every mode gives bit-identical leaf sums (integer
    operands, ``|z| <= depth``)."""
    if mode is None or mode == "auto":
        return "int8" if torch.device(device).type == "cuda" else "f32"
    if mode not in ("f32", "bf16", "int8"):
        raise ValueError(f"unknown z_mode {mode!r}")
    return mode


def _require_exact_f32(x: torch.Tensor) -> None:
    """The decision projection must be exact float32: TF32 rounds the
    inputs to 10 mantissa bits and flips decisions near thresholds."""
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "gemm_leaf_sum needs exact float32 products on CUDA: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def gemm_leaf_sum(
    g: GemmEnsemble, x: torch.Tensor, z_mode: Optional[str] = None
) -> torch.Tensor:
    """[B, F] → Σ_t leaf value [B] via three contractions.

    - ``proj`` is exact float32 (TF32 off; see :func:`_require_exact_f32`);
    - the z contraction is exact in every mode — d is 0/1, path is ±1/0,
      z counts ≤ depth:
        * ``"f32"``: float32 products;
        * ``"bf16"``: bfloat16 operands (small integers are exact);
        * ``"int8"``: int8 tables, z compared in int32 against the integer
          target. torch has no integer batched product on CUDA, so the
          product is taken over the int8 values in float32 — exact;
    - the leaf gather keeps ``leaf_val`` in float32, and trees are summed
      in order.
    ``z_mode=None`` resolves as ``"auto"`` on ``x``'s device.
    """
    z_mode = resolve_z_mode(z_mode, x.device)
    _require_exact_f32(x)
    proj = torch.einsum("bf,tfi->bti", x, g.sel)
    d = proj <= g.thresh[None]
    if z_mode == "int8":
        z = torch.einsum("bti,til->btl", d.to(torch.int8).float(),
                         g.path.to(torch.int8).float()).to(torch.int32)
        onehot = (z == g.target.to(torch.int32)[None]).to(torch.float32)
    else:
        zdt = torch.bfloat16 if z_mode == "bf16" else torch.float32
        z = torch.einsum("bti,til->btl", d.to(zdt), g.path.to(zdt))
        onehot = ((z.float() - g.target[None]).abs() < 0.5).to(torch.float32)
    # One matched leaf per tree, so each tree's value is exact; the trees
    # are then added one after another in order — the CUDA kernel's order
    # (csrc/fused_forest.cu), so the two agree bit for bit.
    per_tree = torch.einsum("btl,tl->bt", onehot, g.leaf_val)
    acc = torch.zeros_like(per_tree[:, 0])
    for t in range(per_tree.shape[1]):
        acc = acc + per_tree[:, t]
    return acc


def gemm_predict_proba(
    g: GemmEnsemble, x: torch.Tensor, z_mode: Optional[str] = None
) -> torch.Tensor:
    """[B, F] → probability [B] (bagging mean over trees)."""
    return gemm_leaf_sum(g, x, z_mode) / g.n_trees


def predict_proba(
    params, x: torch.Tensor, z_mode: Optional[str] = None
) -> torch.Tensor:
    """Unified forest scorer: dispatches on the ensemble form (the descent
    form has no contraction and ignores ``z_mode``)."""
    if isinstance(params, GemmEnsemble):
        return gemm_predict_proba(params, x, z_mode)
    return ensemble_predict_proba(params, x)


def for_device(
    ens: TreeEnsemble, n_features: int, max_gemm_bytes: int = 256 * 1024 * 1024
) -> "TreeEnsemble | GemmEnsemble":
    """The GEMM form for depth-bounded forests; unbounded trees, whose
    O(T·N²) path matrix would explode, keep the descent form."""
    t, n = ens.feat.shape
    if 4 * t * n * n <= max_gemm_bytes:
        return to_gemm(ens, n_features)
    return ens


def synthetic_ensemble(
    n_trees: int = 4,
    max_depth: int = 3,
    n_features: int = 15,
    seed: int = 0,
    device=None,
) -> TreeEnsemble:
    """A shape-faithful ensemble with NO training dependency: complete
    binary trees of exactly ``max_depth`` levels with random (but valid)
    feature indices, thresholds and leaf probabilities. The same seed
    gives the same tables as the JAX package's ``synthetic_ensemble``.
    The probabilities are arbitrary: do not score real traffic with it."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    n = 2 ** (max_depth + 1) - 1  # complete binary tree node count
    n_internal = 2 ** max_depth - 1
    idx = np.arange(n, dtype=np.int32)
    is_leaf = idx >= n_internal
    feat = np.where(
        is_leaf[None, :], 0,
        rng.integers(0, n_features, size=(n_trees, n)),
    ).astype(np.int32)
    thresh = np.where(
        is_leaf[None, :], 0.0,
        rng.normal(size=(n_trees, n)),
    ).astype(np.float32)
    left = np.where(is_leaf, idx, idx * 2 + 1).astype(np.int32)
    right = np.where(is_leaf, idx, idx * 2 + 2).astype(np.int32)
    prob = rng.uniform(size=(n_trees, n)).astype(np.float32)
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                     device=device)
    return TreeEnsemble(
        feat=as_t(feat),
        thresh=as_t(ftz_safe_thresholds(thresh)),
        left=as_t(np.broadcast_to(left, (n_trees, n))),
        right=as_t(np.broadcast_to(right, (n_trees, n))),
        prob=as_t(prob),
        max_depth=max_depth,
    )


def ragged_ensemble(
    n_trees: int = 4,
    max_depth: int = 8,
    n_features: int = 15,
    seed: int = 0,
    max_leaves: int = 256,
    device=None,
) -> TreeEnsemble:
    """Irregular trees with NO training dependency, from seeded numpy:
    tree t has a depth d_t in 1..``max_depth`` (the first tree
    ``max_depth``), a spine of random turns down to d_t, and then random
    splits of leaves above d_t until it holds between d_t + 1 and
    min(2**d_t, ``max_leaves``) leaves, so its leaves sit at many depths
    and its shape differs from its neighbours'. Features, thresholds and
    leaf probabilities are random as in :func:`synthetic_ensemble`."""
    device = resolve_device(device)
    if max_leaves < max_depth + 1:
        raise ValueError("max_leaves must exceed max_depth")
    rng = np.random.default_rng(seed)
    trees = []
    for t in range(n_trees):
        d = max_depth if t == 0 else int(rng.integers(1, max_depth + 1))
        n_leaves = int(rng.integers(d + 1, min(2 ** d, max_leaves) + 1))
        left, right, level = [0], [0], [0]
        open_leaves = []  # leaves above depth d

        def split(nd):
            k = len(level)
            left[nd], right[nd] = k, k + 1
            for c in (k, k + 1):
                left.append(c)
                right.append(c)
                level.append(level[nd] + 1)
                if level[c] < d:
                    open_leaves.append(c)

        nd = 0
        for _ in range(d):  # the spine
            split(nd)
            nd = left[nd] if rng.random() < 0.5 else right[nd]
            if nd in open_leaves:
                open_leaves.remove(nd)
        while (len(level) + 1) // 2 < n_leaves:
            j = int(rng.integers(len(open_leaves)))
            open_leaves[j], open_leaves[-1] = open_leaves[-1], open_leaves[j]
            split(open_leaves.pop())
        trees.append((np.array(left), np.array(right)))
    n = max(len(lt) for lt, _ in trees)
    idx = np.arange(n, dtype=np.int32)
    left = np.tile(idx, (n_trees, 1))
    right = left.copy()
    for t, (lt, rt) in enumerate(trees):
        left[t, :len(lt)] = lt
        right[t, :len(rt)] = rt
    is_leaf = left == idx
    feat = np.where(is_leaf, 0, rng.integers(0, n_features, (n_trees, n)))
    thresh = np.where(is_leaf, 0.0, rng.normal(size=(n_trees, n)))
    prob = rng.uniform(size=(n_trees, n))
    as_t = lambda a, dt: torch.as_tensor(  # noqa: E731
        np.ascontiguousarray(a, dtype=dt), device=device)
    return TreeEnsemble(
        feat=as_t(feat, np.int32),
        thresh=as_t(ftz_safe_thresholds(thresh), np.float32),
        left=as_t(left, np.int32),
        right=as_t(right, np.int32),
        prob=as_t(prob, np.float32),
        max_depth=max_depth,
    )
