"""The forest kernels: table prep, admission, plain versions and the CUDA
wrappers.

Counterpart of the JAX package's ``ops/pallas_forest.py``, whose two
kernels share one traversal core. The kernels here are CUDA C++ for
Hopper and share one tree walk (``csrc/forest_walk.cuh``); each source's
header says what it computes, what bounds it and what its design does
about that.

- :func:`to_kernel_tables` is the counterpart of ``to_pallas``: it pads a
  :class:`~..models.forest.GemmEnsemble` the same way (T → ×10, F → ×8,
  I and L → ×128, with the same inert padding: ``thresh=+inf``,
  ``target=1e9``, zero leaves) for the plain version, and derives from the
  dense tables the kernels' descent form: per tree, a node table in
  breadth-first order (feature, threshold, two children; a leaf loops to
  itself and carries its value) and the tree's depth.
- :func:`admit_tables` is the counterpart of ``admit_block``: a static
  predicate on the ensemble's shapes, sized by :func:`smem_bytes` in
  shared-memory bytes, for both kernels (they have one block layout).
- :func:`fused_forest_leaf_sum` (``csrc/fused_forest.cu``, replacing
  ``fused_forest_leaf_sum``): state tables and slots → features → Σ_t
  leaf value. Its plain version is the literal composition of
  ``gather_feature_rows``, ``assemble_features``, ``transform`` and
  ``gemm_leaf_sum``; the kernel reads the rows by slot itself.
- :func:`leaf_sum` (``csrc/leaf_sum.cu``, replacing ``pallas_leaf_sum``):
  scaled features → Σ_t leaf value, for gbt. Its plain version is
  ``gemm_leaf_sum`` on the padded tables.

Each wrapper runs its plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises, and counts the launches on itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    gemm_leaf_sum,
)
from real_time_fraud_detection_system_tpu_torch.models.gbt import GBTModel
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.ops.cuda_lib import (
    CSRC,
    check_tensor,
    count_launch,
    load_library,
)
from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
    assemble_features,
    check_feature_inputs,
    check_slots,
    gather_feature_rows,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
)

# Tree-count padding multiple, kept from the TPU layout so both packages
# pad an ensemble alike.
TREE_BLOCK = 10
# Rows (threads) per CUDA block of both kernels; kForestRows in
# csrc/forest_walk.cuh.
BLOCK_ROWS = 128
# Trees each thread of the kernels walks at once; kTreesInFlight in
# csrc/forest_walk.cuh. It divides TREE_BLOCK.
TREES_IN_FLIGHT = 10
# The most shared memory a block may opt in to on sm_90 (227 KB). A block
# holds only the scaled feature tile (8 KB at 15 features).
SMEM_BUDGET = 227 * 1024
MAX_WINDOWS = 4
_NO_TARGET = 1_000_000_000  # padded leaves' target; never matched

SOURCE = CSRC / "fused_forest.cu"
LEAF_SUM_SOURCE = CSRC / "leaf_sum.cu"


def _ceil_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class ForestTables(NamedTuple):
    """A forest in the kernels' layout (see :func:`to_kernel_tables`)."""

    gemm: GemmEnsemble  # padded dense tables; path in the z dtype
    nodes: torch.Tensor  # int32 [Tp, N, 4], breadth-first from the root:
    #                      feature, threshold bits, left, right; a leaf is
    #                      (0, value bits, itself, itself)
    depth: torch.Tensor  # int32 [Tp]: trip count of each tree's descent
    n_trees: int  # REAL tree count (bagging divisor)
    z_mode: str


_Z_DTYPES = {"bf16": torch.bfloat16, "int8": torch.int8,
             "f32": torch.float32}


def padded_shape(g: GemmEnsemble) -> Tuple[int, int, int, int]:
    """(Tp, Fp, Ip, Lp) of the kernel layout, from shapes alone."""
    t, f, i = g.sel.shape
    l = g.path.shape[2]
    return (_ceil_to(int(t), TREE_BLOCK), _ceil_to(int(f), 8),
            _ceil_to(int(i), 128), _ceil_to(int(l), 128))


def _descent_tree(feat: np.ndarray, th_bits: np.ndarray, path: np.ndarray,
                  target: np.ndarray, val_bits: np.ndarray
                  ) -> Tuple[np.ndarray, int]:
    """One tree's descent form from its dense form: (node rows int32
    [n, 4] breadth-first from the root, depth).

    ``feat`` [I] (-1: no feature), ``th_bits`` [I] and ``val_bits`` [L]
    (float32 bits), ``path`` int8 [I, L], ``target`` [L]. A node's subtree
    holds strictly fewer leaves than its parent's, so a leaf's path
    entries sorted by the number of leaves whose path holds them, most
    first, run from the root to the leaf, and consecutive entries link a
    parent to a child. Raises ``ValueError`` when the tables are not a
    tree, or when a target is not its leaf's count of left turns (the
    dense form would then compute another function)."""
    i_count = path.shape[0]
    real = np.flatnonzero(target < _NO_TARGET / 2)
    if len(real) == 0:  # no leaf is ever matched: the tree adds 0
        return np.zeros((1, 4), np.int32), 0
    p = path[:, real].astype(np.int64)  # [I, nL]
    on = p != 0
    n_on = on.sum(axis=0)  # entries of each leaf
    if not np.array_equal(target[real], (p > 0).sum(axis=0)):
        raise ValueError("path: a leaf's target is not its count of left "
                         "turns")
    depth = int(n_on.max())
    if len(real) == 1 or depth == 0:
        if depth:
            raise ValueError("path: a lone leaf has conditions")
        if len(real) > 1:
            raise ValueError("path: more than one leaf has no conditions")
        root = i_count + int(real[0])
        kids = {}
    else:
        if (n_on == 0).any():
            raise ValueError("path: a leaf without conditions beside others")
        key = np.where(on, on.sum(axis=1)[:, None], -1)
        order = np.argsort(-key, axis=0, kind="stable")[:depth]
        ranked = np.take_along_axis(key, order, axis=0)
        live = np.arange(depth)[:, None] < n_on[None, :]
        if (live[1:] & (ranked[1:] >= ranked[:-1])).any():
            raise ValueError("path: the nodes above a leaf do not nest")
        if (order[0] != order[0, 0]).any():
            raise ValueError("path: the leaves have no common root")
        root = int(order[0, 0])
        # each entry's child: the next entry, or the leaf after the last
        nxt = np.concatenate([order[1:], np.zeros_like(order[:1])])
        last = np.arange(depth)[:, None] == (n_on - 1)[None, :]
        child = np.where(last, i_count + real[None, :], nxt)
        side = np.take_along_axis(p, order, axis=0)
        links = np.unique(np.stack([order[live], side[live], child[live]],
                                   axis=1), axis=0)
        if len(np.unique(links[:, :2], axis=0)) < len(links):
            raise ValueError("path: a node has two children on one side")
        if len(np.unique(links[:, 2])) < len(links):
            raise ValueError("path: a node has two parents")
        if len(links) != 2 * len(np.unique(links[:, 0])):
            raise ValueError("path: a node lacks a child")
        kids = {(int(a), int(s)): int(c) for a, s, c in links}

    bfs = [root]
    for code in bfs:  # grows as it goes
        if code < i_count:
            bfs += [kids[code, 1], kids[code, -1]]
    ident = {code: n for n, code in enumerate(bfs)}
    rows = np.zeros((len(bfs), 4), np.int32)
    for n, code in enumerate(bfs):
        if code >= i_count:
            rows[n] = (0, val_bits[code - i_count], n, n)
            continue
        left, right = ident[kids[code, 1]], ident[kids[code, -1]]
        if feat[code] < 0:  # no feature: every row projects to 0
            th = th_bits[code:code + 1].view(np.float32)[0]
            left = right = left if np.float32(0.0) <= th else right
        rows[n] = (max(int(feat[code]), 0), th_bits[code], left, right)
    return rows, depth


def to_kernel_tables(g: GemmEnsemble, z_mode: str) -> ForestTables:
    """Pad ``g`` like ``to_pallas`` and derive the kernels' descent form.

    Raises ``ValueError`` when a ``sel`` column is neither one-hot nor all
    zero, when ``path`` holds a value other than -1, 0 and 1, when a real
    leaf's target is not an integer, or when ``path`` does not describe a
    tree (see :func:`_descent_tree`): the descent would then compute
    another function than the dense form. A node whose ``sel`` column is
    all zero projects to 0, so it decides alike for every row and both its
    links go to the child that decision takes. Padded trees are a single
    leaf of value 0 with depth 0, padded node rows leaves of value 0 that
    nothing links to. Built on the host from the real trees.
    """
    if z_mode not in _Z_DTYPES:
        raise ValueError(f"unknown z_mode {z_mode!r}")
    t, f, i = g.sel.shape
    l = g.path.shape[2]
    tp, fp, ip, lp = padded_shape(g)
    if not bool(((g.sel == 0) | (g.sel == 1)).all()) \
            or bool((g.sel.sum(dim=1) > 1).any()):
        raise ValueError("sel columns must be one-hot or all zero")
    if not bool(((g.path == 0) | (g.path == 1) | (g.path == -1)).all()):
        raise ValueError("path entries must be -1, 0 or 1")
    real = g.target < _NO_TARGET / 2
    if not bool((g.target[real] == torch.round(g.target[real])).all()):
        raise ValueError("leaf targets must be integers")

    feat = torch.where(g.sel.sum(dim=1) > 0, g.sel.argmax(dim=1),
                       -1).cpu().numpy()
    th_bits = g.thresh.float().cpu().numpy().view(np.int32)
    path = g.path.to(torch.int8).cpu().numpy()
    target = g.target.cpu().numpy()
    val_bits = g.leaf_val.float().cpu().numpy().view(np.int32)
    trees = [_descent_tree(feat[k], th_bits[k], path[k], target[k],
                           val_bits[k]) for k in range(t)]
    n_max = max(len(rows) for rows, _ in trees)
    nodes = np.zeros((tp, n_max, 4), np.int32)
    nodes[:, :, 2] = nodes[:, :, 3] = np.arange(n_max)  # self-loops
    depth = np.zeros(tp, np.int32)
    for k, (rows, d) in enumerate(trees):
        nodes[k, :len(rows)] = rows
        depth[k] = d

    # the dense tables padded to the TPU layout, for the plain version
    gemm = GemmEnsemble(
        sel=F.pad(g.sel, (0, ip - i, 0, fp - f, 0, tp - t)),
        thresh=F.pad(g.thresh, (0, ip - i, 0, tp - t), value=float("inf")),
        path=F.pad(g.path.to(_Z_DTYPES[z_mode]),
                   (0, lp - l, 0, ip - i, 0, tp - t)),
        target=F.pad(g.target, (0, lp - l, 0, tp - t),
                     value=float(_NO_TARGET)),
        leaf_val=F.pad(g.leaf_val, (0, lp - l, 0, tp - t)))
    dev = g.sel.device
    return ForestTables(gemm=gemm,
                        nodes=torch.as_tensor(nodes, device=dev),
                        depth=torch.as_tensor(depth, device=dev),
                        n_trees=int(t), z_mode=z_mode)


def smem_bytes(fp: int) -> int:
    """Shared memory of one block of either forest kernel: the scaled
    feature tile (``forest_smem_bytes`` in ``csrc/forest_walk.cuh``). The
    node records stay in device memory, so the trees' depth does not
    enter it."""
    return BLOCK_ROWS * fp * 4


class KernelAdmission(NamedTuple):
    """Whether a kernel may serve an ensemble — static facts only."""

    fits: bool  # the whole verdict
    smem_bytes: int  # one block's shared memory
    budget: int
    padded: Tuple[int, int, int, int]  # (Tp, Fp, Ip, Lp)


def admit_tables(g: GemmEnsemble, budget: int = SMEM_BUDGET
                 ) -> KernelAdmission:
    """Decide, from ``g``'s shapes alone, whether the forest kernels (the
    fused one and the leaf sum, which share one block layout) serve it:
    one block's shared memory must fit ``budget``. 15 features take 8 KB
    at any depth."""
    tp, fp, ip, lp = padded_shape(g)
    nbytes = smem_bytes(fp)
    return KernelAdmission(fits=nbytes <= budget, smem_bytes=nbytes,
                           budget=budget, padded=(tp, fp, ip, lp))


def leaf_sum_tables(params, z_mode: str) -> "ForestTables | None":
    """The leaf-sum kernel's tables for a tree model's device-form params
    (a GEMM-form ensemble, or a gbt over one) when :func:`admit_tables`
    admits the ensemble — a decision on its shapes alone, made before any
    launch — else None (the plain predict of the params' form serves).
    The one routing rule of the engine's unfused step, the shadow scorer
    and ``TrainedModel.predict_proba``."""
    trees = params.trees if isinstance(params, GBTModel) else params
    if isinstance(trees, GemmEnsemble) and admit_tables(trees).fits:
        return to_kernel_tables(trees, z_mode)
    return None


def leaf_sum_proba(tables: ForestTables, x: torch.Tensor,
                   base_score: "torch.Tensor | None" = None) -> torch.Tensor:
    """Probability through :func:`leaf_sum` on scaled features ``x``:
    ``sigmoid(base_score + Σ)`` for a boosted model, the bagging mean
    ``Σ / n_trees`` without a ``base_score``."""
    leaf = leaf_sum(tables, x)
    if base_score is not None:
        return torch.sigmoid(base_score + leaf)
    return leaf / tables.n_trees


def fused_forest_leaf_sum_plain(
    tables: ForestTables,
    customer: WindowState,
    terminal: WindowState,
    cust_slot: torch.Tensor,
    term_slot: torch.Tensor,
    day: torch.Tensor,
    tod_s: torch.Tensor,
    amount: torch.Tensor,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    windows: Sequence[int] = (1, 7, 30),
    delay: int = 7,
    weekend_start: int = 5,
    night_end: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (Σ_t leaf value [B], raw features [B, F]).
    Raises ``IndexError`` for a slot outside [0, capacity)."""
    check_slots(customer, terminal, cust_slot, term_slot)
    c_rows, t_rows = gather_feature_rows(customer, terminal, cust_slot,
                                         term_slot)
    feats = assemble_features(
        c_rows, t_rows, day, tod_s, amount, windows=tuple(windows),
        delay=delay, weekend_start=weekend_start, night_end=night_end)
    x = transform(Scaler(scaler_mean, scaler_scale), feats)
    return leaf_sum_plain(tables, x), feats


def leaf_sum_plain(tables: ForestTables, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`leaf_sum`: ``gemm_leaf_sum`` on the
    padded tables, feature columns padded with 0 (no real node reads
    them). The padded trees are left out: each would add +0 after the
    real ones, so the sum is the kernel's all the same."""
    x = F.pad(x, (0, tables.gemm.sel.shape[1] - x.shape[1]))
    real = GemmEnsemble(*(a[:tables.n_trees] for a in tables.gemm))
    return gemm_leaf_sum(real, x, tables.z_mode)


def _bind(source, prefix: str, launch_args) -> ctypes.CDLL:
    lib = load_library(source)
    i = ctypes.c_int
    launch = getattr(lib, f"{prefix}_launch")
    launch.argtypes = launch_args
    launch.restype = i
    layout = {}
    for name, args in (("block_rows", ()), ("trees_in_flight", ()),
                       ("max_smem", ()), ("smem_bytes", (16,))):
        fn = getattr(lib, f"{prefix}_{name}")
        fn.argtypes = [i] * len(args)
        fn.restype = i
        layout[name] = fn(*args)
    if layout != {"block_rows": BLOCK_ROWS,
                  "trees_in_flight": TREES_IN_FLIGHT,
                  "max_smem": SMEM_BUDGET, "smem_bytes": smem_bytes(16)}:
        raise RuntimeError(f"csrc/{source.name} and ops/forest_kernels.py "
                           f"disagree on the block layout: {layout}")
    return lib


@functools.lru_cache(maxsize=None)
def _library(source=SOURCE) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _bind(source, "fused_forest", [p] * 17 + [i] * 14 + [p])


@functools.lru_cache(maxsize=None)
def _leaf_sum_library(source=LEAF_SUM_SOURCE) -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _bind(source, "leaf_sum", [p] * 4 + [i] * 5 + [p])


def _check_tables(tables: ForestTables, dev: torch.device
                  ) -> Tuple[int, int, int]:
    """Check the descent tables a kernel reads; return (Tp, Fp, N)."""
    tp, fp = tables.gemm.sel.shape[:2]
    n = tables.nodes.shape[1]
    if smem_bytes(fp) > SMEM_BUDGET:
        raise ValueError("forest tables exceed the kernels' shared-memory "
                         "budget (see admit_tables)")
    check_tensor(tables.nodes, "nodes", torch.int32, (tp, n, 4), dev)
    check_tensor(tables.depth, "depth", torch.int32, (tp,), dev)
    if tables.nodes.data_ptr() % 16:
        raise ValueError("nodes: the kernels read them as 16-byte records")
    return tp, fp, n


def fused_forest_leaf_sum(
    tables: ForestTables,
    customer: WindowState,  # [c_cap, NB]: bd, cnt, amt read
    terminal: WindowState,  # [t_cap, NB]: bd, cnt, frd read
    cust_slot: torch.Tensor,  # int64 [B] in [0, c_cap)
    term_slot: torch.Tensor,  # int64 [B] in [0, t_cap)
    day: torch.Tensor,  # int32 [B]
    tod_s: torch.Tensor,  # int32 [B]
    amount: torch.Tensor,  # float32 [B]
    scaler_mean: torch.Tensor,  # float32 [F]
    scaler_scale: torch.Tensor,  # float32 [F]
    windows: Sequence[int] = (1, 7, 30),
    delay: int = 7,
    weekend_start: int = 5,
    night_end: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State tables and slots → (Σ_t leaf value [B], raw features [B, F]).

    CPU tensors go through :func:`fused_forest_leaf_sum_plain`. CUDA
    tensors launch the kernel on the current stream (no synchronisation)
    or raise; ``fused_forest_leaf_sum.launches`` counts the launches
    (one recorded into a CUDA graph, ``.captured``:
    ``ops/cuda_lib.py::count_launch``). The
    kernel reads the tables' rows by slot as they stand on the stream; a
    slot outside [0, capacity) is the caller's error.
    """
    if day.device.type == "cpu":
        return fused_forest_leaf_sum_plain(
            tables, customer, terminal, cust_slot, term_slot, day, tod_s,
            amount, scaler_mean, scaler_scale, windows, delay,
            weekend_start, night_end)
    if day.device.type != "cuda":
        raise ValueError(f"no fused forest kernel for {day.device}")
    dev = day.device
    n_win = len(windows)
    n_feat = 3 + 4 * n_win
    if not 1 <= n_win <= MAX_WINDOWS:
        raise ValueError(f"the kernel takes 1..{MAX_WINDOWS} windows, "
                         f"got {n_win}")
    tp, fp, n = _check_tables(tables, dev)
    b, nb = check_feature_inputs(customer, terminal, cust_slot, term_slot,
                                 day, tod_s, amount, dev)
    check_tensor(scaler_mean, "scaler_mean", torch.float32, (n_feat,), dev)
    check_tensor(scaler_scale, "scaler_scale", torch.float32, (n_feat,), dev)
    leaf = torch.empty(b, dtype=torch.float32, device=dev)
    feats = torch.empty((b, n_feat), dtype=torch.float32, device=dev)
    if b == 0:
        return leaf, feats
    win = list(windows) + [0] * (MAX_WINDOWS - n_win)
    err = _library().fused_forest_launch(
        *(x.data_ptr() for x in (
            customer.bucket_day, customer.count, customer.amount,
            terminal.bucket_day, terminal.count, terminal.fraud, cust_slot,
            term_slot, day, tod_s, amount, scaler_mean, scaler_scale,
            tables.nodes, tables.depth, leaf, feats)),
        b, nb, tp, n, n_feat, fp, n_win, *win,
        delay, weekend_start, night_end,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused forest kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(fused_forest_leaf_sum)
    return leaf, feats


fused_forest_leaf_sum.launches = 0
fused_forest_leaf_sum.captured = 0


def leaf_sum(tables: ForestTables, x: torch.Tensor) -> torch.Tensor:
    """Scaled features ``x`` float32 [B, F ≤ Fp] → Σ_t leaf value [B].

    CPU tensors go through :func:`leaf_sum_plain`. CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise; the
    kernel zero-fills the pad columns up to Fp as it loads its tile.
    ``leaf_sum.launches`` counts the launches
    (one recorded into a CUDA graph, ``.captured``:
    ``ops/cuda_lib.py::count_launch``).
    """
    if x.device.type == "cpu":
        return leaf_sum_plain(tables, x)
    if x.device.type != "cuda":
        raise ValueError(f"no leaf-sum kernel for {x.device}")
    dev = x.device
    tp, fp, n = _check_tables(tables, dev)
    if x.dim() != 2 or not 1 <= x.shape[1] <= fp:
        raise ValueError(f"x: expected [B, F] with 1 <= F <= {fp}, got "
                         f"{tuple(x.shape)}")
    b, f = x.shape
    check_tensor(x, "x", torch.float32, (b, f), dev)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    err = _leaf_sum_library().leaf_sum_launch(
        *(t.data_ptr() for t in (x, tables.nodes, tables.depth, out)),
        b, f, fp, tp, n,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"leaf-sum kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(leaf_sum)
    return out


leaf_sum.launches = 0
leaf_sum.captured = 0
