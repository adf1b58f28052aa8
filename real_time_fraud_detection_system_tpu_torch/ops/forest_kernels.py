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
  ``target=1e9``, zero leaves) and compacts the sparse tables into the
  kernels' form (one feature per node, ≤ depth entries per leaf, an
  integer target).
- :func:`admit_tables` and :func:`admit_leaf_sum` are the counterparts of
  ``admit_block``: static predicates on the ensemble's shapes, sized in
  shared-memory bytes, one per kernel.
- :func:`fused_forest_leaf_sum` (``csrc/fused_forest.cu``, replacing
  ``fused_forest_leaf_sum``): gathered state rows → features → Σ_t leaf
  value. Its plain version is the literal composition of
  ``assemble_features``, ``transform`` and ``gemm_leaf_sum``.
- :func:`leaf_sum` (``csrc/leaf_sum.cu``, replacing ``pallas_leaf_sum``):
  scaled features → Σ_t leaf value, for gbt and for the forest's unfused
  step. Its plain version is ``gemm_leaf_sum`` on the padded tables.

Each wrapper runs its plain version for CPU tensors; for CUDA tensors it
launches its kernel or raises, and counts the launches on itself.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    gemm_leaf_sum,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.ops.cuda_lib import (
    CSRC,
    build_library,
    check_tensor,
)
from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
    assemble_features,
)

# Tree-count padding multiple, kept from the TPU layout so both packages
# pad an ensemble alike (the kernels walk trees one at a time).
TREE_BLOCK = 10
# Rows (threads) per CUDA block; kForestRows in csrc/forest_walk.cuh.
BLOCK_ROWS = 128
# Shared memory a block gets without opting in to more; the fused kernel
# stays within it. The flagship forest needs 16 KB.
SMEM_BUDGET = 48 * 1024
# The most a block may opt in to on sm_90 (227 KB); the leaf-sum kernel
# does, so it admits trees up to depth 12.
LEAF_SUM_SMEM_BUDGET = 227 * 1024
MAX_WINDOWS = 4
_NO_TARGET = 1_000_000_000  # padded leaves' target; never matched

SOURCE = CSRC / "fused_forest.cu"
LEAF_SUM_SOURCE = CSRC / "leaf_sum.cu"


def _ceil_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class ForestTables(NamedTuple):
    """A forest in the kernels' layout (see :func:`to_kernel_tables`)."""

    gemm: GemmEnsemble  # padded dense tables; path in the z dtype
    node_feat: torch.Tensor  # int32 [Tp, Ip]; -1 where sel's column is 0
    leaf_entries: torch.Tensor  # int32 [Tp, Lp, D], D % 4 == 0;
    #                             2·node + (sign > 0), -1 padding
    leaf_target: torch.Tensor  # int32 [Tp, Lp]; 1e9 on padding
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


def to_kernel_tables(g: GemmEnsemble, z_mode: str) -> ForestTables:
    """Pad ``g`` like ``to_pallas`` and compact it for the kernels.

    Raises ``ValueError`` when a ``sel`` column is neither one-hot nor all
    zero, when ``path`` holds a value other than -1, 0 and 1, or when a
    real leaf's target is not an integer: the compact form would then
    compute another function than the dense one. An all-zero ``sel``
    column (padding) projects to 0, which decides 1 against ``+inf``.
    The compact tables are built from the real trees and then padded
    (padded trees: no features, no entries, no target). A few host syncs
    (the checks, and the deepest leaf sizes the entry table).
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

    # compact form of the real trees, nodes and leaves padded to Ip, Lp
    sel = F.pad(g.sel, (0, ip - i))  # [T, F, Ip]
    node_feat = torch.where(sel.sum(dim=1) > 0,
                            sel.argmax(dim=1).to(torch.int32),
                            torch.full((t, ip), -1, dtype=torch.int32,
                                       device=sel.device))
    path = F.pad(g.path, (0, lp - l, 0, ip - i))  # [T, Ip, Lp]
    nz = (path != 0).transpose(1, 2)  # [T, Lp, Ip]
    # entries per leaf, padded to a multiple of 4 (the kernels read them
    # as 16-byte vectors)
    depth = 4 * max(1, -(-int(nz.sum(dim=2).max()) // 4))
    # the nonzero nodes of each leaf first, in node order
    order = torch.sort((~nz).to(torch.int8), dim=2, stable=True).indices
    node = order[:, :, :depth]
    sign = torch.gather(path.transpose(1, 2), 2, node)
    leaf_entries = torch.where(sign != 0, 2 * node + (sign > 0).long(),
                               torch.full_like(node, -1)).to(torch.int32)
    target = F.pad(g.target, (0, lp - l), value=float(_NO_TARGET))
    leaf_target = torch.where(target < _NO_TARGET / 2, target.round(),
                              torch.full_like(target, _NO_TARGET)
                              ).to(torch.int32)
    del sel, path, nz, order, node, sign

    # the tree dimension padded to the TPU layout's multiple
    gemm = GemmEnsemble(
        sel=F.pad(g.sel, (0, ip - i, 0, fp - f, 0, tp - t)),
        thresh=F.pad(g.thresh, (0, ip - i, 0, tp - t), value=float("inf")),
        path=F.pad(g.path.to(_Z_DTYPES[z_mode]),
                   (0, lp - l, 0, ip - i, 0, tp - t)),
        target=F.pad(g.target, (0, lp - l, 0, tp - t),
                     value=float(_NO_TARGET)),
        leaf_val=F.pad(g.leaf_val, (0, lp - l, 0, tp - t)))
    return ForestTables(
        gemm=gemm,
        node_feat=F.pad(node_feat, (0, 0, 0, tp - t), value=-1).contiguous(),
        leaf_entries=F.pad(leaf_entries, (0, 0, 0, 0, 0, tp - t),
                           value=-1).contiguous(),
        leaf_target=F.pad(leaf_target, (0, 0, 0, tp - t),
                          value=_NO_TARGET).contiguous(),
        n_trees=int(t), z_mode=z_mode)


def smem_bytes(fp: int, ip: int, lp: int) -> int:
    """Shared memory of one block of either forest kernel: the scaled
    feature tile, the decision bit words, and one tree's node and leaf
    tables (``forest_smem_bytes`` in ``csrc/forest_walk.cuh``)."""
    return BLOCK_ROWS * (fp * 4 + (ip // 32) * 4) + ip * 8 + lp * 8


class KernelAdmission(NamedTuple):
    """Whether a kernel may serve an ensemble — static facts only."""

    fits: bool  # the whole verdict
    smem_bytes: int  # one block's shared memory
    budget: int
    padded: Tuple[int, int, int, int]  # (Tp, Fp, Ip, Lp)


def _admit(g: GemmEnsemble, budget: int) -> KernelAdmission:
    tp, fp, ip, lp = padded_shape(g)
    nbytes = smem_bytes(fp, ip, lp)
    return KernelAdmission(fits=nbytes <= budget, smem_bytes=nbytes,
                           budget=budget, padded=(tp, fp, ip, lp))


def admit_tables(g: GemmEnsemble, budget: int = SMEM_BUDGET
                 ) -> KernelAdmission:
    """Decide, from ``g``'s shapes alone, whether the fused kernel serves
    it: one block's shared memory must fit ``budget`` (48 KB, no opt-in).
    T=100 at depth 8 (Ip = Lp = 256) takes 16 KB; depth 10 fits, depth
    11 does not."""
    return _admit(g, budget)


def admit_leaf_sum(g: GemmEnsemble, budget: int = LEAF_SUM_SMEM_BUDGET
                   ) -> KernelAdmission:
    """Decide, from ``g``'s shapes alone, whether the leaf-sum kernel
    serves it: the same block layout as the fused kernel, against the
    227 KB a block may opt in to. Depth 12 (Ip = Lp = 4096) takes 136 KB;
    depth 13 does not fit."""
    return _admit(g, budget)


def fused_forest_leaf_sum_plain(
    tables: ForestTables,
    c_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    t_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
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
    """Plain PyTorch version: (Σ_t leaf value [B], raw features [B, F])."""
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
    lib = ctypes.CDLL(str(build_library(source)[0]))
    i = ctypes.c_int
    launch = getattr(lib, f"{prefix}_launch")
    launch.argtypes = launch_args
    launch.restype = i
    smem = getattr(lib, f"{prefix}_smem_bytes")
    smem.argtypes = [i, i, i]
    smem.restype = i
    rows = getattr(lib, f"{prefix}_block_rows")
    rows.argtypes = []
    rows.restype = i
    if rows() != BLOCK_ROWS \
            or smem(16, 256, 256) != smem_bytes(16, 256, 256):
        raise RuntimeError(f"csrc/{source.name} and ops/forest_kernels.py "
                           "disagree on the block layout")
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    return _bind(SOURCE, "fused_forest", [p] * 18 + [i] * 16 + [p])


@functools.lru_cache(maxsize=None)
def _leaf_sum_library() -> ctypes.CDLL:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib = _bind(LEAF_SUM_SOURCE, "leaf_sum", [p] * 7 + [i] * 7 + [p])
    lib.leaf_sum_max_smem.argtypes = []
    lib.leaf_sum_max_smem.restype = i
    if lib.leaf_sum_max_smem() != LEAF_SUM_SMEM_BUDGET:
        raise RuntimeError("csrc/leaf_sum.cu and ops/forest_kernels.py "
                           "disagree on the shared-memory budget")
    return lib


def _check_tables(tables: ForestTables, budget: int,
                  dev: torch.device) -> Tuple[int, int, int, int, int]:
    """Check the compact tables a kernel reads; return (Tp, Fp, Ip, Lp, D)."""
    tp, fp, ip = tables.gemm.sel.shape
    lp = tables.gemm.path.shape[2]
    depth = tables.leaf_entries.shape[2]
    if smem_bytes(fp, ip, lp) > budget:
        raise ValueError("forest tables exceed the kernel's shared-memory "
                         "budget (see admit_tables and admit_leaf_sum)")
    check_tensor(tables.node_feat, "node_feat", torch.int32, (tp, ip), dev)
    check_tensor(tables.gemm.thresh, "thresh", torch.float32, (tp, ip), dev)
    check_tensor(tables.leaf_entries, "leaf_entries", torch.int32,
                 (tp, lp, depth), dev)
    if depth % 4 or tables.leaf_entries.data_ptr() % 16:
        raise ValueError("leaf_entries: the kernels read them as 16-byte "
                         "vectors (depth % 4 == 0, 16-byte aligned)")
    check_tensor(tables.leaf_target, "leaf_target", torch.int32, (tp, lp),
                 dev)
    check_tensor(tables.gemm.leaf_val, "leaf_val", torch.float32, (tp, lp),
                 dev)
    return tp, fp, ip, lp, depth


def fused_forest_leaf_sum(
    tables: ForestTables,
    c_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # bd, cnt, amt
    t_rows: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],  # bd, cnt, frd
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
    """Gathered state rows → (Σ_t leaf value [B], raw features [B, F]).

    CPU tensors go through :func:`fused_forest_leaf_sum_plain`. CUDA
    tensors launch the kernel on the current stream (no synchronisation)
    or raise; ``fused_forest_leaf_sum.launches`` counts the launches.
    """
    if day.device.type == "cpu":
        return fused_forest_leaf_sum_plain(
            tables, c_rows, t_rows, day, tod_s, amount, scaler_mean,
            scaler_scale, windows, delay, weekend_start, night_end)
    if day.device.type != "cuda":
        raise ValueError(f"no fused forest kernel for {day.device}")
    dev = day.device
    b, nb = c_rows[0].shape
    n_win = len(windows)
    n_feat = 3 + 4 * n_win
    if not 1 <= n_win <= MAX_WINDOWS:
        raise ValueError(f"the kernel takes 1..{MAX_WINDOWS} windows, "
                         f"got {n_win}")
    tp, fp, ip, lp, depth = _check_tables(tables, SMEM_BUDGET, dev)
    for name, tns, dt in (("c_bd", c_rows[0], torch.int32),
                          ("c_cnt", c_rows[1], torch.float32),
                          ("c_amt", c_rows[2], torch.float32),
                          ("t_bd", t_rows[0], torch.int32),
                          ("t_cnt", t_rows[1], torch.float32),
                          ("t_frd", t_rows[2], torch.float32)):
        check_tensor(tns, name, dt, (b, nb), dev)
    check_tensor(day, "day", torch.int32, (b,), dev)
    check_tensor(tod_s, "tod_s", torch.int32, (b,), dev)
    check_tensor(amount, "amount", torch.float32, (b,), dev)
    check_tensor(scaler_mean, "scaler_mean", torch.float32, (n_feat,), dev)
    check_tensor(scaler_scale, "scaler_scale", torch.float32, (n_feat,), dev)
    leaf = torch.empty(b, dtype=torch.float32, device=dev)
    feats = torch.empty((b, n_feat), dtype=torch.float32, device=dev)
    if b == 0:
        return leaf, feats
    win = list(windows) + [0] * (MAX_WINDOWS - n_win)
    err = _library().fused_forest_launch(
        *(x.data_ptr() for x in (*c_rows, *t_rows, day, tod_s, amount,
                                 scaler_mean, scaler_scale,
                                 tables.node_feat, tables.gemm.thresh,
                                 tables.leaf_entries, tables.leaf_target,
                                 tables.gemm.leaf_val, leaf, feats)),
        b, nb, tp, ip, lp, depth, n_feat, fp, n_win, *win,
        delay, weekend_start, night_end,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused forest kernel launch failed: CUDA error "
                           f"{err}")
    fused_forest_leaf_sum.launches += 1
    return leaf, feats


fused_forest_leaf_sum.launches = 0


def leaf_sum(tables: ForestTables, x: torch.Tensor) -> torch.Tensor:
    """Scaled features ``x`` float32 [B, F ≤ Fp] → Σ_t leaf value [B].

    CPU tensors go through :func:`leaf_sum_plain`. CUDA tensors launch the
    kernel on the current stream (no synchronisation) or raise; the
    kernel zero-fills the pad columns up to Fp as it loads its tile.
    ``leaf_sum.launches`` counts the launches.
    """
    if x.device.type == "cpu":
        return leaf_sum_plain(tables, x)
    if x.device.type != "cuda":
        raise ValueError(f"no leaf-sum kernel for {x.device}")
    dev = x.device
    tp, fp, ip, lp, depth = _check_tables(tables, LEAF_SUM_SMEM_BUDGET, dev)
    if x.dim() != 2 or not 1 <= x.shape[1] <= fp:
        raise ValueError(f"x: expected [B, F] with 1 <= F <= {fp}, got "
                         f"{tuple(x.shape)}")
    b, f = x.shape
    check_tensor(x, "x", torch.float32, (b, f), dev)
    out = torch.empty(b, dtype=torch.float32, device=dev)
    if b == 0:
        return out
    err = _leaf_sum_library().leaf_sum_launch(
        *(t.data_ptr() for t in (x, tables.node_feat, tables.gemm.thresh,
                                 tables.leaf_entries, tables.leaf_target,
                                 tables.gemm.leaf_val, out)),
        b, f, fp, tp, ip, lp, depth,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"leaf-sum kernel launch failed: CUDA error "
                           f"{err}")
    leaf_sum.launches += 1
    return out


leaf_sum.launches = 0


def leaf_sum_predict_proba(tables: ForestTables,
                           x: torch.Tensor) -> torch.Tensor:
    """[B, F] → fraud probability [B] (bagging mean over the real trees);
    the counterpart of ``pallas_predict_proba``."""
    return leaf_sum(tables, x) / tables.n_trees
