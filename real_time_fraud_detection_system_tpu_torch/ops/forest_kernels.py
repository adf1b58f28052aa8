"""Fused featurize→forest step: table prep, admission, plain version and
the CUDA wrapper.

Counterpart of the JAX package's ``ops/pallas_forest.py``
(``fused_forest_leaf_sum`` → ``_fused_forest_kernel``). The kernel itself
is CUDA C++ for Hopper in ``csrc/fused_forest.cu``; its header says what it
computes, what bounds it and what its design does about that.

- :func:`to_kernel_tables` is the counterpart of ``to_pallas``: it pads a
  :class:`~..models.forest.GemmEnsemble` the same way (T → ×10, F → ×8,
  I and L → ×128, with the same inert padding: ``thresh=+inf``,
  ``target=1e9``, zero leaves) and compacts the sparse tables into the
  kernel's form (one feature per node, ≤ depth entries per leaf, an
  integer target).
- :func:`admit_tables` is the counterpart of ``admit_block``: a static
  predicate on the ensemble's shapes, sized in shared-memory bytes.
- :func:`fused_forest_leaf_sum_plain` is the plain PyTorch version: the
  literal composition of ``assemble_features`` (the age-mask window sums
  of ``query_gathered`` and the columns of ``_assemble``), ``transform``
  and ``gemm_leaf_sum`` with the dense einsums.
- :func:`fused_forest_leaf_sum` is the wrapper: the plain version for CPU
  tensors; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
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
from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
    assemble_features,
)

# Tree-count padding multiple, kept from the TPU layout so both packages
# pad an ensemble alike (the kernel walks trees one at a time).
TREE_BLOCK = 10
# Rows (threads) per CUDA block; kBlockRows in csrc/fused_forest.cu.
BLOCK_ROWS = 128
# Shared memory a block gets without opting in to more (up to 227 KB);
# the flagship forest needs 16 KB.
SMEM_BUDGET = 48 * 1024
MAX_WINDOWS = 4
_NO_TARGET = 1_000_000_000  # padded leaves' target; never matched

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fused_forest.cu"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math: -prec-div=true and -ftz=false stay at their
# defaults, and --fmad=false keeps every product out of an FMA, so the
# kernel's decisions match the plain version bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")


def _ceil_to(n: int, m: int) -> int:
    return max(m, ((n + m - 1) // m) * m)


class ForestTables(NamedTuple):
    """A forest in the kernel's layout (see :func:`to_kernel_tables`)."""

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
    """Pad ``g`` like ``to_pallas`` and compact it for the kernel.

    Raises ``ValueError`` when a ``sel`` column is neither one-hot nor all
    zero, when ``path`` holds a value other than -1, 0 and 1, or when a
    real leaf's target is not an integer: the compact form would then
    compute another function than the dense one. An all-zero ``sel``
    column (padding) projects to 0, which decides 1 against ``+inf``.
    One host sync (the deepest leaf sizes the entry table).
    """
    if z_mode not in _Z_DTYPES:
        raise ValueError(f"unknown z_mode {z_mode!r}")
    t, f, i = g.sel.shape
    l = g.path.shape[2]
    tp, fp, ip, lp = padded_shape(g)
    sel = F.pad(g.sel, (0, ip - i, 0, fp - f, 0, tp - t))
    thresh = F.pad(g.thresh, (0, ip - i, 0, tp - t), value=float("inf"))
    path = F.pad(g.path, (0, lp - l, 0, ip - i, 0, tp - t))
    target = F.pad(g.target, (0, lp - l, 0, tp - t), value=float(_NO_TARGET))
    leaf_val = F.pad(g.leaf_val, (0, lp - l, 0, tp - t))

    if not bool(((sel == 0) | (sel == 1)).all()) \
            or bool((sel.sum(dim=1) > 1).any()):
        raise ValueError("sel columns must be one-hot or all zero")
    if not bool(((path == 0) | (path == 1) | (path == -1)).all()):
        raise ValueError("path entries must be -1, 0 or 1")
    real = target < _NO_TARGET / 2
    if not bool((target[real] == torch.round(target[real])).all()):
        raise ValueError("leaf targets must be integers")

    node_feat = torch.where(sel.sum(dim=1) > 0,
                            sel.argmax(dim=1).to(torch.int32),
                            torch.full((tp, ip), -1, dtype=torch.int32,
                                       device=sel.device))
    nz = (path != 0).transpose(1, 2)  # [Tp, Lp, Ip]
    # entries per leaf, padded to a multiple of 4 (the kernel reads them
    # as 16-byte vectors)
    depth = 4 * max(1, -(-int(nz.sum(dim=2).max()) // 4))
    # the nonzero nodes of each leaf first, in node order
    order = torch.sort((~nz).to(torch.int8), dim=2, stable=True).indices
    node = order[:, :, :depth]
    sign = torch.gather(path.transpose(1, 2), 2, node)
    leaf_entries = torch.where(sign != 0, 2 * node + (sign > 0).long(),
                               torch.full_like(node, -1)).to(torch.int32)
    leaf_target = torch.where(real, target.round(),
                              torch.full_like(target, _NO_TARGET)
                              ).to(torch.int32)
    gemm = GemmEnsemble(sel=sel, thresh=thresh,
                        path=path.to(_Z_DTYPES[z_mode]), target=target,
                        leaf_val=leaf_val)
    return ForestTables(gemm=gemm, node_feat=node_feat.contiguous(),
                        leaf_entries=leaf_entries.contiguous(),
                        leaf_target=leaf_target.contiguous(),
                        n_trees=int(t), z_mode=z_mode)


def smem_bytes(fp: int, ip: int, lp: int) -> int:
    """Shared memory of one block: the scaled feature tile, the decision
    bit words, and one tree's node and leaf tables
    (``fused_forest_smem_bytes`` in the source)."""
    return BLOCK_ROWS * (fp * 4 + (ip // 32) * 4) + ip * 8 + lp * 8


class KernelAdmission(NamedTuple):
    """Whether the fused kernel may serve an ensemble — static facts only."""

    fits: bool  # the whole verdict
    smem_bytes: int  # one block's shared memory
    budget: int
    padded: Tuple[int, int, int, int]  # (Tp, Fp, Ip, Lp)


def admit_tables(g: GemmEnsemble, budget: int = SMEM_BUDGET
                 ) -> KernelAdmission:
    """Decide, from ``g``'s shapes alone, whether the kernel serves it:
    one block's shared memory must fit ``budget``. T=100 at depth 8
    (Ip = Lp = 256) takes 16 KB."""
    tp, fp, ip, lp = padded_shape(g)
    nbytes = smem_bytes(fp, ip, lp)
    return KernelAdmission(fits=nbytes <= budget, smem_bytes=nbytes,
                           budget=budget, padded=(tp, fp, ip, lp))


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
    # feature-lane padding: (0, 1) standardization makes pad columns 0
    x = F.pad(x, (0, tables.gemm.sel.shape[1] - x.shape[1]))
    return gemm_leaf_sum(tables.gemm, x, tables.z_mode), feats


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds csrc/fused_forest.cu")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def build_library() -> Tuple[Path, str]:
    """Compile ``csrc/fused_forest.cu`` into a shared library under
    ``_build/`` (once per source and flag set) and return (path, the
    compiler's report: registers, shared memory and spills, or "" when
    the library was already built)."""
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libfused_forest-{digest}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build_library()[0]))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_forest_launch.argtypes = [p] * 18 + [i] * 16 + [p]
    lib.fused_forest_launch.restype = i
    lib.fused_forest_smem_bytes.argtypes = [i, i, i]
    lib.fused_forest_smem_bytes.restype = i
    lib.fused_forest_block_rows.argtypes = []
    lib.fused_forest_block_rows.restype = i
    if lib.fused_forest_block_rows() != BLOCK_ROWS \
            or lib.fused_forest_smem_bytes(16, 256, 256) \
            != smem_bytes(16, 256, 256):
        raise RuntimeError("csrc/fused_forest.cu and ops/forest_kernels.py "
                           "disagree on the block layout")
    return lib


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


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
    tp, fp, ip = tables.gemm.sel.shape
    lp = tables.gemm.path.shape[2]
    depth = tables.leaf_entries.shape[2]
    if smem_bytes(fp, ip, lp) > SMEM_BUDGET:
        raise ValueError("forest tables exceed the kernel's shared-memory "
                         "budget (see admit_tables)")
    for name, tns, dt in (("c_bd", c_rows[0], torch.int32),
                          ("c_cnt", c_rows[1], torch.float32),
                          ("c_amt", c_rows[2], torch.float32),
                          ("t_bd", t_rows[0], torch.int32),
                          ("t_cnt", t_rows[1], torch.float32),
                          ("t_frd", t_rows[2], torch.float32)):
        _check(tns, name, dt, (b, nb), dev)
    _check(day, "day", torch.int32, (b,), dev)
    _check(tod_s, "tod_s", torch.int32, (b,), dev)
    _check(amount, "amount", torch.float32, (b,), dev)
    _check(scaler_mean, "scaler_mean", torch.float32, (n_feat,), dev)
    _check(scaler_scale, "scaler_scale", torch.float32, (n_feat,), dev)
    _check(tables.node_feat, "node_feat", torch.int32, (tp, ip), dev)
    _check(tables.gemm.thresh, "thresh", torch.float32, (tp, ip), dev)
    _check(tables.leaf_entries, "leaf_entries", torch.int32,
           (tp, lp, depth), dev)
    if depth % 4 or tables.leaf_entries.data_ptr() % 16:
        raise ValueError("leaf_entries: the kernel reads them as 16-byte "
                         "vectors (depth % 4 == 0, 16-byte aligned)")
    _check(tables.leaf_target, "leaf_target", torch.int32, (tp, lp), dev)
    _check(tables.gemm.leaf_val, "leaf_val", torch.float32, (tp, lp), dev)
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
