"""Fused featurize→logistic-regression step: plain version and the CUDA
wrapper.

Counterpart of the JAX package's ``ops/pallas_kernels.py::
fused_featurize_score`` (kernel ``_score_kernel``), which serves the
logreg model. The kernel is CUDA C++ for Hopper in ``csrc/fused_score.cu``;
it shares the feature assembly of the fused forest kernel
(``csrc/features.cuh``). Its header says what bounds it and what its
design does about that.

Both functions start from the feature-state tables and the batch's slots:
the Pallas kernel takes the rows XLA gathered for it, the CUDA kernel
reads them by slot itself.

- :func:`fused_featurize_score_plain` is the plain PyTorch version:
  ``gather_feature_rows``, ``assemble_features``, then ``(x−mean)/scale``,
  then the logit with the products added in feature order
  (``models/logreg.py::logreg_logits``), then ``sigmoid(z)·valid``.
- :func:`fused_featurize_score` is the wrapper: the plain version for CPU
  tensors; for CUDA tensors it launches the kernel or raises, and counts
  the launches on itself. Unlike the Pallas kernel, any B is taken.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
    logreg_predict_proba,
)
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

# Rows (threads) per CUDA block; kScoreRows in csrc/fused_score.cu.
BLOCK_ROWS = 128
MAX_WINDOWS = 4
SOURCE = CSRC / "fused_score.cu"


def fused_featurize_score_plain(
    customer: WindowState,
    terminal: WindowState,
    cust_slot: torch.Tensor,
    term_slot: torch.Tensor,
    day: torch.Tensor,
    tod_s: torch.Tensor,
    amount: torch.Tensor,
    valid: torch.Tensor,
    scaler_mean: torch.Tensor,
    scaler_scale: torch.Tensor,
    w: torch.Tensor,
    b: torch.Tensor,
    windows: Sequence[int] = (1, 7, 30),
    delay: int = 7,
    weekend_start: int = 5,
    night_end: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: (probs [B], raw features [B, F]). Raises
    ``IndexError`` for a slot outside [0, capacity)."""
    check_slots(customer, terminal, cust_slot, term_slot)
    c_rows, t_rows = gather_feature_rows(customer, terminal, cust_slot,
                                         term_slot)
    feats = assemble_features(
        c_rows, t_rows, day, tod_s, amount, windows=tuple(windows),
        delay=delay, weekend_start=weekend_start, night_end=night_end)
    x = transform(Scaler(scaler_mean, scaler_scale), feats)
    probs = logreg_predict_proba(LogRegParams(w, b), x)
    return probs * valid.to(torch.float32), feats


@functools.lru_cache(maxsize=None)
def _library(source=SOURCE) -> ctypes.CDLL:
    lib = load_library(source)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_score_launch.argtypes = [p] * 18 + [i] * 11 + [p]
    lib.fused_score_launch.restype = i
    lib.fused_score_block_rows.argtypes = []
    lib.fused_score_block_rows.restype = i
    if lib.fused_score_block_rows() != BLOCK_ROWS:
        raise RuntimeError(f"csrc/{source.name} and ops/score_kernels.py "
                           f"disagree on the block layout")
    return lib


def fused_featurize_score(
    customer: WindowState,  # [c_cap, NB]: bd, cnt, amt read
    terminal: WindowState,  # [t_cap, NB]: bd, cnt, frd read
    cust_slot: torch.Tensor,  # int64 [B] in [0, c_cap)
    term_slot: torch.Tensor,  # int64 [B] in [0, t_cap)
    day: torch.Tensor,  # int32 [B]
    tod_s: torch.Tensor,  # int32 [B]
    amount: torch.Tensor,  # float32 [B]
    valid: torch.Tensor,  # bool [B]
    scaler_mean: torch.Tensor,  # float32 [F]
    scaler_scale: torch.Tensor,  # float32 [F]
    w: torch.Tensor,  # float32 [F]
    b: torch.Tensor,  # float32 []
    windows: Sequence[int] = (1, 7, 30),
    delay: int = 7,
    weekend_start: int = 5,
    night_end: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """State tables and slots → (probs [B], raw features [B, F]).

    CPU tensors go through :func:`fused_featurize_score_plain`. CUDA
    tensors launch the kernel on the current stream (no synchronisation)
    or raise; ``fused_featurize_score.launches`` counts the launches
    (one recorded into a CUDA graph, ``.captured``:
    ``ops/cuda_lib.py::count_launch``). The
    kernel reads the tables' rows by slot as they stand on the stream, so
    it sees the state that the stream's earlier update left; a slot
    outside [0, capacity) is the caller's error.
    """
    if day.device.type == "cpu":
        return fused_featurize_score_plain(
            customer, terminal, cust_slot, term_slot, day, tod_s, amount,
            valid, scaler_mean, scaler_scale, w, b, windows, delay,
            weekend_start, night_end)
    if day.device.type != "cuda":
        raise ValueError(f"no fused logreg kernel for {day.device}")
    dev = day.device
    n_win = len(windows)
    n_feat = 3 + 4 * n_win
    if not 1 <= n_win <= MAX_WINDOWS:
        raise ValueError(f"the kernel takes 1..{MAX_WINDOWS} windows, "
                         f"got {n_win}")
    bsz, nb = check_feature_inputs(customer, terminal, cust_slot, term_slot,
                                   day, tod_s, amount, dev)
    check_tensor(valid, "valid", torch.bool, (bsz,), dev)
    for name, tns in (("scaler_mean", scaler_mean),
                      ("scaler_scale", scaler_scale), ("w", w)):
        check_tensor(tns, name, torch.float32, (n_feat,), dev)
    check_tensor(b, "b", torch.float32, (), dev)
    probs = torch.empty(bsz, dtype=torch.float32, device=dev)
    feats = torch.empty((bsz, n_feat), dtype=torch.float32, device=dev)
    if bsz == 0:
        return probs, feats
    win = list(windows) + [0] * (MAX_WINDOWS - n_win)
    err = _library().fused_score_launch(
        *(x.data_ptr() for x in (
            customer.bucket_day, customer.count, customer.amount,
            terminal.bucket_day, terminal.count, terminal.fraud, cust_slot,
            term_slot, day, tod_s, amount, valid, scaler_mean, scaler_scale,
            w, b, probs, feats)),
        bsz, nb, n_feat, n_win, *win, delay, weekend_start, night_end,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused logreg kernel launch failed: CUDA error "
                           f"{err}")
    count_launch(fused_featurize_score)
    return probs, feats


fused_featurize_score.launches = 0
fused_featurize_score.captured = 0
