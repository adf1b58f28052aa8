"""The sequence step's serving transformer as one kernel: support, path
choice, plain version and the CUDA wrapper.

Replaces no TPU kernel: the JAX package computes the serving forward
(``models/sequence.py::transformer_last_logit``) as XLA ops outside
Pallas. The kernel, ``csrc/fused_sequence.cu``, was added for the history
step (``features/history.py::update_and_score``); its header says what
bounds it and what its design does about that.

- :func:`kernel_support` is the static predicate on the params' forms and
  the history length: ``None`` where the kernel computes the forward, else
  the reason it does not (d_model 32; n_heads 2; K ≤ 64;
  n_in ≤ 16; d_ff ≤ 128, the same in every block; 1 to 8 layers whose
  weights fit in a block's shared memory, sized by :func:`smem_bytes`;
  float32 leaves of the natural ranks, so no leading shard dims).
- :func:`serving_path` picks ``"fused"`` or ``"plain"`` from what the
  caller can observe: the device, the attention (only the naive one,
  ``attn_fn is None``), whether a gradient is needed, and the support.
- :func:`fused_last_logit_plain` is the plain version: the naive-attention
  ``transformer_last_logit``.
- :func:`fused_last_logit` is the wrapper: the plain version for CPU
  tensors; for CUDA tensors it launches the kernel or raises, and counts
  the launches on itself. It reads the params by pointer where
  ``TransformerParams`` keeps them, so a swap that copies leaves in place
  reaches the kernel, and a captured graph, with nothing re-derived.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    TransformerParams,
    transformer_last_logit,
)
from real_time_fraud_detection_system_tpu_torch.ops.cuda_lib import (
    CSRC,
    check_tensor,
    count_launch,
    load_library,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

SOURCE = CSRC / "fused_sequence.cu"
# The widths the kernel takes; kD, kHeads, kMaxK, kMaxIn, kMaxFF and
# kMaxLayers in csrc/fused_sequence.cu (one head count is built: each
# instance adds ~8 s to the build).
D_MODEL = 32
N_HEADS = 2
MAX_K = 64
MAX_IN = 16
MAX_FF = 128
MAX_LAYERS = 8
# Threads per block, floats per position row of scratch and the most
# shared memory a block may opt in to on sm_90: kMaxThreads, kRow,
# kMaxSmem.
MAX_THREADS = 384
ROW_FLOATS = 36
SMEM_BUDGET = 227 * 1024
PATHS = ("fused", "plain")


def _ceil(n: int, m: int) -> int:
    return -(-n // m) * m


def _floats(n_in: int, n_layers: int, d_ff: int, k: int,
            n_heads: int) -> tuple:
    """(weight floats, floats per tile row, threads per row) of
    ``layout`` in ``csrc/fused_sequence.cu``."""
    d, ff = D_MODEL, _ceil(d_ff, 32)
    kt = 32 if k <= 32 else 64
    layer = 2 * d + 4 * d * d + 2 * d + 65 * ff + d
    weights = _ceil(n_in, 4) * d + d + n_layers * layer + 100
    per_row = kt * 3 * ROW_FLOATS + 4 * d + n_heads * kt + ff
    return weights, per_row, kt


def tile_rows(n_in: int, n_layers: int, d_ff: int, k: int,
              n_heads: int) -> int:
    """Histories per tile (per block) at these widths; 0 where the
    weights and one tile row do not fit in a block's shared memory."""
    weights, per_row, kt = _floats(n_in, n_layers, d_ff, k, n_heads)
    room = SMEM_BUDGET // 4 - weights
    return max(0, min(MAX_THREADS // kt, room // per_row))


def smem_bytes(n_in: int, n_layers: int, d_ff: int, k: int,
               n_heads: int) -> int:
    """Shared-memory bytes of one block: the weights and the tile's
    scratch (three position rows per thread, and per row the last
    block's vectors)."""
    weights, per_row, _ = _floats(n_in, n_layers, d_ff, k, n_heads)
    return 4 * (weights + tile_rows(n_in, n_layers, d_ff, k, n_heads)
                * per_row)


def _shape_reason(name: str, t, shape: tuple) -> Optional[str]:
    if not isinstance(t, torch.Tensor):
        return f"{name} is not a tensor"
    if t.dtype != torch.float32:
        return f"{name} is {t.dtype}, the kernel takes float32"
    if tuple(t.shape) != shape:
        return f"{name} has shape {tuple(t.shape)}, the kernel takes {shape}"
    return None


def kernel_support(params, k: int, attn_fn=None) -> Optional[str]:
    """``None`` where the kernel computes ``transformer_last_logit(params,
    hist [B, k, n_in], qpos, attn_fn)``; else why it does not. Looks at
    forms only, never at values or devices."""
    if attn_fn is not None:
        return "attention other than the naive causal one"
    if not isinstance(params, TransformerParams) or not params.blocks:
        return "params are not a TransformerParams with blocks"
    n_layers = len(params.blocks)
    if n_layers > MAX_LAYERS:
        return f"{n_layers} layers, the kernel takes at most {MAX_LAYERS}"
    ew = params.embed_w
    if not isinstance(ew, torch.Tensor) or ew.dim() != 2:
        return "embed_w is not [n_in, d_model] (leading shard dims?)"
    n_in, d = ew.shape
    if d != D_MODEL:
        return f"d_model {d}, the kernel takes {D_MODEL}"
    if not 1 <= n_in <= MAX_IN:
        return f"n_in {n_in}, the kernel takes 1..{MAX_IN}"
    if not 1 <= k <= MAX_K:
        return f"history length {k}, the kernel takes 1..{MAX_K}"
    wq = params.blocks[0].wq
    if not isinstance(wq, torch.Tensor) or wq.dim() != 3:
        return "wq is not [d_model, n_heads, d_head] (leading shard dims?)"
    h = int(wq.shape[1])
    if h != N_HEADS or h * int(wq.shape[2]) != d:
        return f"n_heads {h}, the kernel takes {N_HEADS} dividing d_model"
    w1 = params.blocks[0].w1
    if not isinstance(w1, torch.Tensor) or w1.dim() != 2:
        return "w1 is not [d_model, d_ff] (leading shard dims?)"
    ff = int(w1.shape[1])
    if not 1 <= ff <= MAX_FF:
        return f"d_ff {ff}, the kernel takes 1..{MAX_FF}"
    dh = d // h
    want = [("embed_w", ew, (n_in, d)), ("embed_b", params.embed_b, (d,)),
            ("lnf_g", params.lnf_g, (d,)), ("lnf_b", params.lnf_b, (d,)),
            ("head_w", params.head_w, (d, 1)),
            ("head_b", params.head_b, (1,))]
    for i, b in enumerate(params.blocks):
        want += [(f"blocks[{i}].{n}", getattr(b, n), s) for n, s in (
            ("ln1_g", (d,)), ("ln1_b", (d,)), ("wq", (d, h, dh)),
            ("wk", (d, h, dh)), ("wv", (d, h, dh)), ("wo", (h, dh, d)),
            ("ln2_g", (d,)), ("ln2_b", (d,)), ("w1", (d, ff)),
            ("b1", (ff,)), ("w2", (ff, d)), ("b2", (d,)))]
    for name, t, shape in want:
        reason = _shape_reason(name, t, shape)
        if reason:
            return reason
    if tile_rows(n_in, n_layers, ff, k, h) < 1:
        return (f"{n_layers} layers at d_ff {ff} do not fit in a block's "
                f"shared memory")
    return None


def needs_grad(params) -> bool:
    """Whether autograd would record the forward: grad mode is on and a
    param leaf requires a gradient (the history never does)."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree.leaves(params))


def serving_path(params, device, k: int, attn_fn=None,
                 grad: bool = False) -> str:
    """``"fused"`` where the kernel serves the forward on ``device``: a
    CUDA device, naive attention, no gradient, and forms the kernel
    supports; ``"plain"`` everywhere else."""
    if torch.device(device).type != "cuda" or grad:
        return "plain"
    return "plain" if kernel_support(params, k, attn_fn) else "fused"


def fused_last_logit_plain(params: TransformerParams, hist: torch.Tensor,
                           qpos: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``transformer_last_logit`` with naive causal
    attention, [B] float32."""
    return transformer_last_logit(params, hist, qpos)


def _param_ptrs(params: TransformerParams) -> list:
    """The leaves in the order ``fused_sequence_launch`` reads them."""
    out = [params.embed_w, params.embed_b, params.lnf_g, params.lnf_b,
           params.head_w, params.head_b]
    for b in params.blocks:
        out += list(b)
    return out


@functools.lru_cache(maxsize=None)
def _library(source=SOURCE) -> ctypes.CDLL:
    lib = load_library(source)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_sequence_launch.argtypes = [p, p, p, i, p] + [i] * 6 + [p]
    lib.fused_sequence_launch.restype = i
    for name in ("d_model", "heads", "max_k", "max_in", "max_ff",
                 "max_layers"):
        getattr(lib, f"fused_sequence_{name}").argtypes = []
        getattr(lib, f"fused_sequence_{name}").restype = i
    for name in ("rows", "smem_bytes"):
        getattr(lib, f"fused_sequence_{name}").argtypes = [i] * 5
        getattr(lib, f"fused_sequence_{name}").restype = i
    same = ((lib.fused_sequence_d_model(), lib.fused_sequence_heads(),
             lib.fused_sequence_max_k(), lib.fused_sequence_max_in(),
             lib.fused_sequence_max_ff(), lib.fused_sequence_max_layers())
            == (D_MODEL, N_HEADS, MAX_K, MAX_IN, MAX_FF, MAX_LAYERS))
    for shape in ((8, 2, 64, 32, 2), (8, 3, 64, 64, 2), (16, 6, 128, 16, 2)):
        same = same and (lib.fused_sequence_rows(*shape) == tile_rows(*shape)
                         and lib.fused_sequence_smem_bytes(*shape)
                         == smem_bytes(*shape))
    if not same:
        raise RuntimeError(f"csrc/{source.name} and ops/sequence_kernels.py "
                           f"disagree on the widths or the block layout")
    return lib


def fused_last_logit(params: TransformerParams, hist: torch.Tensor,
                     qpos: torch.Tensor) -> torch.Tensor:
    """Histories ``hist`` [B, K, n_in] and positions ``qpos`` [B] → the
    logit at each row's ``qpos``, [B] float32: exactly
    ``transformer_last_logit(params, hist, qpos)`` with naive causal
    attention.

    CPU tensors go through :func:`fused_last_logit_plain`. CUDA tensors
    launch the kernel on the current stream (no synchronisation) or raise:
    ``ValueError`` for forms outside :func:`kernel_support` or tensors it
    does not take; ``fused_last_logit.launches`` counts the launches (one
    recorded into a CUDA graph, ``.captured``:
    ``ops/cuda_lib.py::count_launch``). A ``qpos`` outside [0, K) is the
    caller's error; the kernel writes NaN for that row."""
    if hist.device.type == "cpu":
        return fused_last_logit_plain(params, hist, qpos)
    if hist.device.type != "cuda":
        raise ValueError(f"no fused sequence kernel for {hist.device}")
    if hist.dim() != 3:
        raise ValueError(f"hist: expected [B, K, n_in], got "
                         f"{tuple(hist.shape)}")
    bsz, k, n_in = hist.shape
    reason = kernel_support(params, k)
    if reason:
        raise ValueError(f"the fused sequence kernel does not take these "
                         f"params: {reason}")
    dev = hist.device
    check_tensor(hist, "hist", torch.float32, (bsz, k, n_in), dev)
    if int(params.embed_w.shape[0]) != n_in:
        raise ValueError(f"hist has {n_in} channels, embed_w takes "
                         f"{int(params.embed_w.shape[0])}")
    if qpos.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"qpos: expected an integer [B], got {qpos.dtype}")
    q32 = qpos.to(torch.int32).contiguous()
    check_tensor(q32, "qpos", torch.int32, (bsz,), dev)
    leaves = _param_ptrs(params)
    for i, t in enumerate(leaves):
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"param leaf {i}: expected contiguous on {dev}, "
                             f"got {t.device}"
                             f"{'' if t.is_contiguous() else ' (strided)'}")
    out = torch.empty(bsz, dtype=torch.float32, device=dev)
    if bsz == 0:
        return out
    ptrs = (ctypes.c_void_p * len(leaves))(*(t.data_ptr() for t in leaves))
    err = _library().fused_sequence_launch(
        hist.data_ptr(), q32.data_ptr(), ptrs, len(leaves), out.data_ptr(),
        bsz, k, n_in, len(params.blocks), int(params.blocks[0].w1.shape[1]),
        int(params.blocks[0].wq.shape[1]),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused sequence kernel launch failed: CUDA "
                           f"error {err}")
    count_launch(fused_last_logit)
    return out


fused_last_logit.launches = 0
fused_last_logit.captured = 0
