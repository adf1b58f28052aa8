"""DeepSeek-V2's expert layer (``models/deepseek_v2.py``): a float32
softmax router with greedy top-k, the routed SwiGLU experts as grouped
products, and the shared experts.

One call of :func:`moe` on N token rows:

1. the router: ``s = softmax(x @ router)`` in float32 over the E
   experts; the top k experts of each row and their raw scores (times
   ``routed_scale``) as weights, not renormalised (``norm_topk_prob``
   false);
2. the N·k token-slots sorted by expert (a stable sort of the expert
   ids), each expert's slot count and the running offsets kept on the
   device;
3. the routed experts as grouped products (``torch._grouped_mm``, whose
   offsets are a device tensor): each expert's gate and up projections
   over its slots, SwiGLU, then its down projection. Nothing reads the
   counts on the host, so a CUDA graph captures a step whose per-expert
   counts change every batch, and no expert is padded to the worst case;
4. the slots gathered back into token order and combined with their
   gate weights as one more product (a row's k weights times its k
   outputs), plus the shared experts (one SwiGLU of ``n_shared ·
   expert_width``).

The products run in the weights' dtype (bfloat16 on the card's served
path, float32 in the CPU tests) with float32 accumulation; the result is
float32. ``slots``, an int64 [E] tensor, gathers each expert's count of
the rows that ``real`` marks, in place, on the device.

``parallel/expert_parallel.py`` is the other expert layer of the port:
top-1 ReLU experts sharded over a mesh; this one holds every expert.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class MoEParams(NamedTuple):
    """One expert layer: the router, the routed experts' stacked
    projections and the shared experts'."""

    router: torch.Tensor  # f32 [D, E]
    w_gate: torch.Tensor  # [E, D, I]
    w_up: torch.Tensor  # [E, D, I]
    w_down: torch.Tensor  # [E, I, D]
    shared_gate: torch.Tensor  # [D, S]
    shared_up: torch.Tensor  # [D, S]
    shared_down: torch.Tensor  # [S, D]


def route(router: torch.Tensor, x: torch.Tensor, top_k: int,
          routed_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(weights f32 [N, k], experts int64 [N, k]): the softmax scores of
    ``x`` [N, D] over the experts in float32, the top ``k`` with their raw
    scores times ``routed_scale``."""
    scores = torch.softmax(x.float() @ router.float(), dim=-1)
    w, idx = torch.topk(scores, top_k, dim=-1)
    return w * routed_scale, idx


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """``silu(gate) * up``."""
    return F.silu(gate) * up


def grouped_mm(a: torch.Tensor, b: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """Rows ``offs[e-1]:offs[e]`` of ``a`` [M, K] times ``b[e]`` [K, N],
    for every group e: one grouped product whose group sizes stay on the
    device."""
    return torch._grouped_mm(a, b, offs=offs)


def moe(p: MoEParams, x: torch.Tensor, top_k: int, routed_scale: float,
        slots: Optional[torch.Tensor] = None,
        real: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The layer's output f32 [N, D] for normed rows ``x`` f32 [N, D];
    with ``slots``, each expert's count of the slots of the rows ``real``
    [N] (bool; None: every row) marks is added to it."""
    n, _ = x.shape
    n_exp = p.router.shape[1]
    w, idx = route(p.router, x, top_k, routed_scale)
    flat = idx.reshape(-1)  # [N·k], slot j of row t at t·k + j
    order = torch.argsort(flat, stable=True)
    counts = torch.zeros(n_exp, dtype=torch.int64, device=x.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    if slots is not None:
        mark = (torch.ones_like(flat) if real is None
                else real[:, None].expand(n, top_k).reshape(-1).long())
        slots.scatter_add_(0, flat, mark)
    offs = torch.cumsum(counts, 0).to(torch.int32)
    xc = x.to(p.w_gate.dtype)
    xs = xc[order // top_k]
    a = swiglu(grouped_mm(xs, p.w_gate, offs), grouped_mm(xs, p.w_up, offs))
    y = grouped_mm(a, p.w_down, offs)
    back = torch.empty_like(order)
    back[order] = torch.arange(order.numel(), device=x.device)
    y = y.index_select(0, back).view(n, top_k, -1)  # token order
    out = torch.bmm(w.to(y.dtype).unsqueeze(1), y)[:, 0]
    shared = swiglu(xc @ p.shared_gate, xc @ p.shared_up) @ p.shared_down
    return out.float() + shared.float()
