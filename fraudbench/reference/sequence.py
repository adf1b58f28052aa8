"""Plain reference of the sequence scorer: each row's causal history and
the transformer's score at the row's own event. Plain PyTorch; nothing of
the program under test.

- **History.** A card's events in stream order: by batch, then time of
  day, then place in the batch. A row's history is its card's events up
  to and including itself, the last ``K`` of them, left-aligned with the
  row's own event last.
- **Event channels** (8): ``log1p(amount)``, ``amount / 100``,
  ``log1p(Δt) / 10`` with Δt the seconds since the card's previous event
  (0 for a card's first event and for the first event of the window),
  ``sin``/``cos`` of the time of day and of the weekday
  (``((day + 3) mod 7) / 7``) as phases of 2π, and 1.
- **Transformer** (pre-LN, causal): an embedding, ``n_layers`` blocks of
  layer norm (biased variance, ``ε = 1e-6``), multi-head attention with
  scores scaled by ``1/sqrt(head_dim)`` and a residual, layer norm, a
  tanh-GELU MLP and a residual; a final layer norm and a linear head. The
  logit at the row's own position, through a sigmoid, is its score.

``dtype`` is float32 as the configuration states (TF32 off), or
bfloat16 for the control.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_float32():
    """Matrix products in true float32 while the reference runs."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def histories(cust: torch.Tensor, batch: torch.Tensor, tod: torch.Tensor,
              day: torch.Tensor, amount: torch.Tensor, rows: torch.Tensor,
              k: int):
    """The histories of stream rows ``rows`` (indices into the stream's
    columns, all int64/float32 [n] in stream order). Returns (events
    float64 [m, K, 8], length int64 [m])."""
    order = torch.arange(cust.shape[0], device=cust.device)
    for key in (tod, batch, cust):  # last key first: stable sorts
        order = order[torch.sort(key[order], stable=True).indices]
    rank_of = torch.empty_like(order)
    rank_of[order] = torch.arange(order.shape[0], device=order.device)
    s_cust = cust[order]
    t_s = (day * 86400 + tod)[order]
    first = torch.ones_like(s_cust, dtype=torch.bool)
    first[1:] = s_cust[1:] != s_cust[:-1]
    idx = torch.arange(order.shape[0], device=order.device)
    seg_start = torch.cummax(torch.where(first, idx, torch.zeros_like(idx)),
                             0).values
    r = rank_of[rows]
    length = torch.clamp(r - seg_start[r] + 1, max=k)
    j = torch.arange(k, device=r.device)[None, :]
    src = r[:, None] - (length[:, None] - 1) + j  # [m, K] sorted positions
    real = j < length[:, None]
    src = torch.where(real, src, r[:, None])
    prev_t = torch.where(first, t_s, torch.roll(t_s, 1))
    dt = (t_s - prev_t).to(torch.float64)[src]
    dt[:, 0] = 0.0
    a = amount[order][src].to(torch.float64)
    tod_f = (tod[order][src].to(torch.float64)) / 86400.0
    wd = ((day[order][src] + 3) % 7).to(torch.float64) / 7.0
    two_pi = 2.0 * math.pi
    ev = torch.stack([torch.log1p(a.clamp(min=0.0)), a / 100.0,
                      torch.log1p(dt.clamp(min=0.0)) / 10.0,
                      torch.sin(two_pi * tod_f), torch.cos(two_pi * tod_f),
                      torch.sin(two_pi * wd), torch.cos(two_pi * wd),
                      torch.ones_like(a)], dim=2)
    return torch.where(real[..., None], ev, torch.zeros_like(ev)), length


def _ln(x, g, b):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * g + b


def logits(params: Dict[str, torch.Tensor], x: torch.Tensor,
           n_layers: int) -> torch.Tensor:
    """Per-position logits [m, K] of ``x`` [m, K, 8] (causal)."""
    t = x.shape[1]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    h = x @ params["embed_w"] + params["embed_b"]
    for i in range(n_layers):
        p = {k[len(f"b{i}."):]: v for k, v in params.items()
             if k.startswith(f"b{i}.")}
        hn = _ln(h, p["ln1_g"], p["ln1_b"])
        q = torch.einsum("btd,dhe->bhte", hn, p["wq"])
        kk = torch.einsum("btd,dhe->bhte", hn, p["wk"])
        v = torch.einsum("btd,dhe->bhte", hn, p["wv"])
        s = q @ kk.transpose(-1, -2) / math.sqrt(q.shape[-1])
        s = s.masked_fill(~mask, -math.inf)
        o = torch.softmax(s, dim=-1) @ v  # [m, H, T, dh]
        h = h + torch.einsum("bhte,hed->btd", o, p["wo"])
        hn = _ln(h, p["ln2_g"], p["ln2_b"])
        h = h + F.gelu(hn @ p["w1"] + p["b1"], approximate="tanh") @ p["w2"] \
            + p["b2"]
    h = _ln(h, params["lnf_g"], params["lnf_b"])
    return (h @ params["head_w"] + params["head_b"])[..., 0]


def sequence_probs(params: Dict[str, torch.Tensor], events: torch.Tensor,
                   length: torch.Tensor, n_layers: int,
                   dtype=torch.float32, block: int = 8192) -> torch.Tensor:
    """float64 [m] scores at each history's last real position."""
    p = {k: v.to(dtype) for k, v in params.items()}
    out = []
    with full_float32():
        for s in range(0, events.shape[0], block):
            lg = logits(p, events[s:s + block].to(dtype), n_layers)
            at = (length[s:s + block] - 1)[:, None]
            out.append(torch.sigmoid(torch.gather(lg, 1, at)[:, 0]
                                     .to(torch.float64)))
    return torch.cat(out)
