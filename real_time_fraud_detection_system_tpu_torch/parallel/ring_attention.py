"""Blockwise (online-softmax) attention — port of the single-device part
of the JAX package's ``parallel/ring_attention.py``.

``blockwise_attention`` (causal, the one form the sequence step uses)
visits the keys and values in blocks and folds each into a running ``(m, l, o)`` — row max, row sum and unnormalized
output, all float32 — with the Flash-Attention recurrence, so the score
memory is ``[B, H, T, block]`` instead of ``[B, H, T, T]``. The
arithmetic is the JAX function's, guards included: a fully masked block
keeps the old statistics (``m_safe``, ``p`` zeroed where the score is
``-inf``, ``alpha`` zero while ``m`` is still ``-inf``), ``l`` is floored
at ``1e-30`` before the division, and the padded keys of the last block
sit at positions past every query, so the causal mask drops them.

The products are plain ``torch.einsum``: the JAX package computes them as
XLA ops outside any Pallas kernel. A Hopper attention kernel for the
sequence step is an open item of ROADMAP. Ring and Ulysses attention
(sequence parallel over a mesh) wait for ROADMAP A7d.
"""

from __future__ import annotations

import math
import torch


def _block_attn(q, k, v, m, l, o, q_off: int, k_off: int, sm_scale: float):
    """One causal online-softmax step against a K/V block.

    q: [B, Tq, H, D]; k/v: [B, Tk, H, D]; (m, l): [B, H, Tq] and o:
    [B, Tq, H, D], float32. ``q_off``/``k_off`` are the blocks' position
    offsets for the causal mask. Returns the updated (m, l, o).
    """
    tq, tk = q.shape[1], k.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    kpos = k_off + torch.arange(tk, dtype=torch.int32, device=q.device)
    qpos = q_off + torch.arange(tq, dtype=torch.int32, device=q.device)
    mask = qpos[:, None] >= kpos[None, :]  # [Tq, Tk]
    # masked_fill and *_like zeros: no host-to-device scalar copy (a sync)
    s = s.masked_fill(~mask[None, None, :, :], -math.inf)
    m_blk = torch.amax(s, dim=-1)  # [B, H, Tq]
    m_new = torch.maximum(m, m_blk)
    # a fully masked block has m_blk = -inf: keep the old statistics
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    p = torch.exp(s - m_safe[..., None])  # [B, H, Tq, Tk]
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    l_new = l * alpha + torch.sum(p, dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * alpha.permute(0, 2, 1)[..., None] + pv
    return m_new, l_new, o_new


def _finalize(m, l, o, dtype):
    denom = torch.clamp(l, min=1e-30).permute(0, 2, 1)[..., None]
    return (o / denom).to(dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512) -> torch.Tensor:
    """Single-device causal online-softmax attention, ``[B, T, H, D]``
    layout, scaled by ``1/sqrt(D)``."""
    b, t, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    nblk = max(1, -(-t // block_size))
    tpad = nblk * block_size
    if tpad != t:
        # padded keys never win the softmax: the causal offsets put them
        # past every query
        pad = (0, 0, 0, 0, 0, tpad - t)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    dev = q.device
    m = torch.full((b, h, t), -math.inf, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    o = torch.zeros((b, t, h, d), dtype=torch.float32, device=dev)
    for i in range(nblk):
        lo = i * block_size
        m, l, o = _block_attn(
            q, k[:, lo:lo + block_size], v[:, lo:lo + block_size], m, l, o,
            q_off=0, k_off=lo, sm_scale=scale)
    return _finalize(m, l, o, q.dtype)


def ring_attention(*args, **kwargs):
    """Sequence-parallel attention over a device ring: ROADMAP A7d."""
    raise NotImplementedError(
        "ring attention (sequence parallel over a mesh) is not ported "
        "yet: ROADMAP A7d")


def ulysses_attention(*args, **kwargs):
    """All-to-all head-parallel attention: ROADMAP A7d."""
    raise NotImplementedError(
        "Ulysses attention (head parallel over a mesh) is not ported yet: "
        "ROADMAP A7d")
