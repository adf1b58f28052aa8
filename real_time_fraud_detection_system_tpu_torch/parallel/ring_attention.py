"""Blockwise, ring and Ulysses attention — port of the JAX package's
``parallel/ring_attention.py``.

``blockwise_attention`` visits the keys and values in blocks and folds
each into a running ``(m, l, o)`` — row max, row sum and unnormalized
output, all float32 whatever the inputs' dtype — with the Flash-Attention
recurrence, so the score memory is ``[B, H, T, block]`` instead of
``[B, H, T, T]``. The arithmetic is the JAX function's, guards included:
a fully masked block keeps the old statistics (``m_safe``, ``p`` zeroed
where the score is ``-inf``, ``alpha`` zero while ``m`` is still
``-inf``), ``l`` is floored at ``1e-30`` before the division; the padded
keys of the last block sit past every query, so the causal mask drops
them, and a non-causal call masks them by position (``kv_limit``).

The sequence-parallel forms shard the sequence axis over a mesh axis of
``n`` shards, shard j holding rows ``[j·T_local, (j+1)·T_local)``. The
shards share one device (``parallel/mesh.py``), so a shard axis is the
leading axis of a stacked ``[n, B, T_local, H, D]`` tensor and the JAX
collectives become tensor moves on it:

- :func:`ring_attention`: every shard keeps its queries and folds one K/V
  block per step, ``n`` steps; the ring's ``ppermute`` (shard j's block
  to shard j+1) is a ``torch.roll`` of the K/V stack along the shard
  axis. At step i shard j holds the block of shard ``(j - i) mod n``,
  whose global positions drive the causal mask;
- :func:`ulysses_attention` (the DeepSpeed-Ulysses form): the first
  all-to-all turns the sequence-sharded q/k/v, stacked into one ``[3,
  ...]`` tensor, into head-sharded ones holding the whole sequence (a
  reshape and a transpose), each head group runs
  :func:`blockwise_attention`, and the inverse all-to-all restores the
  sequence-sharded layout. It needs ``n_heads % n == 0``; the ring takes
  any head count.

:func:`make_ring_attention_sharded` and :func:`make_ulysses_attention_sharded`
take and return global ``[B, T, H, D]`` tensors, so the two forms are
interchangeable (``models/sequence.py::make_sp_logits_fn`` runs the
transformer through the ring). The products are plain ``torch.einsum``:
the JAX package computes attention as XLA ops outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _positions(off, t: int, device) -> torch.Tensor:
    """Global positions of a block of ``t`` rows at offset ``off``: an int
    (``[t]``) or one offset per shard (``[n]`` → ``[n, t]``)."""
    ar = torch.arange(t, dtype=torch.int32, device=device)
    if isinstance(off, torch.Tensor):
        return off.to(torch.int32)[:, None] + ar
    return off + ar


def _block_attn(q, k, v, m, l, o, q_off, k_off, sm_scale: float,
                causal: bool, kv_limit: Optional[int] = None):
    """One online-softmax step against a K/V block.

    q: ``[..., Tq, H, D]`` (resident); k/v: ``[..., Tk, H, D]`` (the
    visiting block); (m, l): ``[..., H, Tq]`` and o: ``[..., Tq, H, D]``,
    float32. The leading dims are ``[B]``, or ``[n, B]`` for stacked
    shards, whose ``q_off``/``k_off`` are then ``[n]`` tensors.
    ``kv_limit`` masks keys at global position ``>= kv_limit`` (the padded
    tail). Returns the updated (m, l, o).
    """
    tq, tk = q.shape[-3], k.shape[-3]
    s = torch.einsum("...qhd,...khd->...hqk", q.float(),
                     k.float()) * sm_scale
    kpos = _positions(k_off, tk, q.device)
    stacked = kpos.dim() == 2
    if causal:
        qpos = _positions(q_off, tq, q.device)
        mask = qpos[..., :, None] >= kpos[..., None, :]  # [n?, Tq, Tk]
        # masked_fill: no host-to-device scalar copy (a sync)
        s = s.masked_fill(~(mask[:, None, None] if stacked
                            else mask[None, None]), -math.inf)
    if kv_limit is not None:
        keep = kpos < kv_limit  # [n?, Tk]
        s = s.masked_fill(~(keep[:, None, None, None] if stacked
                            else keep), -math.inf)
    m_blk = torch.amax(s, dim=-1)  # [..., H, Tq]
    m_new = torch.maximum(m, m_blk)
    # a fully masked block has m_blk = -inf: keep the old statistics
    m_safe = torch.where(torch.isfinite(m_new), m_new,
                         torch.zeros_like(m_new))
    p = torch.exp(s - m_safe[..., None])  # [..., H, Tq, Tk]
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                        torch.zeros_like(m))
    l_new = l * alpha + torch.sum(p, dim=-1)
    pv = torch.einsum("...hqk,...khd->...qhd", p, v.float())
    o_new = o * alpha.transpose(-1, -2)[..., None] + pv
    return m_new, l_new, o_new


def _finalize(m, l, o, dtype):
    denom = torch.clamp(l, min=1e-30).transpose(-1, -2)[..., None]
    return (o / denom).to(dtype)


def _init_stats(lead: tuple, t: int, h: int, d: int, device):
    """The empty (m, l, o) of ``lead`` rows of ``t`` queries."""
    m = torch.full(lead + (h, t), -math.inf, dtype=torch.float32,
                   device=device)
    l = torch.zeros(lead + (h, t), dtype=torch.float32, device=device)
    o = torch.zeros(lead + (t, h, d), dtype=torch.float32, device=device)
    return m, l, o


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        block_size: int = 512, causal: bool = True,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """Single-device flash-style attention, ``[B, T, H, D]`` layout,
    scaled by ``sm_scale`` (default ``1/sqrt(D)``)."""
    b, t, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    nblk = max(1, -(-t // block_size))
    tpad = nblk * block_size
    if tpad != t:
        # padded keys never win the softmax: the causal offsets put them
        # past every query; the non-causal form masks them by kv_limit
        pad = (0, 0, 0, 0, 0, tpad - t)
        k = torch.nn.functional.pad(k, pad)
        v = torch.nn.functional.pad(v, pad)
    m, l, o = _init_stats((b,), t, h, d, q.device)
    for i in range(nblk):
        lo = i * block_size
        m, l, o = _block_attn(
            q, k[:, lo:lo + block_size], v[:, lo:lo + block_size], m, l, o,
            q_off=0, k_off=lo, sm_scale=scale, causal=causal,
            kv_limit=None if causal else t)
    return _finalize(m, l, o, q.dtype)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Sequence-parallel attention over a ring of co-located shards.

    q/k/v: ``[n, B, T_local, H, D]``, shard j holding global rows
    ``[j·T_local, (j+1)·T_local)``; returns the output in that layout. At
    step i shard j folds in the K/V block first owned by shard ``(j - i)
    mod n``, then every shard passes its block to the next (``torch.roll``
    along the shard axis): ``n`` steps visit every block."""
    n, b, tl, h, d = q.shape
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    idx = torch.arange(n, dtype=torch.int32, device=q.device)
    m, l, o = _init_stats((n, b), tl, h, d, q.device)
    kb, vb = k, v
    for i in range(n):
        src = torch.remainder(idx - i, n)  # owner of the visiting block
        m, l, o = _block_attn(q, kb, vb, m, l, o, q_off=idx * tl,
                              k_off=src * tl, sm_scale=scale, causal=causal)
        if i + 1 < n:
            kb, vb = torch.roll(kb, 1, 0), torch.roll(vb, 1, 0)
    return _finalize(m, l, o, q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True,
                      block_size: int = 512) -> torch.Tensor:
    """All-to-all sequence parallelism (the DeepSpeed-Ulysses form) over
    co-located shards: q/k/v ``[n, B, T_local, H, D]`` in, the same layout
    out.

    The first exchange re-shards the stacked ``[3, ...]`` q/k/v from
    sequence-sharded to head-sharded: shard c receives head group c of
    every shard's rows, in shard order along T (the global order). Each
    group then runs :func:`blockwise_attention` over the whole sequence,
    and the inverse exchange restores the sequence-sharded layout. The
    trade against the ring: two all-to-alls of activation size instead of
    ``n`` block hops, and ``n_heads`` must divide by ``n``."""
    n, b, tl, h, d = q.shape
    if h % n:
        raise ValueError(
            f"ulysses_attention needs n_heads ({h}) divisible by the "
            f"mesh axis size ({n}); use ring_attention otherwise")
    hl = h // n
    # [3, src, B, Tl, c, hl, D] → [3, c, B, src, Tl, hl, D]: head group c
    # of every source, sources in order along the sequence
    qkv = torch.stack((q, k, v)).reshape(3, n, b, tl, n, hl, d)
    qkv = qkv.permute(0, 4, 2, 1, 3, 5, 6).reshape(3, n * b, n * tl, hl, d)
    out = blockwise_attention(qkv[0], qkv[1], qkv[2], block_size=block_size,
                              causal=causal)
    # [c, B, src, Tl, hl, D] → [src, B, Tl, c, hl, D]: the inverse
    out = out.reshape(n, b, n, tl, hl, d).permute(2, 1, 3, 0, 4, 5)
    return out.reshape(n, b, tl, h, d)


def _make_seq_sharded_attn(kernel, mesh, axis: str):
    """The wrapper shared by the sequence-parallel forms: ``fn(q, k, v)``
    on global ``[B, T, H, D]`` tensors (T divisible by the axis size),
    computed as ``kernel`` over the stacked ``[n, B, T/n, H, D]`` shards on
    the mesh's device, returned global. One factory keeps the ring and
    Ulysses contracts interchangeable."""
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        axis_size,
        mesh_device,
    )

    n = axis_size(mesh, axis)
    dev = mesh_device(mesh)

    def fn(q, k, v):
        b, t, h, d = q.shape
        if t % n:
            raise ValueError(
                f"sequence length {t} does not divide over the {n} "
                f"shards of axis {axis!r}")

        def split(x):
            return x.to(dev).reshape(b, n, t // n, h, d).transpose(0, 1)

        out = kernel(split(q), split(k), split(v))
        return out.transpose(0, 1).reshape(b, t, h, d)

    return fn


def make_ring_attention_sharded(mesh, axis: str = "data",
                                causal: bool = True):
    """Ring form of the sequence-parallel attention wrapper (see
    :func:`_make_seq_sharded_attn`)."""
    return _make_seq_sharded_attn(
        lambda q, k, v: ring_attention(q, k, v, causal=causal), mesh, axis)


def make_ulysses_attention_sharded(mesh, axis: str = "data",
                                   causal: bool = True,
                                   block_size: int = 512):
    """Ulysses form of the sequence-parallel attention wrapper, with the
    contract of :func:`make_ring_attention_sharded`."""
    return _make_seq_sharded_attn(
        lambda q, k, v: ulysses_attention(q, k, v, causal=causal,
                                          block_size=block_size),
        mesh, axis)
