"""Sequence model family — port of the JAX package's
``models/sequence.py``: a pre-LN causal transformer over per-customer
event histories, and the host-side sequence assembly its oracle needs.

- :func:`event_features` and :func:`build_sequences` are host numpy, as
  in the JAX package: the per-event channels (amount, inter-arrival time,
  time-of-day and weekday phases, presence) and the padded per-customer
  histories ``build_sequences`` groups them into.
- ``BlockParams`` and ``TransformerParams`` are the JAX pytree forms
  (NamedTuples, the blocks a tuple), so checkpoints, artifacts and the
  registry walk them as they walk every other kind (``utils/tree.py``).
- The arithmetic mirrors the JAX functions: layer-norm statistics in
  float32 with the biased variance as the mean of squares and
  ``rsqrt(var + 1e-6)``; GELU in its tanh form (``jax.nn.gelu``'s
  default); attention scores and softmax in float32; ``-inf`` on masked
  scores.

The products are plain ``torch.matmul``/``einsum``: the JAX package
computes them as XLA ops outside any Pallas kernel. Training
(:func:`train_transformer`) is minibatch Adam (``models/optim.py``) on the
masked, ``pos_weight``-weighted BCE of every real event
(:func:`transformer_loss`), with naive or blockwise attention;
:func:`sequence_scores` scores every real event of a
:class:`SequenceBatch`. :func:`make_sp_logits_fn` is the sequence-parallel
forward (ring attention over a mesh axis), and ``transformer_logits`` takes
the tensor-parallel hooks (``reduce_fn``, ``enter_fn``) that
``parallel/tensor_parallel.py`` passes.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.models.metrics import (
    rebalance_pos_weight,
)
from real_time_fraud_detection_system_tpu_torch.models.optim import Adam
from real_time_fraud_detection_system_tpu_torch.parallel.ring_attention \
    import blockwise_attention

N_EVENT_FEATURES = 8


# ---------------------------------------------------------------------------
# host-side sequence assembly
# ---------------------------------------------------------------------------


def event_features(amount: np.ndarray, t_s: np.ndarray) -> np.ndarray:
    """Per-event feature vector [T, 8] from (amount, epoch-seconds)."""
    dt = np.diff(t_s, prepend=t_s[:1]).astype(np.float64)
    tod = (t_s % 86400) / 86400.0
    weekday = ((t_s // 86400 + 3) % 7) / 7.0
    f = np.stack(
        [
            np.log1p(np.maximum(amount, 0.0)),
            amount / 100.0,
            np.log1p(np.maximum(dt, 0.0)) / 10.0,
            np.sin(2 * np.pi * tod),
            np.cos(2 * np.pi * tod),
            np.sin(2 * np.pi * weekday),
            np.cos(2 * np.pi * weekday),
            np.ones_like(tod),  # bias/presence channel
        ],
        axis=1,
    )
    return f.astype(np.float32)


class SequenceBatch(NamedTuple):
    """Padded per-customer histories ([N, T, F] x/[N, T] y, mask)."""

    x: np.ndarray  # float32 [N, T, N_EVENT_FEATURES]
    y: np.ndarray  # int32 [N, T] — fraud label per event (0 where padded)
    mask: np.ndarray  # bool [N, T] — real event?
    customer_id: np.ndarray  # int64 [N]
    tx_index: np.ndarray  # int64 [N, T] — row index into the table, -1 pad


def build_sequences(txs: Transactions, max_len: int = 128, min_len: int = 2,
                    features: Optional[np.ndarray] = None,
                    start_epoch_s: int = 0) -> SequenceBatch:
    """Group transactions by customer, time-sorted, pad/truncate to
    ``max_len`` (truncation keeps the LAST ``max_len`` events).
    ``features`` ([txs.n, F]) are concatenated onto the event channels;
    ``start_epoch_s`` anchors the table's relative times to epoch time (the
    serving history computes its phases from absolute timestamps)."""
    n_in = N_EVENT_FEATURES + (features.shape[1] if features is not None
                               else 0)
    order = np.lexsort((txs.tx_time_seconds, txs.customer_id))
    cust = txs.customer_id[order]
    uniq, starts = np.unique(cust, return_index=True)
    ends = np.r_[starts[1:], len(cust)]

    xs, ys, ms, cids, idxs = [], [], [], [], []
    for u, s, e in zip(uniq, starts, ends):
        if e - s < min_len:
            continue
        sel = order[s:e][-max_len:]
        n = len(sel)
        f = event_features(
            txs.amount_cents[sel] / 100.0,
            txs.tx_time_seconds[sel].astype(np.int64) + start_epoch_s,
        )
        if features is not None:
            f = np.concatenate([f, features[sel].astype(np.float32)], axis=1)
        x = np.zeros((max_len, n_in), dtype=np.float32)
        y = np.zeros(max_len, dtype=np.int32)
        m = np.zeros(max_len, dtype=bool)
        ix = np.full(max_len, -1, dtype=np.int64)
        x[:n] = f
        y[:n] = txs.tx_fraud[sel]
        m[:n] = True
        ix[:n] = sel
        xs.append(x)
        ys.append(y)
        ms.append(m)
        cids.append(u)
        idxs.append(ix)
    return SequenceBatch(
        x=np.stack(xs) if xs else np.zeros((0, max_len, n_in), np.float32),
        y=np.stack(ys) if ys else np.zeros((0, max_len), np.int32),
        mask=np.stack(ms) if ms else np.zeros((0, max_len), bool),
        customer_id=np.asarray(cids, dtype=np.int64),
        tx_index=np.stack(idxs) if idxs else np.zeros((0, max_len), np.int64),
    )


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


class BlockParams(NamedTuple):
    ln1_g: torch.Tensor
    ln1_b: torch.Tensor
    wq: torch.Tensor  # [D, H, Dh]
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor  # [H, Dh, D]
    ln2_g: torch.Tensor
    ln2_b: torch.Tensor
    w1: torch.Tensor  # [D, F]
    b1: torch.Tensor
    w2: torch.Tensor  # [F, D]
    b2: torch.Tensor


class TransformerParams(NamedTuple):
    embed_w: torch.Tensor  # [N_EVENT_FEATURES, D]
    embed_b: torch.Tensor
    blocks: Tuple[BlockParams, ...]
    lnf_g: torch.Tensor
    lnf_b: torch.Tensor
    head_w: torch.Tensor  # [D, 1]
    head_b: torch.Tensor


def init_transformer(d_model: int = 32, n_heads: int = 2, n_layers: int = 2,
                     d_ff: int = 64, n_in: int = N_EVENT_FEATURES,
                     seed: int = 0, device=None) -> TransformerParams:
    """The JAX init's shapes and scales, drawn from an explicit
    ``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s
    stream: weights cross between the packages through artifacts)."""
    gen = torch.Generator().manual_seed(seed)
    dh = d_model // n_heads

    def dense(shape, scale=None):
        scale = scale or 1.0 / math.sqrt(shape[0])
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def ones(n):
        return torch.ones(n, device=device)

    def zeros(n):
        return torch.zeros(n, device=device)

    embed_w = dense((n_in, d_model), 1 / math.sqrt(n_in))
    head_w = dense((d_model, 1))
    blocks: List[BlockParams] = []
    for _ in range(n_layers):
        s = 1 / math.sqrt(d_model)
        blocks.append(BlockParams(
            ln1_g=ones(d_model), ln1_b=zeros(d_model),
            wq=dense((d_model, n_heads, dh), s),
            wk=dense((d_model, n_heads, dh), s),
            wv=dense((d_model, n_heads, dh), s),
            wo=dense((n_heads, dh, d_model), s),
            ln2_g=ones(d_model), ln2_b=zeros(d_model),
            w1=dense((d_model, d_ff)), b1=zeros(d_ff),
            w2=dense((d_ff, d_model)), b2=zeros(d_model),
        ))
    return TransformerParams(
        embed_w=embed_w, embed_b=zeros(d_model), blocks=tuple(blocks),
        lnf_g=ones(d_model), lnf_b=zeros(d_model), head_w=head_w,
        head_b=zeros(1))


def _ln(x, g, b):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-6) * g + b).to(x.dtype)


def _gelu(x):
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def naive_attn(q, k, v, causal: bool = True):
    """Materialized attention, ``[..., T, H, D]`` layout, f32 scores,
    causal by default."""
    d, t = q.shape[-1], q.shape[-3]
    s = torch.einsum("...qhd,...khd->...hqk", q.float(),
                     k.float()) / math.sqrt(d)
    if causal:
        mask = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                     device=q.device))
        s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...hqk,...khd->...qhd", p, v.float()).to(q.dtype)


AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _ident(t):
    return t


def _block_forward(h, blk: BlockParams, attn: AttnFn, red=_ident,
                   ent=_ident):
    """One transformer block at full width: the per-position form (also
    the tensor-parallel one) and the prefix layers of the serving form."""
    hn = ent(_ln(h, blk.ln1_g, blk.ln1_b))
    q = torch.einsum("...td,...dhe->...the", hn, blk.wq)
    k = torch.einsum("...td,...dhe->...the", hn, blk.wk)
    v = torch.einsum("...td,...dhe->...the", hn, blk.wv)
    o = attn(q, k, v)
    h = h + red(torch.einsum("...the,...hed->...td", o, blk.wo))
    hn = ent(_ln(h, blk.ln2_g, blk.ln2_b))
    return h + red(_gelu(hn @ blk.w1 + blk.b1) @ blk.w2) + blk.b2


def transformer_logits(params: TransformerParams, x: torch.Tensor,
                       attn_fn: Optional[AttnFn] = None,
                       reduce_fn: Optional[Callable] = None,
                       enter_fn: Optional[Callable] = None) -> torch.Tensor:
    """Per-position fraud logits [B, T] of ``x`` [B, T, N_EVENT_FEATURES];
    ``attn_fn(q, k, v)`` defaults to causal naive attention. Positions
    come from the inter-arrival and phase channels, not embeddings.

    ``reduce_fn`` and ``enter_fn`` bracket the two column→row parallel
    regions of each block (Q/K/V → attention out, and the MLP): identity
    here; the tensor-parallel forward
    (``parallel/tensor_parallel.py::tp_transformer_logits``) passes
    Megatron's *g* (sum over the shards forward, identity backward) at
    each region's exit and *f* (identity forward, sum backward) at each
    entry, and runs this same code on every shard at once: its params
    carry leading shard dims that broadcast against ``x``'s."""
    attn = attn_fn or naive_attn
    red = reduce_fn or _ident
    ent = enter_fn or _ident
    h = x @ params.embed_w + params.embed_b
    for blk in params.blocks:
        h = _block_forward(h, blk, attn, red, ent)
    h = _ln(h, params.lnf_g, params.lnf_b)
    return (h @ params.head_w + params.head_b)[..., 0]


def transformer_last_logit(params: TransformerParams, x: torch.Tensor,
                           qpos: torch.Tensor,
                           attn_fn: Optional[AttnFn] = None) -> torch.Tensor:
    """Serving form: the logit at ONE position per row ([B]), exactly
    ``transformer_logits(params, x, attn_fn)[b, qpos[b]]``. The layers
    before the last run at every position (their outputs are the last
    block's keys and values); the last block, the final layer norm and
    the head run at the one query position, so the last block's scores
    are [B, H, K] instead of [B, H, K, K]."""
    attn = attn_fn or naive_attn
    h = x @ params.embed_w + params.embed_b
    for blk in params.blocks[:-1]:
        h = _block_forward(h, blk, attn)

    blk = params.blocks[-1]
    t, d = h.shape[1], h.shape[2]
    dh = blk.wq.shape[-1]
    hn = _ln(h, blk.ln1_g, blk.ln1_b)
    sel = qpos.long()[:, None, None].expand(-1, 1, d)  # [B, 1, D]
    hq = torch.gather(h, 1, sel)  # [B, 1, D]
    hnq = torch.gather(hn, 1, sel)
    q = torch.einsum("bod,dhe->bohe", hnq, blk.wq)  # [B, 1, H, dh]
    k = torch.einsum("btd,dhe->bthe", hn, blk.wk)
    v = torch.einsum("btd,dhe->bthe", hn, blk.wv)
    s = torch.einsum("bohe,bkhe->bhok", q.float(),
                     k.float()) / math.sqrt(dh)  # [B, H, 1, K]
    mask = (torch.arange(t, dtype=torch.int32, device=h.device)[None, :]
            <= qpos[:, None])[:, None, None, :]
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhok,bkhe->bohe", p, v.float()).to(h.dtype)
    hq = hq + torch.einsum("bohe,hed->bod", o, blk.wo)
    hn2 = _ln(hq, blk.ln2_g, blk.ln2_b)
    hq = hq + _gelu(hn2 @ blk.w1 + blk.b1) @ blk.w2 + blk.b2
    hf = _ln(hq, params.lnf_g, params.lnf_b)
    return (hf @ params.head_w + params.head_b)[:, 0, 0]


def transformer_flops(params: TransformerParams, rows: int, k: int) -> int:
    """Floating-point operations of one :func:`transformer_last_logit`
    over ``rows`` histories of ``k`` events, counted from the shapes (a
    multiply-add is 2): the products of every layer before the last, the
    attention scores and weighted sums, and the last block, the final
    norm and the head at one position per row. Norms, softmax and GELU
    are left out (a few operations per element)."""
    n_in, d = params.embed_w.shape
    f = params.blocks[0].w1.shape[1]
    hd = params.blocks[0].wq.shape[1] * params.blocks[0].wq.shape[2]
    proj = 2 * d * hd  # one of q/k/v/o at one position
    full = k * (4 * proj + 2 * 2 * d * f) + 2 * 2 * k * k * hd
    per_row = 2 * k * n_in * d + (len(params.blocks) - 1) * full
    # k and v at every position; q, o and the MLP at one; the scores and
    # the weighted sum of one query over k keys; the head
    per_row += k * 2 * proj + 2 * proj + 2 * 2 * d * f + 2 * 2 * k * hd
    per_row += 2 * d
    return int(rows * per_row)


def transformer_loss(params: TransformerParams, x: torch.Tensor,
                     y: torch.Tensor, mask: torch.Tensor,
                     pos_weight: float = 1.0,
                     attn_fn: Optional[AttnFn] = None,
                     reduce_fn=None, enter_fn=None) -> torch.Tensor:
    """Masked BCE-with-logits over every real event, positives weighted
    by ``pos_weight``: ``−Σ w·(y·log σ(z) + (1−y)·log σ(−z)) / max(Σ w, 1)``,
    the sums over the last two dims (B, T): one loss per shard when the
    tensor-parallel step runs every shard at once."""
    logits = transformer_logits(params, x, attn_fn, reduce_fn=reduce_fn,
                                enter_fn=enter_fn).float()
    yf = y.float()
    w = torch.where(yf > 0, torch.full_like(yf, pos_weight),
                    torch.ones_like(yf)) * mask.float()
    ll = F.logsigmoid(logits) * yf + F.logsigmoid(-logits) * (1 - yf)
    return -(w * ll).sum((-2, -1)) / torch.clamp(w.sum((-2, -1)), min=1.0)


def _train_attn_fn(attn: str) -> Optional[AttnFn]:
    if attn == "blockwise":
        return blockwise_attention
    if attn == "naive":
        return None
    raise ValueError(
        f"unknown attn {attn!r}: use 'naive' or 'blockwise' here; for "
        "ring (sequence-parallel) attention build the forward with "
        "make_sp_logits_fn and train under pjit")


def train_transformer(seqs: SequenceBatch, d_model: int = 32,
                      n_heads: int = 2, n_layers: int = 2, d_ff: int = 64,
                      batch_size: int = 64, epochs: int = 3,
                      learning_rate: float = 1e-3,
                      pos_weight: Optional[float] = None, seed: int = 0,
                      attn: str = "naive", device=None) -> TransformerParams:
    """Adam training on padded sequence batches (masked BCE), on
    ``device`` (None = CUDA). Each epoch walks
    ``np.random.default_rng(seed).permutation(n)`` in batches of
    ``batch_size``; the ragged last batch is filled up from the
    permutation (``np.resize(np.r_[sel, order], batch_size)``), as the
    JAX trainer keeps its shapes static."""
    device = resolve_device(device)
    attn_fn = _train_attn_fn(attn)
    params = init_transformer(d_model, n_heads, n_layers, d_ff,
                              n_in=seqs.x.shape[-1], seed=seed,
                              device=device)
    if pos_weight is None:
        pos_weight = rebalance_pos_weight(seqs.y[seqs.mask])
    opt = Adam(params, learning_rate)
    xj = torch.as_tensor(seqs.x, device=device)
    yj = torch.as_tensor(seqs.y, device=device)
    mj = torch.as_tensor(seqs.mask, device=device)

    def loss(p, xb, yb, mb):
        return transformer_loss(p, xb, yb, mb, pos_weight, attn_fn)

    n = seqs.x.shape[0]
    rng = np.random.default_rng(seed)
    nb = max(1, n // batch_size)
    for _ in range(epochs):
        order = rng.permutation(n)
        sels = []
        for b in range(nb):
            sel = order[b * batch_size:(b + 1) * batch_size]
            if len(sel) < batch_size:  # pad the ragged tail
                sel = np.resize(np.r_[sel, order], batch_size)
            sels.append(sel)
        sels = torch.as_tensor(np.stack(sels), device=device)
        for sel in sels:
            opt.step(loss, xj[sel], yj[sel], mj[sel])
    return opt.params


def make_sp_logits_fn(mesh, axis: str = "data"):
    """Sequence-parallel forward: ``logits(params, x)`` with the history
    axis sharded over ``axis`` of ``mesh`` and attention running as the
    ring (``parallel/ring_attention.py``). Everything outside attention
    is positionwise, so the ring is the only exchange between shards."""
    from real_time_fraud_detection_system_tpu_torch.parallel \
        .ring_attention import make_ring_attention_sharded

    ring = make_ring_attention_sharded(mesh, axis=axis, causal=True)
    return partial(transformer_logits, attn_fn=ring)


@torch.no_grad()
def sequence_scores(params: TransformerParams, seqs: SequenceBatch,
                    batch_size: int = 256,
                    attn_fn: Optional[AttnFn] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Score every real event: (tx_index [M], prob [M]) aligned to
    source-table rows, for evaluation against ``txs.tx_fraud``. Runs on
    the params' device."""
    dev = params.embed_w.device
    n, t = seqs.y.shape
    probs = np.zeros((n, t), dtype=np.float32)
    for s in range(0, n, batch_size):
        e = min(s + batch_size, n)
        logits = transformer_logits(
            params, torch.as_tensor(seqs.x[s:e], device=dev), attn_fn)
        probs[s:e] = torch.sigmoid(logits.float()).cpu().numpy()
    m = seqs.mask
    return seqs.tx_index[m], probs[m]
