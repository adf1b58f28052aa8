"""DeepSeek-V2's block as the sequence scorer: multi-head latent
attention (MLA) and a mixture of fine-grained routed experts with shared
experts, over each card's last K events, scored at the row's own event.

The layer equations are those of DeepSeek's published
``modeling_deepseek.py`` (``DeepseekV2Attention`` without query
compression, ``DeepseekV2YarnRotaryEmbedding``, ``MoEGate`` with greedy
top-k over softmax scores, ``DeepseekV2MoE``, ``DeepseekV2RMSNorm``). With
h the residual stream:

- **MLA.** x = RMSNorm(h); q = x W_q, per head [q_nope; q_pe];
  [c; k_pe] = x W_kva, c = RMSNorm_kv(c), k_pe one head shared by all;
  [k_nope; v] = c W_kvb per head. q_pe and k_pe are rotated at their
  positions (the pair-interleaved layout regrouped into halves first);
  scores (q_nope·k_nope + q_pe·k_pe) × softmax_scale, causal, softmax in
  float32, the weighted sum of v, then W_o.
- **MLP.** h += MLP(RMSNorm(h)): a dense SwiGLU in the first
  ``first_k_dense_replace`` layers, the expert layer of ``ops/moe.py`` in
  the others.
- **Serving form** (:func:`last_logit`): the event embedding (a linear
  8 → hidden), the layers before the last at every position, the last
  layer at the row's own position only, with its attention in the
  absorbed, decode form: W_UK folded into the query, the scores over the
  positions' latents c and k_pe, W_UV applied after the weighted sum, no
  per-head key or value materialised; a final RMSNorm and a one-logit
  head.

Precision travels with the params (:func:`params_from_leaves`): the
products run in the weights' dtype with float32 accumulation (bfloat16 on
the card's served path); the norms, rotary, router, softmax, residual
stream, head and logit are float32.

Weights are stored ``[in, out]`` (``x @ W``), the port's layout;
head-structured ones keep the head as a dimension (``wq [D, H, dn + dr]``,
``wkv_b [r, H, dn + dv]``, ``wo [H, dv, D]``). :func:`init_leaves` draws
the weights by name; ``models/deepseek_v2_ref.py`` computes the same
forward plainly from those names.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    N_EVENT_FEATURES,
)
from real_time_fraud_detection_system_tpu_torch.ops import stamp as stamps_op
from real_time_fraud_detection_system_tpu_torch.ops.moe import (
    MoEParams,
    moe,
    swiglu,
)


@dataclasses.dataclass(frozen=True)
class DSV2Config:
    """The published ``config.json``'s settings this forward reads (its
    key names), and the event channels in place of the vocabulary."""

    hidden_size: int
    num_hidden_layers: int
    num_attention_heads: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    intermediate_size: int
    moe_intermediate_size: int
    n_routed_experts: int
    n_shared_experts: int
    num_experts_per_tok: int
    first_k_dense_replace: int
    rms_norm_eps: float
    rope_theta: float
    rope_factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float
    mscale_all_dim: float
    routed_scaling_factor: float = 1.0
    n_in: int = N_EVENT_FEATURES

    @classmethod
    def from_dict(cls, d: dict) -> "DSV2Config":
        """From a ``config.json``-shaped dict; refuses settings this
        forward does not compute (query compression, other routers or
        scorings, renormalised top-k, experts not in every layer, a rope
        other than YaRN with cos and sin unscaled)."""
        refuse = {"q_lora_rank": None, "scoring_func": "softmax",
                  "topk_method": "greedy", "norm_topk_prob": False,
                  "moe_layer_freq": 1, "n_group": 1, "topk_group": 1}
        for k, want in refuse.items():
            if d.get(k, want) != want:
                raise ValueError(f"{k}={d[k]!r}: this forward computes "
                                 f"{k}={want!r} only")
        rs = d["rope_scaling"]
        if rs.get("type") != "yarn" or rs["mscale"] != rs["mscale_all_dim"]:
            raise ValueError(f"rope_scaling {rs!r}: this forward computes "
                             f"yarn with mscale == mscale_all_dim only "
                             f"(cos and sin scaled by 1)")
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        return cls(**kw, rope_factor=rs["factor"],
                   original_max_position_embeddings=rs[
                       "original_max_position_embeddings"],
                   beta_fast=rs["beta_fast"], beta_slow=rs["beta_slow"],
                   mscale=rs["mscale"], mscale_all_dim=rs["mscale_all_dim"])


def yarn_mscale(scale: float, mscale: float) -> float:
    """``yarn_get_mscale``: 0.1 · mscale · ln(scale) + 1 above 1, else 1."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: DSV2Config) -> torch.Tensor:
    """float32 [dr/2]: the extrapolated frequencies θ^(−2i/dr) below the
    ramp, the interpolated ones (over ``factor``) above it, blended
    linearly between ⌊d(β_fast)⌋ and ⌈d(β_slow)⌉ with
    d(r) = dr · ln(L / (2πr)) / (2 ln θ), clamped to [0, dr − 1]."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    expo = torch.arange(0, dim, 2, dtype=torch.float32) / dim
    extra = 1.0 / (base ** expo)
    inter = 1.0 / (cfg.rope_factor * base ** expo)

    def d(rot: float) -> float:
        return (dim * math.log(cfg.original_max_position_embeddings
                               / (rot * 2 * math.pi))) / (2 * math.log(base))

    low = max(math.floor(d(cfg.beta_fast)), 0)
    high = min(math.ceil(d(cfg.beta_slow)), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def softmax_scale(cfg: DSV2Config) -> float:
    """(dn + dr)^−½ times the square of YaRN's attention factor."""
    m = yarn_mscale(cfg.rope_factor, cfg.mscale_all_dim)
    return (cfg.qk_nope_head_dim + cfg.qk_rope_head_dim) ** -0.5 * m * m


class MLAParams(NamedTuple):
    norm: torch.Tensor  # f32 [D], the layer's first RMSNorm
    wq: torch.Tensor  # [D, H, dn + dr]
    wkv_a: torch.Tensor  # [D, r + dr]
    kv_norm: torch.Tensor  # f32 [r]
    wkv_b: torch.Tensor  # [r, H, dn + dv]
    wo: torch.Tensor  # [H, dv, D]


class DenseMLP(NamedTuple):
    w_gate: torch.Tensor  # [D, F]
    w_up: torch.Tensor  # [D, F]
    w_down: torch.Tensor  # [F, D]


class DSV2Layer(NamedTuple):
    attn: MLAParams
    mlp_norm: torch.Tensor  # f32 [D]
    mlp: Union[DenseMLP, MoEParams]


class DSV2Params(NamedTuple):
    """The served params: ``layers`` a tuple, the dense ones first. The
    scalars are leaves of the tree (``utils/tree.py``), as a forest's
    depth is."""

    embed_w: torch.Tensor  # [n_in, D]
    layers: Tuple[DSV2Layer, ...]
    norm_f: torch.Tensor  # f32 [D]
    head_w: torch.Tensor  # f32 [D, 1]
    inv_freq: torch.Tensor  # f32 [dr / 2]
    top_k: int
    routed_scale: float
    scale: float  # the attention's softmax scale
    eps: float


def leaf_shapes(cfg: DSV2Config) -> Dict[str, tuple]:
    """Every weight by name with its shape (``[in, out]``; experts
    ``[E, in, out]``): the names :func:`init_leaves`,
    :func:`params_from_leaves` and the references share."""
    d, h = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r, e = cfg.kv_lora_rank, cfg.n_routed_experts
    i_w, s_w = cfg.moe_intermediate_size, \
        cfg.n_shared_experts * cfg.moe_intermediate_size
    out = {"embed_w": (cfg.n_in, d)}
    for li in range(cfg.num_hidden_layers):
        p = f"l{li}."
        out.update({p + "attn_norm": (d,), p + "wq": (d, h * (dn + dr)),
                    p + "wkv_a": (d, r + dr), p + "kv_norm": (r,),
                    p + "wkv_b": (r, h * (dn + dv)), p + "wo": (h * dv, d),
                    p + "mlp_norm": (d,)})
        if li < cfg.first_k_dense_replace:
            f = cfg.intermediate_size
            out.update({p + "w_gate": (d, f), p + "w_up": (d, f),
                        p + "w_down": (f, d)})
        else:
            out.update({p + "router": (d, e),
                        p + "experts.w_gate": (e, d, i_w),
                        p + "experts.w_up": (e, d, i_w),
                        p + "experts.w_down": (e, i_w, d),
                        p + "shared.w_gate": (d, s_w),
                        p + "shared.w_up": (d, s_w),
                        p + "shared.w_down": (s_w, d)})
    out.update({"norm_f": (d,), "head_w": (d, 1)})
    return out


def init_leaves(cfg: DSV2Config, generator: Optional[torch.Generator] = None,
                device=None) -> Dict[str, torch.Tensor]:
    """float32 weights by :func:`leaf_shapes`' names: N(0, 1) ×
    fan_in^−½ (fan_in the next-to-last dimension), norm gains 1."""
    out = {}
    for name, shape in leaf_shapes(cfg).items():
        if len(shape) == 1:
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.randn(shape, generator=generator,
                                    device=device) / math.sqrt(shape[-2])
    return out


def params_from_leaves(cfg: DSV2Config, leaves: Dict[str, torch.Tensor],
                       dtype=torch.float32) -> DSV2Params:
    """The served params from weights by name: the products' weights in
    ``dtype``, the norms, router and head float32."""
    d, h = cfg.hidden_size, cfg.num_attention_heads
    dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    r = cfg.kv_lora_rank

    def w(name, *shape):
        t = leaves[name].to(dtype)
        return t.reshape(shape).contiguous() if shape else t.contiguous()

    def f32(name):
        return leaves[name].to(torch.float32).contiguous()

    layers = []
    for li in range(cfg.num_hidden_layers):
        p = f"l{li}."
        attn = MLAParams(f32(p + "attn_norm"), w(p + "wq", d, h, dn + dr),
                         w(p + "wkv_a"), f32(p + "kv_norm"),
                         w(p + "wkv_b", r, h, dn + dv),
                         w(p + "wo", h, dv, d))
        if li < cfg.first_k_dense_replace:
            mlp = DenseMLP(w(p + "w_gate"), w(p + "w_up"), w(p + "w_down"))
        else:
            mlp = MoEParams(f32(p + "router"), *[w(p + n) for n in (
                "experts.w_gate", "experts.w_up", "experts.w_down",
                "shared.w_gate", "shared.w_up", "shared.w_down")])
        layers.append(DSV2Layer(attn, f32(p + "mlp_norm"), mlp))
    dev = leaves["embed_w"].device
    return DSV2Params(
        embed_w=w("embed_w"), layers=tuple(layers), norm_f=f32("norm_f"),
        head_w=f32("head_w"), inv_freq=yarn_inv_freq(cfg).to(dev),
        top_k=cfg.num_experts_per_tok,
        routed_scale=float(cfg.routed_scaling_factor),
        scale=softmax_scale(cfg), eps=float(cfg.rms_norm_eps))


def stamp_slots(params: DSV2Params) -> Dict[str, list]:
    """Which slots of a step's stamp buffer bound each span: per name a
    list of ``(start, end)`` slot pairs (``device/mla``: every layer's
    attention; ``device/experts``: every expert layer)."""
    n = len(params.layers)
    n_moe = sum(isinstance(l.mlp, MoEParams) for l in params.layers)
    return {"device/mla": [(2 * i, 2 * i + 1) for i in range(n)],
            "device/experts": [(2 * n + 2 * j, 2 * n + 2 * j + 1)
                               for j in range(n_moe)]}


def n_stamps(params: DSV2Params) -> int:
    """The stamp buffer's length."""
    return 2 * sum(map(len, stamp_slots(params).values()))


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in ``w``'s dtype, float32 out."""
    return (x.to(w.dtype) @ w).float()


def rms_norm(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    """``x · rsqrt(mean(x²) + eps) · g`` in float32."""
    return F.rms_norm(x.float(), (x.shape[-1],), weight=g, eps=eps)


def rope_tables(inv_freq: torch.Tensor,
                t: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) float32 [t, dr] at positions 0..t−1 (each frequency
    twice, halves layout)."""
    pos = torch.arange(t, dtype=torch.float32, device=inv_freq.device)
    freqs = torch.outer(pos, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
         ) -> torch.Tensor:
    """``x`` [..., dr] float32, pair-interleaved, rotated: regrouped into
    halves, then ``x·cos + rotate_half(x)·sin`` (``cos``/``sin``
    broadcast against it)."""
    *lead, d = x.shape
    x = x.reshape(*lead, d // 2, 2).transpose(-1, -2).reshape(*lead, d)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


def _latents(p: MLAParams, xc: torch.Tensor, eps: float, cos, sin):
    """(c [..., T, r] normed, k_pe [..., T, dr] rotated), both in the
    products' dtype, of normed rows ``xc`` [..., T, D] in that dtype; the
    norm and the rotation in float32."""
    r = p.kv_norm.shape[0]
    kva = xc @ p.wkv_a
    c = rms_norm(kva[..., :r], p.kv_norm, eps)
    return c.to(xc.dtype), rope(kva[..., r:].float(), cos, sin).to(xc.dtype)


def mla_full(p: MLAParams, x: torch.Tensor, scale: float, eps: float,
             cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Causal MLA at every position of normed rows ``x`` f32 [B, T, D],
    keys and values decompressed per head; f32 [B, T, D]. What feeds only
    another product stays in the products' dtype."""
    b, t, d = x.shape
    _, h, dq = p.wq.shape
    dr = cos.shape[-1]
    dn, dv = dq - dr, p.wo.shape[1]
    xc = x.to(p.wq.dtype)
    q = (xc @ p.wq.view(d, h * dq)).view(b, t, h, dq).transpose(1, 2)
    c, k_pe = _latents(p, xc, eps, cos, sin)
    kv = (c @ p.wkv_b.view(c.shape[-1], -1)).view(b, t, h, dn + dv) \
        .transpose(1, 2)  # [B, H, T, dn + dv]
    q_pe = rope(q[..., dn:].float(), cos, sin).to(xc.dtype)
    # q·k over [nope; rope] as two products: the rotary key is one head,
    # shared by every head
    s = ((q[..., :dn] @ kv[..., :dn].transpose(-1, -2)).float()
         + (q_pe @ k_pe[:, None].transpose(-1, -2)).float()) * scale
    mask = torch.ones((t, t), dtype=torch.bool, device=x.device).tril()
    prob = torch.softmax(s.masked_fill(~mask, -math.inf), dim=-1)
    o = prob.to(xc.dtype) @ kv[..., dn:]  # [B, H, T, dv]
    return _mm(o.transpose(1, 2).reshape(b, t, h * dv),
               p.wo.view(h * dv, d))


def mla_absorbed(p: MLAParams, x: torch.Tensor, xq: torch.Tensor,
                 qpos: torch.Tensor, scale: float, eps: float,
                 cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """MLA of one query a row, at ``qpos`` [B], over the positions of
    normed rows ``x`` f32 [B, T, D] up to it (``xq`` f32 [B, D] the
    query's row), in the decode form: the query through W_UK into the
    latent space, scores against the latents c and the shared k_pe, the
    weighted sum of the latents through W_UV; f32 [B, D]."""
    b, t, d = x.shape
    _, h, dq = p.wq.shape
    dr = cos.shape[-1]
    dn, dv = dq - dr, p.wo.shape[1]
    dt = p.wq.dtype
    q = (xq.to(dt) @ p.wq.view(d, h * dq)).view(b, h, dq)
    qc, qs = cos[qpos][:, None], sin[qpos][:, None]  # [B, 1, dr]
    q_pe = rope(q[..., dn:].float(), qc, qs).to(dt)
    c, k_pe = _latents(p, x.to(dt), eps, cos, sin)  # [B, T, r], [B, T, dr]
    w_uk, w_uv = p.wkv_b[..., :dn], p.wkv_b[..., dn:]  # [r, H, dn|dv]
    q_lat = torch.einsum("bhn,rhn->bhr", q[..., :dn], w_uk)
    s = (torch.einsum("bhr,btr->bht", q_lat, c).float()
         + torch.einsum("bhe,bte->bht", q_pe, k_pe).float()) * scale
    keep = torch.arange(t, device=x.device)[None, :] <= qpos[:, None]
    prob = torch.softmax(s.masked_fill(~keep[:, None], -math.inf), dim=-1)
    o_lat = torch.einsum("bht,btr->bhr", prob.to(dt), c)
    o = torch.einsum("bhr,rhv->bhv", o_lat, w_uv)
    return _mm(o.reshape(b, h * dv), p.wo.view(h * dv, d))


@contextlib.contextmanager
def _f32_accumulation(device: torch.device):
    """cuBLAS's half-precision products reduce in float32 while the
    forward runs (no reduced-precision split-K partial sums)."""
    if device.type != "cuda":
        yield
        return
    m = torch.backends.cuda.matmul
    was = m.allow_bf16_reduced_precision_reduction
    m.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        m.allow_bf16_reduced_precision_reduction = was


def last_logit(params: DSV2Params, hist: torch.Tensor, qpos: torch.Tensor,
               real: Optional[torch.Tensor] = None,
               slots: Optional[torch.Tensor] = None,
               stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The logit at each row's ``qpos`` [B] of histories ``hist``
    f32 [B, T, n_in] (left-aligned, position 0 first), float32 [B].

    ``slots`` int64 [expert layers, E] gathers, in place, each expert's
    count of the slots of the positions ``real`` bool [B, T] marks (None:
    every position; the last layer counts the query positions);
    ``stamps`` int64 [:func:`n_stamps`] takes the card's clock at the
    bounds of each layer's attention and expert layer
    (:func:`stamp_slots`). Neither is read here."""
    b, t, _ = hist.shape
    qpos = qpos.long()
    eps, scale = params.eps, params.scale
    cos, sin = rope_tables(params.inv_freq, t)
    n = len(params.layers)
    moe_i = 0

    def mark(i: int) -> None:
        if stamps is not None:
            stamps_op.stamp(stamps, i)

    def mlp(layer: DSV2Layer, x: torch.Tensor, rows_real) -> torch.Tensor:
        """The layer's MLP on normed rows ``x`` f32 [N, D]; f32 [N, D]."""
        nonlocal moe_i
        m = layer.mlp
        if isinstance(m, DenseMLP):
            xc = x.to(m.w_gate.dtype)
            return _mm(swiglu(xc @ m.w_gate, xc @ m.w_up), m.w_down)
        mark(2 * n + 2 * moe_i)
        out = moe(m, x, params.top_k, params.routed_scale,
                  None if slots is None else slots[moe_i], rows_real)
        mark(2 * n + 2 * moe_i + 1)
        moe_i += 1
        return out

    with _f32_accumulation(hist.device):
        h = _mm(hist, params.embed_w)  # [B, T, D] f32
        d = h.shape[-1]
        flat_real = None if real is None else real.reshape(-1)
        for li, layer in enumerate(params.layers[:-1]):
            mark(2 * li)
            h = h + mla_full(layer.attn, rms_norm(h, layer.attn.norm, eps),
                             scale, eps, cos, sin)
            mark(2 * li + 1)
            x = rms_norm(h, layer.mlp_norm, eps).view(b * t, d)
            h = h + mlp(layer, x, flat_real).view(b, t, d)
        layer = params.layers[-1]
        rows = torch.arange(b, device=h.device)
        q_real = None if real is None else real[rows, qpos]
        mark(2 * (n - 1))
        x = rms_norm(h, layer.attn.norm, eps)
        hq = h[rows, qpos] + mla_absorbed(layer.attn, x, x[rows, qpos], qpos,
                                          scale, eps, cos, sin)
        mark(2 * (n - 1) + 1)
        hq = hq + mlp(layer, rms_norm(hq, layer.mlp_norm, eps), q_real)
        return (rms_norm(hq, params.norm_f, eps) @ params.head_w)[:, 0]

