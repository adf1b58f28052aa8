"""Plain reference of DeepSeek-V2's block as the sequence scorer
(``models/deepseek_v2.py`` serves it): the full forward at every position
in float32, written from DeepSeek's published ``modeling_deepseek.py``.
It imports only ``torch``.

No absorption, no grouping, no graph: every layer's MLA decompresses the
per-head keys and values from the latents at every position; each
token's experts are computed for that token alone, with a gather of the
weights of the ``num_experts_per_tok`` experts it chose, plus the shared
experts. Matrix products run in true float32 (TF32 off while it runs).

Departures from the published model, all at the ends of the stack:

- the token embedding is a linear layer from the ``n_in`` event channels
  of ``models/sequence.py::event_features`` to the hidden size (no
  vocabulary);
- the LM head is one logit (``head_w`` [hidden, 1]) after the final
  RMSNorm;
- a history's positions are 0..K−1, left-aligned, own event last; the
  logit read is the one at the row's own position.

``cfg`` is a ``config.json``-shaped dict (the published key names);
``leaves`` the weights by ``models/deepseek_v2.py::leaf_shapes``' names,
``[in, out]``.
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


def rms_norm(x, g, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * g


def yarn_get_mscale(scale=1.0, mscale=1.0):
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_inv_freq(cfg: dict) -> torch.Tensor:
    """``DeepseekV2YarnRotaryEmbedding``'s inverse frequencies."""
    dim, base = cfg["qk_rope_head_dim"], cfg["rope_theta"]
    rs = cfg["rope_scaling"]
    freq_extra = 1.0 / (base ** (torch.arange(0, dim, 2,
                                              dtype=torch.float32) / dim))
    freq_inter = 1.0 / (rs["factor"] * base ** (
        torch.arange(0, dim, 2, dtype=torch.float32) / dim))

    def find_dim(num_rotations):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (num_rotations * 2 * math.pi))) \
            / (2 * math.log(base))

    low = max(math.floor(find_dim(rs["beta_fast"])), 0)
    high = min(math.ceil(find_dim(rs["beta_slow"])), dim - 1)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32) - low)
                       / (high - low), 0, 1)
    inv_freq_mask = 1.0 - ramp
    return freq_inter * (1 - inv_freq_mask) + freq_extra * inv_freq_mask


def rotate_half(x):
    x1, x2 = x[..., :x.shape[-1] // 2], x[..., x.shape[-1] // 2:]
    return torch.cat((-x2, x1), dim=-1)


def apply_rope(x, cos, sin):
    """``apply_rotary_pos_emb`` on ``x`` [..., T, d]: the interleaved
    pairs regrouped into halves, then rotated."""
    *lead, t, d = x.shape
    x = x.view(*lead, t, d // 2, 2).transpose(-1, -2).reshape(*lead, t, d)
    return x * cos + rotate_half(x) * sin


def mla(cfg, p, x, cos, sin):
    """Causal multi-head latent attention at every position of normed
    rows ``x`` [B, T, D]."""
    b, t, d = x.shape
    h = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = (x @ p["wq"]).view(b, t, h, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = x @ p["wkv_a"]
    c, k_pe = ckv[..., :r], ckv[..., r:].view(b, 1, t, dr)
    kv = (rms_norm(c, p["kv_norm"], cfg["rms_norm_eps"]) @ p["wkv_b"]) \
        .view(b, t, h, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(b, h, t, dr)], -1)
    m = yarn_get_mscale(cfg["rope_scaling"]["factor"],
                        cfg["rope_scaling"]["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * m * m
    s = (q @ k.transpose(-1, -2)) * scale
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    s = s.masked_fill(~mask, -math.inf)
    o = torch.softmax(s, dim=-1, dtype=torch.float32) @ v
    return o.transpose(1, 2).reshape(b, t, h * dv) @ p["wo"]


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def moe(cfg, p, x, block: int = 4096):
    """``DeepseekV2MoE`` on rows ``x`` [N, D]: the softmax router's top-k
    with raw scores as weights, each row's experts from a gather of
    their weights, plus the shared experts; ``block`` rows at a time."""
    k = cfg["num_experts_per_tok"]
    scores = torch.softmax(x @ p["router"], dim=-1, dtype=torch.float32)
    w, idx = torch.topk(scores, k, dim=-1)
    w = w * cfg.get("routed_scaling_factor", 1.0)
    out = torch.empty_like(x)
    for s in range(0, x.shape[0], block):
        xb, ib, wb = x[s:s + block], idx[s:s + block], w[s:s + block]
        g = torch.einsum("nd,nkdi->nki", xb, p["experts.w_gate"][ib])
        u = torch.einsum("nd,nkdi->nki", xb, p["experts.w_up"][ib])
        y = torch.einsum("nki,nkid->nkd", F.silu(g) * u,
                         p["experts.w_down"][ib])
        out[s:s + block] = (y * wb[..., None]).sum(1)
    return out + swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                        p["shared.w_down"])


def logits(cfg: dict, leaves: Dict[str, torch.Tensor],
           x: torch.Tensor) -> torch.Tensor:
    """Per-position logits [B, T] of event histories ``x`` [B, T, n_in]."""
    eps = cfg["rms_norm_eps"]
    t = x.shape[1]
    inv_freq = yarn_inv_freq(cfg).to(x.device)
    freqs = torch.outer(torch.arange(t, dtype=torch.float32,
                                     device=x.device), inv_freq)
    emb = torch.cat((freqs, freqs), dim=-1)
    rs = cfg["rope_scaling"]
    m = yarn_get_mscale(rs["factor"], rs["mscale"]) / yarn_get_mscale(
        rs["factor"], rs["mscale_all_dim"])
    cos, sin = emb.cos() * m, emb.sin() * m
    with full_float32():
        h = x @ leaves["embed_w"]
        for i in range(cfg["num_hidden_layers"]):
            p = {n[len(f"l{i}."):]: v for n, v in leaves.items()
                 if n.startswith(f"l{i}.")}
            h = h + mla(cfg, p, rms_norm(h, p["attn_norm"], eps), cos, sin)
            hn = rms_norm(h, p["mlp_norm"], eps)
            if i < cfg["first_k_dense_replace"]:
                h = h + swiglu(hn, p["w_gate"], p["w_up"], p["w_down"])
            else:
                b, t_, d = hn.shape
                h = h + moe(cfg, p, hn.reshape(b * t_, d)).view(b, t_, d)
        return (rms_norm(h, leaves["norm_f"], eps) @ leaves["head_w"])[..., 0]
