"""Plain reference of DeepSeek-V2's block as the sequence scorer, for the
check that decides ``correct`` in ``dsv2`` configurations: the full
forward at every position in float32, written from DeepSeek's published
``modeling_deepseek.py``. Plain PyTorch; nothing of the program under
test.

A copy of the repository's reference
(``real_time_fraud_detection_system_tpu_torch/models/deepseek_v2_ref.py``)
but for one function, :func:`moe`: there each token's experts come from a
gather of their weights, 208 MB a token at the published widths in
float32, which the check's ~300,000 positions a run cannot afford. Here,
as the published ``moe_infer`` does, each expert in turn takes the rows
that chose it (a boolean mask, no grouped product), in float32; a row's
output is still the sum of its own experts' outputs with its own gate
weights. ``fraudbench/tests/test_fraudbench_dsv2.py`` holds the two
references to each other.

No absorption, no graph: every layer's MLA decompresses the per-head keys
and values from the latents at every position. Matrix products run in
true float32 (TF32 off while it runs).

Departures from the published model, all at the ends of the stack:

- the token embedding is a linear layer from the 8 event channels of
  ``reference/sequence.py::histories`` to the hidden size (no
  vocabulary);
- the LM head is one logit (``head_w`` [hidden, 1]) after the final
  RMSNorm;
- a history's positions are 0..K−1, left-aligned, own event last; the
  logit read is the one at the row's own position.

``cfg`` is a ``config.json``-shaped dict (the published key names);
``leaves`` the weights by name and shape (:func:`leaf_shapes`),
``[in, out]``. ``quant``, where given, rounds the inputs of every matrix
product (both sides) before it: the control's float8.
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


def leaf_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every weight the forward reads, by name, with its shape:
    ``[in, out]``, the routed experts ``[experts, in, out]``, norm gains
    ``[n]``; layer ``i``'s names begin ``l<i>.``. ``cfg`` also gives
    ``n_in``, the event channels."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    e, w = cfg["n_routed_experts"], cfg["moe_intermediate_size"]
    ws = cfg["n_shared_experts"] * w
    out = {"embed_w": (cfg["n_in"], d)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"l{i}."
        out.update({p + "attn_norm": (d,), p + "wq": (d, h * (dn + dr)),
                    p + "wkv_a": (d, r + dr), p + "kv_norm": (r,),
                    p + "wkv_b": (r, h * (dn + dv)), p + "wo": (h * dv, d),
                    p + "mlp_norm": (d,)})
        if i < cfg["first_k_dense_replace"]:
            f = cfg["intermediate_size"]
            out.update({p + "w_gate": (d, f), p + "w_up": (d, f),
                        p + "w_down": (f, d)})
        else:
            out.update({p + "router": (d, e),
                        p + "experts.w_gate": (e, d, w),
                        p + "experts.w_up": (e, d, w),
                        p + "experts.w_down": (e, w, d),
                        p + "shared.w_gate": (d, ws),
                        p + "shared.w_up": (d, ws),
                        p + "shared.w_down": (ws, d)})
    out.update({"norm_f": (d,), "head_w": (d, 1)})
    return out


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


def float8(t):
    """``t`` rounded to float8 e4m3 with one scale for the whole tensor
    (its largest magnitude to the format's 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def matmul(quant: bool):
    """The reference's matrix product: float32, or the control's, whose
    inputs are rounded to float8 first."""
    if quant:
        return lambda a, b: float8(a) @ float8(b)
    return torch.matmul


def mla(cfg, p, x, cos, sin, mm):
    """Causal multi-head latent attention at every position of normed
    rows ``x`` [B, T, D]."""
    b, t, d = x.shape
    h = cfg["num_attention_heads"]
    dn, dr = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"]
    dv, r = cfg["v_head_dim"], cfg["kv_lora_rank"]
    q = mm(x, p["wq"]).view(b, t, h, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = mm(x, p["wkv_a"])
    c, k_pe = ckv[..., :r], ckv[..., r:].view(b, 1, t, dr)
    kv = mm(rms_norm(c, p["kv_norm"], cfg["rms_norm_eps"]), p["wkv_b"]) \
        .view(b, t, h, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe = apply_rope(q_pe, cos, sin)
    k_pe = apply_rope(k_pe, cos, sin)
    q = torch.cat([q_nope, q_pe], -1)
    k = torch.cat([k_nope, k_pe.expand(b, h, t, dr)], -1)
    m = yarn_get_mscale(cfg["rope_scaling"]["factor"],
                        cfg["rope_scaling"]["mscale_all_dim"])
    scale = (dn + dr) ** -0.5 * m * m
    s = mm(q, k.transpose(-1, -2)) * scale
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    s = s.masked_fill(~mask, -math.inf)
    o = mm(torch.softmax(s, dim=-1, dtype=torch.float32), v)
    return mm(o.transpose(1, 2).reshape(b, t, h * dv), p["wo"])


def swiglu(x, w_gate, w_up, w_down, mm):
    return mm(F.silu(mm(x, w_gate)) * mm(x, w_up), w_down)


def moe(cfg, p, x, mm):
    """``DeepseekV2MoE`` on rows ``x`` [N, D]: the softmax router's top-k
    with raw scores as weights; each expert over the rows that chose it,
    weighted and added into them; plus the shared experts."""
    k, n_exp = cfg["num_experts_per_tok"], cfg["n_routed_experts"]
    scores = torch.softmax(mm(x, p["router"]), dim=-1, dtype=torch.float32)
    w, idx = torch.topk(scores, k, dim=-1)
    w = w * cfg.get("routed_scaling_factor", 1.0)
    out = torch.zeros_like(x)
    for e in range(n_exp):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        y = swiglu(x[rows], p["experts.w_gate"][e], p["experts.w_up"][e],
                   p["experts.w_down"][e], mm)
        out.index_add_(0, rows, y * w[rows, slot, None])
    return out + swiglu(x, p["shared.w_gate"], p["shared.w_up"],
                        p["shared.w_down"], mm)


def logits(cfg: dict, leaves: Dict[str, torch.Tensor], x: torch.Tensor,
           quant: bool = False) -> torch.Tensor:
    """Per-position logits [B, T] of event histories ``x`` [B, T, n_in]
    (``quant``: every product's inputs in float8)."""
    eps = cfg["rms_norm_eps"]
    mm = matmul(quant)
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
        h = mm(x, leaves["embed_w"])
        for i in range(cfg["num_hidden_layers"]):
            p = {n[len(f"l{i}."):]: v for n, v in leaves.items()
                 if n.startswith(f"l{i}.")}
            h = h + mla(cfg, p, rms_norm(h, p["attn_norm"], eps), cos, sin,
                        mm)
            hn = rms_norm(h, p["mlp_norm"], eps)
            if i < cfg["first_k_dense_replace"]:
                h = h + swiglu(hn, p["w_gate"], p["w_up"], p["w_down"], mm)
            else:
                b, t_, d = hn.shape
                h = h + moe(cfg, p, hn.reshape(b * t_, d), mm).view(b, t_, d)
        return mm(rms_norm(h, leaves["norm_f"], eps), leaves["head_w"])[..., 0]


def probs(cfg: dict, leaves: Dict[str, torch.Tensor], events: torch.Tensor,
          length: torch.Tensor, quant: bool = False,
          block: int = 256) -> torch.Tensor:
    """float64 [m] scores at each history's last real position, ``block``
    histories at a time (``events`` [m, K, n_in], ``length`` [m])."""
    out = []
    for s in range(0, events.shape[0], block):
        lg = logits(cfg, leaves, events[s:s + block].to(torch.float32),
                    quant)
        at = (length[s:s + block] - 1)[:, None]
        out.append(torch.sigmoid(torch.gather(lg, 1, at)[:, 0]
                                 .to(torch.float64)))
    return torch.cat(out)
