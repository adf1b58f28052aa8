"""Operations of one scored row of DeepSeek-V2's block as the sequence
scorer, counted from the shapes of the forward served
(``models/deepseek_v2.py::last_logit``), for ``step_mfu_bf16``. A
multiply-add is 2.

- The embedding (n_in → hidden) at every position.
- Every layer before the last at every one of the K positions: MLA's
  q, kv_a, kv_b and o projections, the scores and weighted sums over all
  K × K pairs (as ``counts/step.py`` counts the small transformer's); the
  dense SwiGLU's three products, or the router's top-k experts and the
  shared experts, three products each.
- The last layer, in the absorbed form: its latents (kv_a) at every
  position, the query at the row's own position, the query through W_UK,
  the scores over the K latents and rotary keys, the weighted sum of the
  latents, W_UV and W_o, and the MLP at the one position.
- The head (hidden → 1).

The router's product, norms, rotary, softmax and SiLU are left out (a
few operations per element, or under 0.2% of a row).
"""

from __future__ import annotations


def ops_per_row(m: dict, k: int) -> int:
    """``m``: the published config.json's keys (and ``n_in``)."""
    d, h = m["hidden_size"], m["num_attention_heads"]
    dn, dr = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    dv, r = m["v_head_dim"], m["kv_lora_rank"]
    n_layers, n_dense = m["num_hidden_layers"], m["first_k_dense_replace"]
    q = 2 * d * h * (dn + dr)
    kv_a = 2 * d * (r + dr)
    kv_b = 2 * r * h * (dn + dv)
    o = 2 * h * dv * d
    dense = 3 * 2 * d * m["intermediate_size"]
    experts = 3 * 2 * d * m["moe_intermediate_size"] * (
        m["num_experts_per_tok"] + m["n_shared_experts"])

    def mlp(layer: int) -> int:
        return dense if layer < n_dense else experts

    total = 2 * k * m["n_in"] * d
    for layer in range(n_layers - 1):
        total += k * (q + kv_a + kv_b + o + mlp(layer))
        total += 2 * k * k * h * (dn + dr + dv)
    # the last layer at one position, its attention absorbed
    total += k * kv_a + q + 2 * h * dn * r + 2 * k * h * (r + dr) \
        + 2 * k * h * r + 2 * h * r * dv + o + mlp(n_layers - 1)
    return int(total + 2 * d)
