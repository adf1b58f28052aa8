"""Expert parallelism: a top-1 routed mixture-of-experts FFN with an
all-to-all dispatch — port of the JAX package's
``parallel/expert_parallel.py``.

One expert MLP per shard: each token goes to its expert's owner through
the bucketed exchange of the sharded step (``parallel/step.py::
owner_route``; on co-located shards a transpose of one tensor), the owner
applies its expert, and the result comes back through the inverse
exchange, scaled by the router's gate where the token lives. The buckets
are the worst case (``n × B_local`` rows per shard), so no token is ever
dropped and the result equals :func:`moe_apply_dense`, the single-device
form that computes every token's expert in place. The shards share one
device (``parallel/mesh.py``): the experts' stacked leading axis is the
shard axis, and each shard's FFN is one batched product over it.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    axis_size,
    mesh_device,
)
from real_time_fraud_detection_system_tpu_torch.parallel.step import (
    owner_route,
)


class MoEParams(NamedTuple):
    """E experts, stacked on the leading axis (one per shard)."""

    w_router: torch.Tensor  # [D, E] (replicated)
    w1: torch.Tensor  # [E, D, F]
    b1: torch.Tensor  # [E, F]
    w2: torch.Tensor  # [E, F, D]
    b2: torch.Tensor  # [E, D]

    @property
    def n_experts(self) -> int:
        return int(self.w1.shape[0])


def init_moe(d_model: int, d_ff: int, n_experts: int, seed: int = 0,
             device=None) -> MoEParams:
    """Normal weights at the JAX function's scales, from a
    ``torch.Generator`` seeded with ``seed`` (the draws are not
    ``jax.random``'s), zero biases, on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)

    def normal(shape, scale):
        return (scale * torch.randn(shape, generator=gen)).to(device)

    return MoEParams(
        w_router=normal((d_model, n_experts), 1 / math.sqrt(d_model)),
        w1=normal((n_experts, d_model, d_ff), math.sqrt(2.0 / d_model)),
        b1=torch.zeros((n_experts, d_ff), device=device),
        w2=normal((n_experts, d_ff, d_model), math.sqrt(2.0 / d_ff)),
        b2=torch.zeros((n_experts, d_model), device=device),
    )


def _route_and_gate(params: MoEParams, x: torch.Tensor):
    """Top-1 router: → (expert id int32 [..., B], gate value [..., B])."""
    logits = x @ params.w_router
    e = torch.argmax(logits, dim=-1)
    gate = torch.gather(torch.softmax(logits, dim=-1), -1,
                        e[..., None])[..., 0]
    return e.to(torch.int32), gate


def _expert_ffn(params: MoEParams, e: torch.Tensor,
                x: torch.Tensor) -> torch.Tensor:
    """Each token's expert MLP by gathers of the stacked weights (the
    single-device path)."""
    e = e.long()
    h = torch.relu(torch.einsum("bd,bdf->bf", x, params.w1[e])
                   + params.b1[e])
    return torch.einsum("bf,bfd->bd", h, params.w2[e]) + params.b2[e]


def moe_apply_dense(params: MoEParams, x: torch.Tensor) -> torch.Tensor:
    """The single-device form: every token's expert computed in place."""
    e, gate = _route_and_gate(params, x)
    return gate[:, None] * _expert_ffn(params, e, x)


def make_ep_apply(mesh, params: MoEParams, axis: Optional[str] = None):
    """→ (sharded_params, apply(params, x) → y): expert-parallel MoE.

    ``x [B, D]``'s rows shard over ``axis`` (default the mesh's first)
    and the experts one per shard (``n_experts`` must be the axis size).
    Each shard routes its tokens to their expert's owner, which applies
    only its own expert; the gate is computed where the token lives.
    Differentiable end to end (the exchange's scatter and gather
    transpose to each other)."""
    from real_time_fraud_detection_system_tpu_torch.parallel.distributed \
        import mesh_axes

    axis = axis or mesh_axes(mesh)[0]
    n_dev = axis_size(mesh, axis)
    if params.n_experts != n_dev:
        raise ValueError(
            f"{params.n_experts} experts on a {n_dev}-device '{axis}' "
            "axis (want one expert per device)")
    dev = mesh_device(mesh)
    sharded = MoEParams(*[t.to(dev) for t in params])

    def apply(p: MoEParams, x: torch.Tensor) -> torch.Tensor:
        b, d = x.shape
        bl = b // n_dev
        xs = x.to(dev).reshape(n_dev, bl, d)
        e, gate = _route_and_gate(p, xs)  # router replicated, tokens local
        send_pos, xchg, scatter = owner_route(
            e.long(), torch.ones_like(e, dtype=torch.bool), n_dev, bl)
        received = xchg(scatter(xs))  # [n, n·bl, D]: shard o's tokens
        out = (torch.relu(received @ p.w1 + p.b1[:, None]) @ p.w2
               + p.b2[:, None])
        back = torch.gather(xchg(out), 1, send_pos[..., None].expand(
            -1, -1, d))  # the inverse exchange, un-bucketed
        return (gate[..., None] * back).reshape(b, d)

    return sharded, apply
