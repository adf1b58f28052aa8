"""Pipeline parallelism: a GPipe microbatch pipeline over a stack of
residual blocks — port of the JAX package's
``parallel/pipeline_parallel.py``.

S uniform residual blocks ``h + W2·relu(W1·h)``, one stage per shard of a
mesh axis. The batch splits into ``n_micro`` microbatches; at tick t stage
0 takes microbatch t, every stage applies its block to what it holds, and
each stage's output moves to the next stage (the JAX ``ppermute``; on
co-located shards a ``torch.roll`` of the stacked ``[S, m, H]`` carry),
the last stage emitting microbatch ``t - (S - 1)``. ``n_micro + S - 1``
ticks drain the pipeline. A stage applies the same block to the same
rows as :func:`stack_apply` does, one microbatch at a time, so the output
equals the sequential stack bit for bit; a stage with nothing to process
(the fill and drain bubbles) is skipped, which changes no output.
Gradients flow through the pipeline by autograd (the roll transposes to
the reverse roll).
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


class StackParams(NamedTuple):
    """S uniform residual blocks, stacked on the leading (stage) axis."""

    w1: torch.Tensor  # [S, H, H]
    b1: torch.Tensor  # [S, H]
    w2: torch.Tensor  # [S, H, H]
    b2: torch.Tensor  # [S, H]


def init_stack(width: int, n_stages: int, seed: int = 0,
               device=None) -> StackParams:
    """Normal weights at the JAX function's scale ``sqrt(2 / width)``
    from a ``torch.Generator`` seeded with ``seed`` (the draws are not
    ``jax.random``'s), zero biases, on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    scale = math.sqrt(2.0 / width)

    def normal():
        return (scale * torch.randn((n_stages, width, width),
                                    generator=gen)).to(device)

    z = torch.zeros((n_stages, width), device=device)
    return StackParams(w1=normal(), b1=z, w2=normal(), b2=z.clone())


def block_apply(p: StackParams, s: int, h: torch.Tensor) -> torch.Tensor:
    """One residual block (stage ``s``'s params): h + W2·relu(W1·h)."""
    inner = torch.relu(h @ p.w1[s] + p.b1[s])
    return h + inner @ p.w2[s] + p.b2[s]


def stack_apply(p: StackParams, h: torch.Tensor) -> torch.Tensor:
    """The sequential form: all S blocks in order, on one device."""
    for s in range(p.w1.shape[0]):
        h = block_apply(p, s, h)
    return h


def make_pipeline(mesh, params: StackParams, n_micro: int,
                  axis: Optional[str] = None):
    """→ (sharded_params, run(params, x) → y): the stages over ``axis``
    (default the mesh's first) and ``x [B, H]`` in ``n_micro``
    microbatches. ``B`` must divide by ``n_micro``, and the stage count
    must be the axis size (one stage per shard)."""
    from real_time_fraud_detection_system_tpu_torch.parallel.distributed \
        import mesh_axes

    axis = axis or mesh_axes(mesh)[0]
    n_dev = axis_size(mesh, axis)
    s_total = params.w1.shape[0]
    if s_total != n_dev:
        raise ValueError(
            f"{s_total} stages on a {n_dev}-device '{axis}' axis "
            "(want exactly one stage per device)")
    dev = mesh_device(mesh)
    sharded = StackParams(*[t.to(dev) for t in params])

    def run(p: StackParams, x: torch.Tensor) -> torch.Tensor:
        b, h_dim = x.shape
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible by {n_micro}")
        mb = x.to(dev).reshape(n_micro, b // n_micro, h_dim)
        h_cur = torch.zeros((n_dev,) + tuple(mb.shape[1:]), dtype=x.dtype,
                            device=dev)
        outs = []
        for t in range(n_micro + n_dev - 1):
            # stage 0 takes microbatch t; stage s holds microbatch t - s
            h_in = [mb[t] if s == 0 and t < n_micro else h_cur[s]
                    for s in range(n_dev)]
            h_out = torch.stack([
                block_apply(p, s, h_in[s]) if 0 <= t - s < n_micro
                else h_in[s] for s in range(n_dev)])
            if t >= n_dev - 1:  # the last stage emits t - (S - 1)
                outs.append(h_out[n_dev - 1])
            h_cur = torch.roll(h_out, 1, 0)  # stage s → s + 1
        return torch.stack(outs).reshape(b, h_dim)

    return sharded, run
