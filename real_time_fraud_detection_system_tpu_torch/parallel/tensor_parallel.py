"""Tensor parallelism: the Megatron split of the MLP and the sequence
transformer — port of the JAX package's ``parallel/tensor_parallel.py``.

The MLP of ``models/mlp.py`` shards over a mesh axis the standard way:
layer 1 column-parallel (``W1 [F, H]`` split on H, each shard computes
its slice of the hidden activation), layer 2 row-parallel (``W2 [H, H2]``
split on the contraction axis, the partial products summed over the
shards: the one exchange of the forward), the rest replicated. The
transformer splits each block's Q/K/V on the head axis (softmax is per
head, so head-sharded attention is exact), its output projection
row-parallel, and its MLP column/row; embeddings, layer norms and the
head are replicated. Both run the unsharded code's arithmetic: the
transformer through the same ``models/sequence.py::transformer_logits``,
given Megatron's two functions as its hooks:

- *g* (:func:`_allreduce_g`): the sum over the shards forward, identity
  backward. A plain sum would transpose to another sum and inflate the
  sharded weights' gradients by the axis size, since the cotangent
  arriving from the replicated downstream is already each shard's own;
- *f* (:func:`_identity_f`): identity forward, the sum backward, at the
  entry of a sharded region, so the gradients of replicated upstream
  params count every shard's heads, not only the local ones.

Each is a ``torch.autograd.Function``. The JAX module runs a per-shard
function under ``shard_map``; here the shards of a mesh share one device
(``parallel/mesh.py``), so every shard runs at once on stacked tensors:
each leaf gets leading ``[n_dp, n_tp]`` shard dims (replicated leaves a
copy per shard, as ``shard_map`` gives each shard its own), the batch
``[n_dp, 1, ...]``, and a sum over the shards is a sum over the stacked
axis. Each shard differentiates its own loss, so the gradients are the
JAX ones shard for shard. On a ``parallel/distributed.py::SpanningMesh``
a process holds its block of the axis and the sum continues across the
processes as a gloo ``all_reduce``.

The functions take and return the params in their global form (the
sharded arrays' global view in JAX), on the mesh's device: a step slices
each process's shards out, updates them, and assembles the result (an
``all_gather`` across processes).

:func:`make_tp_mlp` and :func:`make_tp_step` are pure tensor parallelism
(the batch replicated, the weights split); :func:`make_dp_tp_step` adds a
data-parallel axis on a 2-axis mesh (``make_hybrid_mesh(...,
dcn_axis="dp", ici_axis="tp")``): rows shard over ``dp``, and the
gradients are averaged over it, the one exchange data parallelism adds.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from real_time_fraud_detection_system_tpu_torch.models.mlp import MLPParams
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    axis_size,
    mesh_device,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree


class _Axis(NamedTuple):
    """A mesh axis over stacked shards: the leading dim it runs along,
    and whether it continues across the process group."""

    dim: int
    spans: bool = False


def _psum(x: torch.Tensor, ax: _Axis) -> torch.Tensor:
    """The sum over ``ax``'s shards, on every shard."""
    s = x.sum(ax.dim, keepdim=True)
    if ax.spans:
        import torch.distributed as dist

        s = s.contiguous()
        dist.all_reduce(s)
    return s.expand_as(x).clone()


class _AllreduceG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _psum(x, ax)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


class _IdentityF(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return _psum(ct, ctx.ax), None


def _allreduce_g(axis: _Axis):
    """Megatron's *g*: the sum over ``axis`` forward, identity backward."""
    return lambda x: _AllreduceG.apply(x, axis)


def _identity_f(axis: _Axis):
    """Megatron's *f*: identity forward, the sum over ``axis`` backward."""
    return lambda x: _IdentityF.apply(x, axis)


class _Grid(NamedTuple):
    """This process's shards of a (dp ×) tp mesh: ``n_dp`` data-parallel
    rows, the tp axis of ``n_tp`` shards of which this process holds
    ``[lo, lo + local)``."""

    n_dp: int
    n_tp: int
    lo: int
    local: int
    spans: bool
    device: torch.device


def _grid(mesh, axis: str, dp_axis: Optional[str] = None) -> _Grid:
    n_tp = axis_size(mesh, axis)
    spans = bool(getattr(mesh, "spans_processes", False))
    if spans and dp_axis:
        raise ValueError(
            "a mesh spanning processes has one axis; the dp × tp step "
            "runs on co-located shards (make_hybrid_mesh)")
    n_dp = axis_size(mesh, dp_axis) if dp_axis else 1
    local = len(mesh.local_devices) if spans else n_tp
    lo = mesh.process_id * local if spans else 0
    return _Grid(n_dp, n_tp, lo, local, spans, mesh_device(mesh))


def _stack(a: torch.Tensor, dim: Optional[int], g: _Grid, extra: int,
           grad: bool = False) -> torch.Tensor:
    """A global leaf → this process's shards ``[n_dp, local, (1,) *
    extra, ...]``: its slices along ``dim``, or a copy per shard when it
    is replicated (``dim`` None). The ``extra`` unit dims let the leaf
    broadcast against activations with more leading dims than it has."""
    a = a.to(g.device)
    if dim is None:
        piece = a[None].expand((g.local,) + tuple(a.shape))
    else:
        piece = torch.stack(a.chunk(g.n_tp, dim)[g.lo:g.lo + g.local])
    piece = piece[None].expand((g.n_dp,) + tuple(piece.shape))
    out = piece.reshape(tuple(piece.shape[:2]) + (1,) * extra
                        + tuple(piece.shape[2:])).clone()
    return out.requires_grad_(grad)


def _unstack(s: torch.Tensor, dim: Optional[int], g: _Grid,
             extra: int) -> torch.Tensor:
    """The inverse of :func:`_stack` for a leaf every dp row holds
    alike: the global leaf, its slices gathered from every process."""
    s = s.detach()[0]
    s = s.reshape(tuple(s.shape[:1]) + tuple(s.shape[1 + extra:]))
    if dim is None:
        return s[0].clone()
    local = torch.cat(list(s), dim)
    if not g.spans:
        return local
    import torch.distributed as dist

    parts = [torch.empty_like(local) for _ in range(g.n_tp // g.local)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts, dim)


def _flat_specs(spec) -> list:
    """A spec tree's entries in the params' flatten order, None kept."""
    if isinstance(spec, (tuple, list)):
        return [x for s in spec for x in _flat_specs(s)]
    return [spec]


def _stack_tree(params, spec, g: _Grid, extra, grad: bool = False):
    dims = _flat_specs(spec)
    return tree.unflatten(params, [
        _stack(a, d, g, extra(a.dim()), grad)
        for a, d in zip(tree.leaves(params), dims)])


def _unstack_tree(stacked, params, spec, g: _Grid, extra):
    dims = _flat_specs(spec)
    return tree.unflatten(params, [
        _unstack(s, d, g, extra(a.dim()))
        for s, a, d in zip(tree.leaves(stacked), tree.leaves(params), dims)])


def _mlp_extra(ndim: int) -> int:
    # activations [n_dp, n_tp, B, H]: a bias [H] needs a unit dim for B
    return 1 if ndim == 1 else 0


def tp_specs(params: MLPParams) -> List[Tuple[Optional[int],
                                             Optional[int]]]:
    """The sharded dim of each ``(W, b)`` (None: replicated): layer 1
    column-parallel, layer 2 row-parallel, the rest replicated — the JAX
    PartitionSpecs ``(P(None, "tp"), P("tp"))``, ``(P("tp", None),
    P(None))``, replicated."""
    return [(1, 0) if i == 0 else (0, None) if i == 1 else (None, None)
            for i in range(len(params))]


def shard_mlp_params(params: MLPParams, mesh, axis: str) -> MLPParams:
    """The params on the mesh's device, in their global form (the
    tensor-parallel layout is taken per call, :func:`tp_specs`)."""
    axis_size(mesh, axis)
    dev = mesh_device(mesh)
    return [(w.to(dev), b.to(dev)) for w, b in params]


def _check_tp(params: MLPParams, n_shards: int) -> None:
    if len(params) < 3:
        # with 2 layers, the row-parallel layer would BE the head and the
        # hidden relu below would corrupt the logits
        raise ValueError(
            "tensor-parallel MLP needs >= 2 hidden layers "
            "(mlp_hidden=(H1, H2, ...))")
    h_dim = params[0][0].shape[1]
    if h_dim % n_shards:
        raise ValueError(
            f"hidden width {h_dim} not divisible by {n_shards} shards")


def tp_mlp_logits(params: MLPParams, x: torch.Tensor,
                  axis: _Axis) -> torch.Tensor:
    """Every shard's forward at once: stacked params (:func:`_stack`),
    ``x [n_dp, 1, B, F]``, L1 column-sharded and L2 row-sharded → the full
    logits ``[n_dp, n_tp, B]`` on every shard after one sum."""
    (w1, b1), (w2, b2) = params[0], params[1]
    h = torch.relu(x @ w1 + b1)  # [.., B, H/n] local
    partial_h2 = h @ w2  # [.., B, H2] partial over the contraction
    h2 = _allreduce_g(axis)(partial_h2) + b2  # the one forward exchange
    h = torch.relu(h2)
    for w, b in params[2:-1]:
        h = torch.relu(h @ w + b)
    w, b = params[-1]
    return (h @ w + b)[..., 0]


def _mesh_axis(mesh, axis: Optional[str]) -> str:
    from real_time_fraud_detection_system_tpu_torch.parallel.distributed \
        import mesh_axes

    return axis or mesh_axes(mesh)[-1]


def make_tp_mlp(mesh, params: MLPParams, axis: Optional[str] = None):
    """→ (sharded_params, predict_proba(params, x)) over the mesh's last
    axis (or ``axis``): ``x`` replicated (pure tensor parallelism). Needs
    ≥ 2 hidden layers and a hidden width divisible by the axis size."""
    axis = _mesh_axis(mesh, axis)
    g = _grid(mesh, axis)
    _check_tp(params, g.n_tp)
    sharded = shard_mlp_params(params, mesh, axis)
    spec = tp_specs(params)
    ax = _Axis(1, g.spans)

    @torch.no_grad()
    def predict_proba(p, x):
        st = _stack_tree(p, spec, g, _mlp_extra)
        logits = tp_mlp_logits(st, x.to(g.device)[None, None], ax)
        return torch.sigmoid(logits)[0, 0]

    return sharded, predict_proba


def _sigmoid_bce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """``optax.sigmoid_binary_cross_entropy``'s form."""
    return -y * F.logsigmoid(logits) - (1.0 - y) * F.logsigmoid(-logits)


def make_tp_step(mesh, params: MLPParams, lr: float = 1e-2,
                 axis: Optional[str] = None,
                 dp_axis: Optional[str] = None):
    """→ (sharded_params, step(params, x, y) → (params, loss)): one SGD
    step with the weights split over ``axis``; each shard's weight
    gradients stay its own (:func:`_allreduce_g`).

    With ``dp_axis`` (a 2-axis mesh) the batch rows shard over it and the
    gradients (and the reported loss) are averaged over it, so every dp
    row applies the same update. The batch size must divide by the dp
    axis."""
    axis = _mesh_axis(mesh, axis)
    g = _grid(mesh, axis, dp_axis)
    _check_tp(params, g.n_tp)
    sharded = shard_mlp_params(params, mesh, axis)
    spec = tp_specs(params)
    ax = _Axis(1, g.spans)
    n_dp = g.n_dp

    def step(p, x, y):
        b = x.shape[0]
        if b % n_dp:
            raise ValueError(f"batch {b} does not divide over {n_dp} "
                             f"dp rows")
        st = _stack_tree(p, spec, g, _mlp_extra, grad=True)
        xs = x.to(g.device).reshape(n_dp, 1, b // n_dp, x.shape[1])
        ys = y.to(g.device).float().reshape(n_dp, 1, b // n_dp)
        loss = _sigmoid_bce(tp_mlp_logits(st, xs, ax), ys).mean(-1)
        leaves = tree.leaves(st)
        grads = torch.autograd.grad(loss.sum(), leaves)
        loss = loss.detach()
        if dp_axis:
            # the one extra data-parallel exchange: the mean over dp rows
            grads = [gr.sum(0, keepdim=True).expand_as(gr) / n_dp
                     for gr in grads]
            loss = loss.sum(0, keepdim=True) / n_dp
        new = tree.unflatten(st, [
            w.detach() - lr * gr for w, gr in zip(leaves, grads)])
        return _unstack_tree(new, p, spec, g, _mlp_extra), loss[0, 0]

    return sharded, step


def make_dp_tp_step(mesh, params: MLPParams, lr: float = 1e-2,
                    dp_axis: str = "dp", tp_axis: str = "tp"):
    """The 2D dp × tp training step on a 2-axis mesh: see
    :func:`make_tp_step`."""
    return make_tp_step(mesh, params, lr=lr, axis=tp_axis, dp_axis=dp_axis)


# ---------------------------------------------------------------------------
# the transformer (Megatron attention + MLP split of models/sequence.py)
# ---------------------------------------------------------------------------


def transformer_tp_specs(params):
    """The sharded dim of each ``TransformerParams`` leaf (None:
    replicated): per block Q/K/V on the head axis, the output projection
    row-parallel, the MLP column/row split; embeddings, layer norms and
    the head replicated."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        BlockParams,
        TransformerParams,
    )

    blk = BlockParams(ln1_g=None, ln1_b=None, wq=1, wk=1, wv=1, wo=0,
                      ln2_g=None, ln2_b=None, w1=1, b1=0, w2=0, b2=None)
    return TransformerParams(
        embed_w=None, embed_b=None, blocks=tuple(blk for _ in params.blocks),
        lnf_g=None, lnf_b=None, head_w=None, head_b=None)


def _tf_extra(ndim: int) -> int:
    # activations [n_dp, n_tp, B, T, D]: a vector needs unit dims for B
    # and T, a matrix (a matmul or einsum operand) one for B
    return 2 if ndim == 1 else 1


def tp_transformer_logits(params, x: torch.Tensor,
                          axis: _Axis) -> torch.Tensor:
    """Every shard's causal-transformer forward at once (stacked params,
    ``x [n_dp, 1, B, T, F]``): the same
    ``models/sequence.py::transformer_logits``, its two row-parallel
    contractions per block summed by :func:`_allreduce_g` (the
    ``reduce_fn`` hook) and its sharded regions entered through
    :func:`_identity_f`. Attention is naive-causal over the local heads."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        transformer_logits,
    )

    return transformer_logits(params, x, reduce_fn=_allreduce_g(axis),
                              enter_fn=_identity_f(axis))


def _shard_transformer(mesh, params, axis: str):
    """Check the divisibility and place the params: the specs and the
    global params on the mesh's device."""
    n = axis_size(mesh, axis)
    n_heads = params.blocks[0].wq.shape[1]
    d_ff = params.blocks[0].w1.shape[1]
    if n_heads % n or d_ff % n:
        raise ValueError(
            f"n_heads {n_heads} and d_ff {d_ff} must divide by {n} shards")
    dev = mesh_device(mesh)
    return (transformer_tp_specs(params),
            tree.map(lambda a: a.to(dev), params))


def make_tp_transformer_step(mesh, params, lr: float = 1e-3,
                             pos_weight: float = 1.0,
                             axis: Optional[str] = None,
                             dp_axis: Optional[str] = None):
    """→ (sharded_params, step(params, x, y, mask) → (params, loss)): one
    SGD step of the head- and MLP-sharded transformer (the masked BCE of
    ``models/sequence.py::transformer_loss``). With ``dp_axis`` (a 2-axis
    mesh) rows shard over it, and each group's loss and gradients are
    weighted by its share of the mask's weight, so the combined update
    equals the full-batch masked mean."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        transformer_loss,
    )

    axis = _mesh_axis(mesh, axis)
    specs, sharded = _shard_transformer(mesh, params, axis)
    g = _grid(mesh, axis, dp_axis)
    ax = _Axis(1, g.spans)
    n_dp = g.n_dp

    def step(p, x, y, mask):
        b = x.shape[0]
        if b % n_dp:
            raise ValueError(f"batch {b} does not divide over {n_dp} "
                             f"dp rows")

        def rows(t):
            t = t.to(g.device)
            return t.reshape((n_dp, 1, b // n_dp) + tuple(t.shape[1:]))

        xs, ys, ms = rows(x), rows(y), rows(mask)
        st = _stack_tree(p, specs, g, _tf_extra, grad=True)
        loss = transformer_loss(st, xs, ys, ms, pos_weight=pos_weight,
                                reduce_fn=_allreduce_g(ax),
                                enter_fn=_identity_f(ax))  # [n_dp, n_tp]
        leaves = tree.leaves(st)
        grads = torch.autograd.grad(loss.sum(), leaves)
        loss = loss.detach()
        if dp_axis:
            # each group weighted by its weight mass, the mass its loss
            # normalizes by (clamped at 1 as the loss clamps it), so the
            # combination is the full-batch masked mean; an empty group
            # carries no weight
            wts = torch.where(ys.float() > 0,
                              torch.full_like(ys, pos_weight,
                                              dtype=torch.float32),
                              torch.ones_like(ys, dtype=torch.float32))
            w = (wts * ms.float()).sum((-2, -1))  # [n_dp, 1]
            tot = torch.clamp(w.sum(0, keepdim=True), min=1.0)
            scale = torch.clamp(w, min=1.0) / tot
            grads = [(gr * scale.reshape(scale.shape + (1,) * (
                gr.dim() - 2))).sum(0, keepdim=True).expand_as(gr)
                for gr in grads]
            loss = (loss * scale).sum(0, keepdim=True)
        new = tree.unflatten(st, [
            v.detach() - lr * gr for v, gr in zip(leaves, grads)])
        return _unstack_tree(new, p, specs, g, _tf_extra), loss[0, 0]

    return sharded, step


def make_tp_transformer(mesh, params, axis: Optional[str] = None):
    """→ (sharded_params, logits(params, x)) with the heads and the MLP
    hidden split over ``axis``. ``n_heads`` and ``d_ff`` must divide by
    the axis size."""
    axis = _mesh_axis(mesh, axis)
    specs, sharded = _shard_transformer(mesh, params, axis)
    g = _grid(mesh, axis)
    ax = _Axis(1, g.spans)

    @torch.no_grad()
    def logits(p, x):
        st = _stack_tree(p, specs, g, _tf_extra)
        return tp_transformer_logits(st, x.to(g.device)[None, None],
                                     ax)[0, 0]

    return sharded, logits
