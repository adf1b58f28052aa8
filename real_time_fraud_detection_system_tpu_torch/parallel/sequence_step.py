"""The sequence kind over shards — port of the JAX package's
``parallel/sequence_step.py`` for shards that share one device.

The history state is keyed by customer alone, so with rows partitioned by
``customer % n_dev`` (``parallel/step.py::partition_batch_spill``, chunk 0)
every update and read of a shard's rows stays in its own block: the
owner-local step needs no exchange. The transformer's params are shared.
Hot-key spill chunks place rows on any shard; they run the routed step:
each row's (key, day, tod, amount, valid) and its original batch position
go to the customer's owner through the bucketed exchange of
``parallel/step.py`` (``owner_route``: on co-located shards a transpose of
one tensor), the owner runs the same history step, and the probabilities
come back through the inverse exchange. As in the JAX package, a spill
chunk is a later step than chunk 0 (chunks behave as consecutive
micro-batches), and within a chunk the step orders each customer's rows by
time and then by their original batch position, so same-second ties keep
the single engine's order.

The layout is the JAX one, so a checkpoint's leaves are the same arrays in
both packages: every ``features/history.py::HistoryState`` leaf gains a
leading shard axis ``[n, cap_local + 1, ...]``, each block a whole local
state with its own sink row. Key k lives on shard ``k % n`` at local slot
``(k // n) & (cap_local - 1)``, which requires ``key_mode="direct"`` and a
power-of-two ``cap_local``.

The step runs ``features/history.py::update_and_score`` once per shard, on
that shard's block as a state of views (written in place), as
``parallel/step.py::make_sharded_compact`` walks the shards: a padded row
scatters to ``state.capacity``, which is then the block's own sink. The
shards run one after another on the current stream, with no host sync.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core.batch import TxBatch
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    Mesh,
    _check_colocated,
)
from real_time_fraud_detection_system_tpu_torch.parallel.step import (
    _u64,
    owner_route,
)

# features/history.py imports models/sequence.py, which imports this
# package's ring_attention: importing history here would close a cycle
# through the package's __init__, so it is imported where it is used.


def _history():
    from real_time_fraud_detection_system_tpu_torch.features import history

    return history


def _stacked_blank(fcfg, n_dev: int, device=None):
    """The one source of the sharded layout: ``n_dev`` stacked empty local
    blocks, each with its own sink row; tensors on ``device``, or host
    numpy arrays when ``device`` is None."""
    h = _history()
    local = h.init_history_state(dataclasses.replace(
        fcfg, customer_capacity=fcfg.customer_capacity // n_dev),
        "cpu" if device is None else device)
    stacked = [t[None].expand((n_dev,) + tuple(t.shape)).clone()
               for t in local]
    if device is None:
        return h.HistoryState(*[t.numpy() for t in stacked])
    return h.HistoryState(*stacked)


def _require_pow2_local(cap_local: int) -> None:
    """The local slot is ``(key // n) & (cap_local - 1)``: a modulo only
    for a power-of-two ``cap_local``. Any other would pass the
    divisibility check yet merge distinct customers' histories."""
    if cap_local <= 0 or (cap_local & (cap_local - 1)):
        raise ValueError(
            f"customer_capacity / n_devices must be a power of two, got "
            f"{cap_local}")


def init_sharded_history_state(cfg: Config, mesh: Mesh):
    """Empty ``[n, cap_local + 1, ...]`` leaves on the mesh's device."""
    mesh = _check_colocated(mesh)
    n_dev = len(mesh)
    fcfg = cfg.features
    if fcfg.customer_capacity % n_dev:
        raise ValueError("customer_capacity must divide by n_devices")
    _require_pow2_local(fcfg.customer_capacity // n_dev)
    if fcfg.key_mode != "direct":
        raise ValueError(
            "sharded sequence serving requires key_mode='direct' "
            "(owner = key % n_dev, local slot = key // n_dev)")
    return _stacked_blank(fcfg, n_dev, mesh[0])


def shard_history_state(state, mesh: Mesh, out=None):
    """Place a stacked state (host arrays or tensors) on the mesh's
    device; with ``out`` (an engine's state) copy it into those tensors in
    place instead, so they keep their addresses."""
    mesh = _check_colocated(mesh)
    leaves = [torch.as_tensor(np.asarray(a)) if not isinstance(
        a, torch.Tensor) else a for a in state]
    if out is None:
        return _history().HistoryState(*[t.to(mesh[0]).clone()
                                          for t in leaves])
    for dst, src in zip(out, leaves):
        if dst.shape != src.shape:
            raise ValueError(
                f"history leaf {list(src.shape)} does not fit the "
                f"engine's {list(dst.shape)}")
        dst.copy_(src)
    return out


def _np(leaf) -> np.ndarray:
    """A host copy (never a view of an engine's tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy().copy()
    return np.array(leaf, copy=True)


def reshard_history_state(state, cfg: Config, n_dev_new: int):
    """Convert a history state between widths, exactly.

    With direct keys below the capacity both maps are bijective (one
    device: slot = key; sharded: owner = key % n, local slot = key // n),
    so a single-device state restores into an 8-shard engine, or 8 shards
    into 4, with the same serving behaviour. Takes either layout (single
    ``[C+1, ...]`` leaves or stacked ``[n, C/n+1, ...]``) and returns host
    numpy arrays in the target layout (``n_dev_new == 1``: single);
    :func:`shard_history_state` places them."""
    h = _history()
    fcfg = cfg.features
    cap = fcfg.customer_capacity
    if fcfg.key_mode != "direct":
        raise ValueError("elastic re-shard requires key_mode='direct'")

    def to_single(s) -> list:
        leaves = [_np(a) for a in s]
        if leaves[0].ndim == 3:  # already single [C+1, K, F]
            if leaves[0].shape[0] != cap + 1:
                raise ValueError(
                    f"state capacity {leaves[0].shape[0] - 1} != "
                    f"config capacity {cap}")
            return leaves
        n_old = leaves[0].shape[0]
        cap_local = leaves[0].shape[1] - 1
        _require_pow2_local(cap_local)
        if n_old * cap_local != cap:
            raise ValueError(
                f"state layout {n_old}x{cap_local} != config "
                f"capacity {cap} — re-sharding a checkpoint taken under "
                "a different customer_capacity would silently merge or "
                "drop customers")
        out = [t.numpy() for t in h.init_history_state(fcfg, "cpu")]
        keys = np.arange(cap)
        owner, local = keys % n_old, (keys // n_old) & (cap_local - 1)
        for i, a in enumerate(leaves):
            out[i][keys] = a[owner, local]
        return out

    single = to_single(state)
    if n_dev_new == 1:
        return h.HistoryState(*single)
    if cap % n_dev_new:
        raise ValueError("customer_capacity must divide by n_dev_new")
    cap_local = cap // n_dev_new
    _require_pow2_local(cap_local)
    out = list(_stacked_blank(fcfg, n_dev_new))
    keys = np.arange(cap)
    owner, local = keys % n_dev_new, (keys // n_dev_new) & (cap_local - 1)
    for i, a in enumerate(single):
        out[i][owner, local] = a[keys]
    return h.HistoryState(*out)


def _shard(hstate, s: int):
    """Shard ``s``'s block as a local state of views (writes land in the
    stack)."""
    return type(hstate)(*[t[s] for t in hstate])


def make_sharded_sequence_step(cfg: Config, mesh: Mesh,
                               route: bool = False):
    """→ ``step(hstate, params, batch, order_key) -> (hstate, probs)``.

    ``batch`` is a ``TxBatch`` of tensors ``[n_dev · B_local]`` laid out
    owner-major (the engine's partitioned chunk); ``order_key`` int32
    ``[n_dev · B_local]`` is each row's original batch position (the
    same-second tie-breaker: chunk packing and routing both move rows).
    ``route=False`` takes owner-placed rows; ``route=True`` sends each row
    to its customer's owner first and routes the probabilities back (the
    spill chunks). The state is written in place and returned; ``probs``
    is in the chunk's row order, padded rows 0."""
    mesh = _check_colocated(mesh)
    n_dev = len(mesh)
    fcfg = cfg.features
    cap_local = fcfg.customer_capacity // n_dev
    lcfg = dataclasses.replace(fcfg, customer_capacity=cap_local)
    update_and_score = _history().update_and_score

    def slot_fn(key):
        return (_u64(key) // n_dev) & (cap_local - 1)

    def step(hstate, params, batch: TxBatch,
             order_key: torch.Tensor):
        bl = batch.size // n_dev

        def rows(x):
            return x.reshape((n_dev, bl) + tuple(x.shape[1:]))

        if route:
            valid = rows(batch.valid)
            dest = _u64(rows(batch.customer_key)) % n_dev
            send_pos, xchg, scatter = owner_route(dest, valid, n_dev, bl)

            def send(x, fill=0):
                return xchg(scatter(rows(x), fill))

            ck = send(batch.customer_key.view(torch.int32)).view(
                torch.uint32)
            day, tod, amt = (send(batch.day), send(batch.tod_s),
                             send(batch.amount))
            ok = xchg(scatter(valid, fill=False))
            r_order = send(order_key)
            r_probs = []
            for s in range(n_dev):
                rb = TxBatch(
                    customer_key=ck[s], terminal_key=torch.zeros_like(ck[s]),
                    day=day[s], tod_s=tod[s], amount=amt[s],
                    label=torch.full_like(day[s], -1), valid=ok[s])
                r_probs.append(update_and_score(
                    _shard(hstate, s), params, rb, lcfg, slot_fn,
                    order_key=r_order[s])[1])
            probs = torch.gather(xchg(torch.stack(r_probs)), 1, send_pos)
            return hstate, probs.reshape(-1)
        probs = [update_and_score(
            _shard(hstate, s), params,
            TxBatch(*[x[s * bl:(s + 1) * bl] for x in batch]), lcfg,
            slot_fn, order_key=order_key[s * bl:(s + 1) * bl])[1]
            for s in range(n_dev)]
        return hstate, torch.cat(probs)

    return step
