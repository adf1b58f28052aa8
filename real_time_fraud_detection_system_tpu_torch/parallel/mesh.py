"""The shard mesh and the feature state's sharded layout — port of the
one-process part of the JAX package's ``parallel/mesh.py``.

The JAX package serves one stream over a ``jax.sharding.Mesh`` of N
devices. Here a mesh is an ordered tuple of ``torch.device``s, one per
shard, and in this port every shard of a mesh lives on ONE device: the
sharded engine (``runtime/sharded_engine.py``) runs its N shards in one
process, as the JAX tests run theirs on 8 virtual CPU devices. A mesh over
distinct devices is the fleet's (one process per GPU over
``torch.distributed``, ROADMAP A7c) and raises here.

The layout is the JAX package's, so a checkpoint's leaves are the same
arrays in both packages:

- window tables stay GLOBAL ``[cap, NB]`` arrays, owner-major: shard
  ``k % n`` owns rows ``[owner·cap/n, (owner+1)·cap/n)`` and places key k
  at local slot ``(k // n) & (cap/n - 1)`` (:func:`_layout_perm`);
- the customer sketch gets a leading shard axis ``[n, ND, depth, width]``
  (each shard sketches its own customers).

:func:`reshard_feature_state` converts a state between widths (exact for
direct keys; the sketch merges under the newest-day rule,
:func:`_merge_sketch`) and returns host arrays; :func:`shard_feature_state`
places them (into an engine's own tensors when ``out`` is given).
``merge_process_states`` and ``adopt_process_slice`` belong to the fleet
(A7c); the tiered store's ``_reshard_exact`` to A7b.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

Mesh = Tuple[torch.device, ...]


def _visible_devices() -> list:
    if not torch.cuda.is_available():
        return []
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _check_colocated(mesh: Mesh) -> Mesh:
    """A mesh of this slice: every shard on one device."""
    if len(set(mesh)) > 1:
        raise ValueError(
            f"a mesh over distinct devices ({sorted(set(map(str, mesh)))}) "
            "is the fleet's: one process per GPU over torch.distributed, "
            "not ported yet (ROADMAP A7c); co-locate the shards with "
            "devices=[device] * n")
    return mesh


def make_mesh(n_devices: int = 0, devices: Optional[Sequence] = None
              ) -> Mesh:
    """A mesh of ``n_devices`` shards. ``devices`` places them: a list of
    one device per shard (``[d] * n`` co-locates N shards on ``d``, the
    counterpart of the JAX tests' forced host device count). Without it,
    as the JAX ``make_mesh``: the first ``n_devices`` distinct visible
    CUDA devices (0: all of them), raising when fewer are visible."""
    if devices is not None:
        mesh = tuple(resolve_device(d) for d in devices)
        if n_devices and len(mesh) != n_devices:
            raise ValueError(f"requested {n_devices} shards, devices= "
                             f"lists {len(mesh)}")
        if not mesh:
            raise ValueError("a mesh needs at least one device")
        return _check_colocated(mesh)
    devs = _visible_devices()
    if n_devices == 0:
        n_devices = len(devs)
    if n_devices < 1 or n_devices > len(devs):
        raise ValueError(
            f"requested {n_devices} devices, only {len(devs)} visible "
            "(pass devices=[device] * n to place n shards on one device)")
    return _check_colocated(tuple(devs[:n_devices]))


def make_local_mesh(n_devices: int = 0, devices: Optional[Sequence] = None
                    ) -> Mesh:
    """The process-local serving mesh: :func:`make_mesh` in one process
    (the JAX package's differs only under ``jax.distributed``, A7c)."""
    return make_mesh(n_devices, devices)


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def shard_feature_state(state: FeatureState, mesh: Mesh,
                        out: Optional[FeatureState] = None) -> FeatureState:
    """Place a feature state (host arrays or tensors) on the mesh's device
    in the sharded layout: window tables as they are (global, already
    owner-major), a single-layout sketch expanded to one replica per
    shard on the device (one host copy, never N), a stacked sketch of the
    mesh's width as it is. ``out`` (an engine's state) receives the values
    in place, in its own layout — a single-device engine's sketch stays
    single — so its tensors keep their addresses."""
    n = len(mesh)
    dev = mesh[0]
    if state.customer_dir is not None or state.terminal_dir is not None:
        raise ValueError(
            "key_mode='exact' over the mesh (per-shard key directories) is "
            "the tiered store across shards: ROADMAP A7b")
    placed = tree.map(lambda a: torch.as_tensor(_np(a)).to(dev),
                      state._replace(terminal_cms=None))
    cms = placed.cms
    if cms is not None:
        stacked = cms.slice_day.dim() == 2
        if stacked and cms.slice_day.shape[0] != n:
            raise ValueError(
                f"cms is laid out for {cms.slice_day.shape[0]} shard(s), "
                f"mesh has {n} — convert it with reshard_feature_state")
        want = out.cms.slice_day.dim() == 2 if out is not None else True
        if want and not stacked:
            placed = placed._replace(cms=tree.map(
                lambda t: t[None].expand((n,) + tuple(t.shape))
                .contiguous(), cms))
    if out is None:
        return placed
    for dst, src in zip(tree.leaves(out), tree.leaves(placed)):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(
                f"state leaf {list(src.shape)} {src.dtype} does not fit the "
                f"engine's {list(dst.shape)} {dst.dtype}")
        dst.copy_(src)
    return out


def _layout_perm(cap: int, n_dev: int) -> np.ndarray:
    """Global table row of key k under the n-device owner layout.

    Single device (n=1): row = k. Sharded: device ``k % n`` owns rows
    ``[owner * cap/n, (owner+1) * cap/n)`` and places k at local slot
    ``k // n`` (``parallel/step.py``'s ``(key // n) & (cap_local - 1)``, a
    no-op mask for k < cap) — so row = (k % n) * (cap/n) + k // n. A
    bijection for pow2 cap/n, which the sharded step validates."""
    k = np.arange(cap)
    if n_dev == 1:
        return k
    return (k % n_dev) * (cap // n_dev) + k // n_dev


def reshard_feature_state(state: FeatureState, cfg, n_old: int, n_new: int
                          ) -> FeatureState:
    """Re-layout of the window feature state between shard counts, as the
    JAX function does it: in ``direct`` key mode the slot maps are
    bijections, so a single-device state converted to 8 shards (or n→m)
    serves on as if the stream had always run at the new width. The
    sketch merges to the single layout (:func:`_merge_sketch`), which
    :func:`shard_feature_state` expands per shard at placement. Layouts
    are positional, so the caller states ``n_old``. Returns host arrays.

    Refused as in the JAX package: hash keys (a permutation cannot
    un-merge colliding keys), a capacity that does not divide by a width
    or whose share is not a power of two, and a table whose rows differ
    from the config's capacity. ``key_mode="exact"`` (the directories'
    re-home) is A7b."""
    fcfg = cfg.features
    if fcfg.key_mode == "exact":
        raise ValueError(
            "re-sharding the tiered store (key_mode='exact': per-shard key "
            "directories re-homed by key % n_new) is not ported yet: "
            "ROADMAP A7b")
    if fcfg.key_mode != "direct":
        raise ValueError(
            "elastic re-shard requires key_mode='direct' or 'exact' "
            "(hash mode merges colliding keys — a permutation cannot "
            "un-merge them)")
    for n in (n_old, n_new):
        if n < 1:
            raise ValueError(f"device counts must be >= 1, got {n}")
        for name, cap in (("customer", fcfg.customer_capacity),
                          ("terminal", fcfg.terminal_capacity)):
            if cap % n:
                raise ValueError(
                    f"{name}_capacity {cap} must divide by {n}")
            local = cap // n
            if local & (local - 1):
                raise ValueError(
                    f"{name}_capacity / {n} must be a power of two, "
                    f"got {local}")

    def convert(ws, cap: int):
        p_old = _layout_perm(cap, n_old)
        p_new = _layout_perm(cap, n_new)

        def re(leaf):
            a = _np(leaf)
            if a.shape[0] != cap:
                raise ValueError(
                    f"state table has {a.shape[0]} rows, config says "
                    f"{cap} — re-sharding a checkpoint taken under a "
                    "different capacity would merge or drop keys")
            out = np.empty_like(a)
            out[p_new] = a[p_old]
            return out

        return tree.map(re, ws)

    return state._replace(
        customer=convert(state.customer, fcfg.customer_capacity),
        terminal=convert(state.terminal, fcfg.terminal_capacity),
        cms=_merge_sketch(state.cms, n_old),
    )


def _merge_sketch(cms, n_old: int):
    """Per-shard sketches → ONE single-layout sketch (host arrays).

    The shards sketch disjoint key partitions, so counts add — but a quiet
    shard's day ring lags (a slice advances only when that shard sees
    traffic for the day). Per slice the NEWEST stamp wins and only the
    shards holding it are summed: a stale slice would have been reset when
    that day reached its shard, which provably saw no such-day traffic.
    A replicated warm start summed again by a later merge over-counts,
    which keeps the sketch an upper bound (the JAX package's caveat). A
    None fraud column stays None; a single-layout sketch passes as it
    is."""
    if cms is None:
        return None
    leaves = [None if a is None else _np(a) for a in cms]
    if n_old > 1 and leaves[0].ndim > 1:
        if leaves[0].shape[0] != n_old:
            raise ValueError(
                f"cms device axis {leaves[0].shape[0]} != n_old {n_old}")
        days = leaves[0]  # [n, ND]
        max_day = days.max(axis=0)  # [ND]
        fresh = (days == max_day[None]).astype(leaves[1].dtype)
        return type(cms)(
            max_day,
            *[None if a is None
              else (a * fresh[..., None, None]).sum(axis=0)
              for a in leaves[1:]],
        )
    return type(cms)(*leaves)


def reshard_engine_state(kind: str, state, cfg, n_old: int, n_new: int):
    """Kind-dispatched re-layout, the one conversion every engine entry
    point uses: the window feature state through
    :func:`reshard_feature_state`; the sequence kind's history state over
    the mesh is A7d. Returns host arrays."""
    if kind == "sequence":
        raise ValueError(
            "re-sharding the sequence kind's history state (the sequence "
            "kind over the mesh) is not ported yet: ROADMAP A7d")
    return reshard_feature_state(state, cfg, n_old, n_new)
