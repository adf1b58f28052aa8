"""The shard mesh and the feature state's sharded layout — port of the
one-process part of the JAX package's ``parallel/mesh.py``.

The JAX package serves one stream over a ``jax.sharding.Mesh`` of N
devices. Here a mesh is an ordered tuple of ``torch.device``s, one per
shard, and in this port every shard of a mesh lives on ONE device: the
sharded engine (``runtime/sharded_engine.py``) runs its N shards in one
process, as the JAX tests run theirs on 8 virtual CPU devices. Several
GPUs are served by the fleet: one process per GPU, each owning a residue
block (``runtime/distributed.py``); a mesh over distinct devices in one
process raises here.

The layout is the JAX package's, so a checkpoint's leaves are the same
arrays in both packages:

- window tables stay GLOBAL ``[cap, NB]`` arrays, owner-major: shard
  ``k % n`` owns rows ``[owner·cap/n, (owner+1)·cap/n)`` and places key k
  at local slot ``(k // n) & (cap/n - 1)`` (:func:`_layout_perm`);
- the sketches get a leading shard axis ``[n, ND, depth, width]`` (each
  shard sketches its own keys);
- under ``key_mode="exact"`` each shard has its own key directory over
  its local slot range, stacked ``[n, ...]`` (slot ``l`` of shard ``o`` is
  global row ``o·cap/n + l``).

:func:`reshard_feature_state` converts a state between widths (exact for
direct keys; the tiered store re-homes every directory entry by ``key %
n_new``, :func:`_reshard_exact`; the sketch merges under the newest-day
rule, :func:`_merge_sketch`) and returns host arrays;
:func:`shard_feature_state` places them (into an engine's own tensors
when ``out`` is given). The fleet's legs: :func:`adopt_process_slice`
(a single-process global state → one process's residue block, 1→P) and
:func:`merge_process_states` (P processes' states → one global state,
P→1); :func:`make_process_mesh` and
:func:`cross_process_collectives_supported` describe and probe the process
group.
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
            "is served by the fleet: one process per GPU "
            "(score --num-processes P --process-id p, or "
            "real_time_fraud_detection_system_tpu_torch.tools."
            "multihost_launcher), each owning a residue block; in one "
            "process co-locate the shards with devices=[device] * n")
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
    """The process-local serving mesh: :func:`make_mesh`. A fleet process
    serves its own mesh whatever the process group spans (no collective
    crosses processes on the serving path)."""
    return make_mesh(n_devices, devices)


def make_process_mesh(local_devices: int = 1, device=None) -> tuple:
    """The process-spanning shard order: ``(process, device)`` pairs,
    process p's ``local_devices`` shards at ``[p·L, (p+1)·L)``, the block
    its residue ownership (``runtime/distributed.py::ProcessTopology``)
    assigns it. The devices are each process's own (gathered over the
    process group); the port computes nothing over this order, it names
    which process serves which global shard."""
    import torch.distributed as dist

    mine = [str(resolve_device(device))] * local_devices
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
    else:
        every = [mine]
    return tuple((p, d) for p, devs in enumerate(every) for d in devs)


def cross_process_collectives_supported(mesh=None) -> Optional[str]:
    """None when the process group can run a collective (or there is one
    process); otherwise the backend's error text. Every process calls it
    together: it runs one gloo ``all_reduce`` of a host tensor, the
    cheapest exercise of the group's transport."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return None
    t = torch.ones(1)
    try:
        dist.all_reduce(t)
    except (RuntimeError, ValueError) as e:
        return str(e).splitlines()[-1] if str(e) else type(e).__name__
    if int(t.item()) != dist.get_world_size():
        return f"all_reduce summed {t.item()} over " \
               f"{dist.get_world_size()} processes"
    return None


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
    mesh's width as it is, and the tiered store's stacked directories,
    which must be of the mesh's width (a one-shard mesh adopts a single
    directory as its stack of one). ``out`` (an engine's state) receives
    the values in place, in its own layout — a single-device engine's
    sketch and directories stay single — so its tensors keep their
    addresses."""
    n = len(mesh)
    dev = mesh[0]
    placed = tree.map(lambda a: torch.as_tensor(_np(a)).to(dev), state)

    def place_sketch(cms, want):
        if cms is None:
            return None
        stacked = cms.slice_day.dim() == 2
        if stacked and cms.slice_day.shape[0] != n:
            raise ValueError(
                f"cms is laid out for {cms.slice_day.shape[0]} shard(s), "
                f"mesh has {n} — convert it with reshard_feature_state")
        if want and not stacked:
            return tree.map(lambda t: t[None].expand(
                (n,) + tuple(t.shape)).contiguous(), cms)
        return cms

    def place_dir(kd, name: str, want):
        if kd is None:
            return None
        if kd.keys.dim() == 1 and n == 1:
            # a one-shard mesh: the single directory is its one shard's
            kd = tree.map(lambda t: t.reshape((1,) + tuple(t.shape)), kd)
        lead = int(kd.keys.shape[0]) if kd.keys.dim() == 2 else 1
        if kd.keys.dim() != 2 or lead != n:
            raise ValueError(
                f"{name} is laid out for {lead} shard(s), mesh has {n} — "
                "build the state with init_feature_state(n_shards=mesh "
                "width) or convert it with reshard_feature_state (pass "
                "feature_state_n_old to the engine)")
        if not want:
            return tree.map(lambda t: t[0], kd)
        return kd

    def stacked(name: str, leaf: str) -> bool:
        """Whether the target holds ``name`` with a leading shard axis
        (without ``out``, always)."""
        t = getattr(out, name) if out is not None else None
        return out is None or (t is not None
                               and getattr(t, leaf).dim() == 2)

    placed = placed._replace(
        cms=place_sketch(placed.cms, stacked("cms", "slice_day")),
        terminal_cms=place_sketch(placed.terminal_cms,
                                  stacked("terminal_cms", "slice_day")),
        customer_dir=place_dir(placed.customer_dir, "customer_dir",
                               stacked("customer_dir", "keys")),
        terminal_dir=place_dir(placed.terminal_dir, "terminal_dir",
                               stacked("terminal_dir", "keys")))
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
    from the config's capacity. ``key_mode="exact"`` delegates to
    :func:`_reshard_exact` (directory entries re-homed by ``key %
    n_new``, bit-exact for every admitted key)."""
    fcfg = cfg.features
    if fcfg.key_mode == "exact":
        return _reshard_exact(state, fcfg, n_old, n_new)
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


def _rebuild_exact_table(name: str, ctx: str, keys: np.ndarray,
                         vals: dict, cap: int, n_new: int, n_probes: int):
    """One (window table, key directory) pair rebuilt in the
    ``n_new``-shard layout from its live entries: ``keys`` [K] uint32
    (unique: a key lives in one shard) and ``vals`` (window leaf name →
    its [K, NB] rows). The owner is ``key % n_new``; slots within a shard
    are granted in sorted-key order (two rebuilds of the same entries are
    byte-identical); each directory is rebuilt with the probe sequence
    ``admit_slots`` uses at serve time. Raises, naming ``ctx`` and the
    fix, for a duplicate key, an overloaded new shard and a key that
    cannot place within ``n_probes``. Returns host arrays (the single
    layout at ``n_new == 1``)."""
    from real_time_fraud_detection_system_tpu_torch.ops.keydir import (
        EMPTY_KEY,
        KeyDirectory,
        _probe_positions,
    )
    from real_time_fraud_detection_system_tpu_torch.ops.windows import (
        WindowState,
    )

    cap_local_new = cap // n_new
    owner = (keys % np.uint32(n_new)).astype(np.int64)
    order = np.lexsort((keys, owner))
    owner_s, keys_s = owner[order], keys[order]
    if len(keys_s) > 1 and (keys_s[:-1] == keys_s[1:]).any():
        dup = keys_s[:-1][keys_s[:-1] == keys_s[1:]][:4]
        raise ValueError(
            f"{ctx}: duplicate {name} key(s) {dup.tolist()} across "
            "source shards — the ownership contract places each key in "
            "exactly one shard/process, so a duplicate means two "
            "engines served the same key (partition-affinity breach); "
            "merging would corrupt its window history")
    counts = np.bincount(owner_s, minlength=n_new)
    if counts.max(initial=0) > cap_local_new:
        worst = int(np.argmax(counts))
        raise ValueError(
            f"{ctx}: new shard {worst} would own {int(counts[worst])} "
            f"live {name} keys but holds only {cap_local_new} slots — run "
            "compaction before shrinking the mesh, or keep more shards")
    rank = (np.arange(len(owner_s))
            - np.concatenate(([0], np.cumsum(counts)))[owner_s])
    new_rows = owner_s * cap_local_new + rank
    # the window rows move as bit-exact copies
    fills = {"bucket_day": -1, "count": 0.0, "amount": 0.0, "fraud": 0.0}

    def rehome(leaf):
        src = np.asarray(vals[leaf])[order]
        fresh = np.full((cap,) + src.shape[1:], fills[leaf],
                        dtype=src.dtype)
        fresh[new_rows] = src
        return fresh

    ws_new = WindowState(**{k: rehome(k) for k in fills})
    # the directories: the claim rounds of admit_slots, in numpy (the
    # keys are unique per shard, so every key wins one round)
    dir_cap_new = 2 * cap_local_new
    nkeys = np.full((n_new, dir_cap_new), EMPTY_KEY, np.uint32)
    nslots = np.full((n_new, dir_cap_new), -1, np.int32)
    pos = _probe_positions(torch.from_numpy(keys_s.view(np.int32)),
                           dir_cap_new, n_probes).numpy()  # [K, P]
    flat_keys = nkeys.reshape(-1)
    flat_slots = nslots.reshape(-1)
    placed = np.zeros(len(keys_s), dtype=bool)
    for j in range(n_probes):
        active = ~placed
        if not active.any():
            break
        gpos = owner_s * dir_cap_new + pos[:, j]
        want = active & (flat_keys[gpos] == EMPTY_KEY)
        # among racers for one position the smallest key wins
        np.minimum.at(flat_keys, gpos[want], keys_s[want])
        won = want & (flat_keys[gpos] == keys_s)
        flat_slots[gpos[won]] = rank[won].astype(np.int32)
        placed |= won
    if not placed.all():
        raise ValueError(
            f"{ctx}: {int((~placed).sum())} {name} key(s) could not place "
            f"within {n_probes} probes of the rebuilt directory — raise "
            "keydir_probes or grow the hot tier (admitted-key state must "
            "survive a rebuild bit-exactly, so dropping them is not an "
            "option)")
    free = np.broadcast_to(
        np.arange(cap_local_new - 1, -1, -1, dtype=np.int32),
        (n_new, cap_local_new)).copy()
    leaves = dict(keys=nkeys, slots=nslots, free=free,
                  free_top=(cap_local_new - counts).astype(np.int32))
    if n_new == 1:
        leaves = {k: v[0] for k, v in leaves.items()}
    return ws_new, KeyDirectory(**leaves)


def _extract_exact_table(name: str, ws, kd, n_old: int, cap: int):
    """The live (key, window row) pairs of one exact-mode table: keys
    [K] uint32 and ``vals`` (window leaf name → its [K, NB] rows)."""
    keys, slots = _np(kd.keys), _np(kd.slots)
    if keys.ndim == 1:
        keys, slots = keys[None], slots[None]
    if keys.shape[0] != n_old:
        raise ValueError(
            f"{name}_dir is laid out for {keys.shape[0]} shard(s), "
            f"caller says n_old={n_old}")
    bd = _np(ws.bucket_day)
    if bd.shape[0] != cap:
        raise ValueError(
            f"state table has {bd.shape[0]} rows, config says {cap} — "
            "re-sharding a checkpoint taken under a different capacity "
            "would merge or drop keys")
    shard_idx, entry_idx = np.nonzero(slots >= 0)
    old_rows = (shard_idx * (cap // n_old)
                + slots[shard_idx, entry_idx].astype(np.int64))
    vals = {k: _np(getattr(ws, k))[old_rows]
            for k in ("bucket_day", "count", "amount", "fraud")}
    return keys[shard_idx, entry_idx], vals


def _reshard_exact(state: FeatureState, fcfg, n_old: int, n_new: int,
                   owner_filter=None) -> FeatureState:
    """N→M re-home of the tiered store (directories, window tables,
    sketches), bit-exact for every admitted key, as the JAX function: each
    live entry is extracted, its new owner is ``key % n_new`` (the modulo
    the exchange routes by), its row moves to the owner's block and each
    new directory is rebuilt (:func:`_rebuild_exact_table`). The sketches
    merge under the newest-day rule and are expanded again at placement.
    An overloaded new shard or a key that cannot place raises, naming the
    fix. ``owner_filter`` (keys → bool mask) keeps only those keys' state
    (the fleet's adoption of a global checkpoint). Returns host arrays."""
    ctx = f"elastic reshard {n_old}→{n_new}"
    out = {}
    for name, cap, present in (
            ("customer", fcfg.customer_capacity,
             fcfg.customer_source != "cms"),
            ("terminal", fcfg.terminal_capacity, True)):
        ws = getattr(state, name)
        kd = getattr(state, f"{name}_dir")
        if not present:
            if kd is not None:
                raise ValueError(
                    f"{name}_dir present but customer_source="
                    f"{fcfg.customer_source!r} builds none — the state "
                    "does not match this config")
            out[name] = tree.map(_np, ws)
            out[f"{name}_dir"] = None
            continue
        if kd is None:
            raise ValueError(
                f"key_mode='exact' reshard needs the {name} key directory; "
                "this state carries none (was it built under a different "
                "key_mode?)")
        for n, who in ((n_old, "n_old"), (n_new, "n_new")):
            if n < 1 or cap % n or ((cap // n) & (cap // n - 1)):
                raise ValueError(
                    f"{name}_capacity {cap} / {who}={n} must be a power of "
                    "two")
        keys, vals = _extract_exact_table(name, ws, kd, n_old, cap)
        if owner_filter is not None:
            keep = np.asarray(owner_filter(keys), dtype=bool)
            keys = keys[keep]
            vals = {k: v[keep] for k, v in vals.items()}
        out[name], out[f"{name}_dir"] = _rebuild_exact_table(
            name, ctx, keys, vals, cap, n_new, fcfg.keydir_probes)
    return state._replace(
        customer=out["customer"], terminal=out["terminal"],
        cms=_merge_sketch(state.cms, n_old),
        customer_dir=out["customer_dir"],
        terminal_dir=out["terminal_dir"],
        terminal_cms=_merge_sketch(state.terminal_cms, n_old),
    )


def adopt_process_slice(state: FeatureState, cfg, n_old: int, topology
                        ) -> FeatureState:
    """A single-process GLOBAL feature state (a checkpoint written by a
    one-process deployment at ``n_old`` shards) → this process's layout:
    the 1→P leg of a fleet resize, through the same re-home as every
    reshard. Exact keys keep only the keys this process owns
    (``topology.owns``; the others are adopted by their own processes
    from the same checkpoint). Direct keys keep the whole tables: the
    rows of keys owned elsewhere are inert (those keys never arrive
    here). The sketches merge to the single layout and stay whole (an
    upper bound for every key). Returns host arrays."""
    fcfg = cfg.features
    if fcfg.key_mode == "exact":
        return _reshard_exact(state, fcfg, n_old, topology.local_devices,
                              owner_filter=topology.owns)
    return reshard_feature_state(state, cfg, n_old, topology.local_devices)


def merge_process_states(states, cfg, n_locals) -> FeatureState:
    """Merge a P-process fleet's feature states into ONE single-layout
    global state: the P→1 leg of a fleet resize (the merged state is
    saved by one process, and a new fleet re-slices it with
    :func:`adopt_process_slice`).

    ``n_locals[i]``: process i's shard count. Exact keys: every process's
    live (key, window row) entries, disjoint by ownership (a duplicate
    raises), rebuild the global directory (:func:`_rebuild_exact_table`).
    Direct keys: rows combine by residue ownership (row r holds key r, so
    its owner's copy is the one), which needs one width across the fleet
    and capacities divisible by P·L. Hash keys refuse (colliding keys
    cannot be attributed). The sketches merge per process, then across
    processes, under the newest-day rule: same-day slices SUM, exact when
    each process's sketch holds only its own traffic (checkpoints hold
    the locals-only partial, ``runtime/cms_exchange.py``). Returns host
    arrays."""
    fcfg = cfg.features
    if not states or len(states) != len(n_locals):
        raise ValueError(
            f"merge_process_states: {len(states)} state(s) vs "
            f"{len(n_locals)} n_locals")
    n_proc = len(states)
    if n_proc == 1:
        return reshard_feature_state(states[0], cfg, n_locals[0], 1)
    if fcfg.key_mode == "hash":
        raise ValueError(
            "process merge requires key_mode='direct' or 'exact' (hash "
            "mode merges colliding keys — rows cannot be attributed to "
            "their owner process)")

    def merge_cms(getter):
        per = []
        for st, n_loc in zip(states, n_locals):
            m = _merge_sketch(getter(st), n_loc)
            if m is None:
                return None
            per.append(m)
        stacked = type(per[0])(*[
            None if any(le is None for le in leaves)
            else np.stack([np.asarray(le) for le in leaves])
            for leaves in zip(*per)])
        return _merge_sketch(stacked, n_proc)

    if fcfg.key_mode == "exact":
        out = {}
        for name, cap, present in (
                ("customer", fcfg.customer_capacity,
                 fcfg.customer_source != "cms"),
                ("terminal", fcfg.terminal_capacity, True)):
            if not present:
                # customer_source="cms": the table is dead weight
                out[name] = tree.map(_np, getattr(states[0], name))
                out[f"{name}_dir"] = None
                continue
            keys_all, vals_all = [], []
            for pid, (st, n_loc) in enumerate(zip(states, n_locals)):
                ws, kd = getattr(st, name), getattr(st, f"{name}_dir")
                if kd is None:
                    raise ValueError(
                        f"process {pid}'s state carries no {name} key "
                        "directory (was it built under a different "
                        "key_mode?)")
                k, v = _extract_exact_table(name, ws, kd, n_loc, cap)
                keys_all.append(k)
                vals_all.append(v)
            keys = np.concatenate(keys_all)
            vals = {k: np.concatenate([v[k] for v in vals_all])
                    for k in vals_all[0]}
            out[name], out[f"{name}_dir"] = _rebuild_exact_table(
                name, f"process merge {n_proc}→1", keys, vals, cap, 1,
                fcfg.keydir_probes)
        return states[0]._replace(
            customer=out["customer"], terminal=out["terminal"],
            cms=merge_cms(lambda s: s.cms),
            customer_dir=out["customer_dir"],
            terminal_dir=out["terminal_dir"],
            terminal_cms=merge_cms(lambda s: s.terminal_cms))

    # direct keys: fixed permutations; rows combine by residue ownership
    if len(set(int(n) for n in n_locals)) != 1:
        raise ValueError(
            "direct-mode process merge needs a homogeneous fleet (every "
            f"process the same local width), got n_locals={list(n_locals)}"
            " — exact mode re-homes by stored key and has no such limit")
    n_local = int(n_locals[0])
    n_total = n_proc * n_local
    singles = [reshard_feature_state(st, cfg, n_local, 1) for st in states]

    def combine(name, cap):
        if cap % n_total:
            raise ValueError(
                f"direct-mode process merge needs {name}_capacity {cap} "
                f"divisible by n_processes×local_devices = {n_total} "
                "(row residue = key residue is what attributes each row "
                "to its owner)")
        owner = (np.arange(cap) % n_total) // n_local
        ws0 = getattr(singles[0], name)

        def one(leaf_name):
            leaves = [_np(getattr(getattr(s, name), leaf_name))
                      for s in singles]
            merged = np.empty_like(leaves[0])
            for p in range(n_proc):
                m = owner == p
                merged[m] = leaves[p][m]
            return merged

        return type(ws0)(**{k: one(k) for k in
                            ("bucket_day", "count", "amount", "fraud")})

    return states[0]._replace(
        customer=combine("customer", fcfg.customer_capacity),
        terminal=combine("terminal", fcfg.terminal_capacity),
        cms=merge_cms(lambda s: s.cms),
    )


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
