"""Exact key directory: open-addressing uint32 key → slot table — port of
the JAX package's ``ops/keydir.py``.

The hot tier of ``key_mode="exact"`` holds ``slot_capacity`` window rows,
sized to the active working set, and this directory (``dir_capacity`` =
2 × slots, load factor ≤ 0.5) maps keys to them exactly: a key owns a
private slot or misses admission and is served from the sketch tier; two
keys never share a row.

The algorithm is the JAX package's, step for step, so the card, the CPU
and the JAX package grant the same slots and hold the same leaves:

- **probing** is double hashing over a power-of-two table
  (``h1 + j·(h2|1)``) with a fixed depth; a lookup scans all P positions,
  so vacated entries need no tombstones;
- **batched insert** resolves races in claim rounds: each round, rows
  whose key has no entry yet scatter-min their key into the positions
  that are still empty, re-read, and the losers probe on; a scatter-min
  of the row index then picks one owner per claimed entry, which pops the
  free-slot stack in row order (cumsum rank);
- **the free-slot stack** (``free``/``free_top``) bounds admission: when
  it runs dry the claim is rolled back and the row reports
  ``admitted=False``;
- **reclaim** pushes dead slots back on the stack and vacates their
  entries (the engine's recency compaction calls it).

Everything is fixed-shape and sync-free: no ``.item()``, no boolean-mask
indexing, no ``nonzero``, no indexing by a 0-d tensor (which reads it
back); ``free_top`` is a 0-d device tensor; the claim
rounds are a Python loop over ``n_probes``. Every function updates the
directory's tensors in place and returns the same ``KeyDirectory``.

Two translations from JAX:

- torch has no ``min`` on ``torch.uint32``, so the ``keys`` leaf (kept
  uint32, the JAX file's dtype) is handled through its int32 view. An
  int32 with its sign bit flipped orders as the uint32 does, so a claim
  round flips the touched entries, scatter-mins the flipped keys
  (``scatter_reduce_("amin")``) and flips them back.
- torch has no ``mode="drop"`` scatter. :func:`put_kept_` sends every
  dropped lane to the target of one kept lane with that lane's value (or
  rewrites the target's own value when no lane is kept), so a dropped
  write never lands anywhere, slot 0 included.

``EMPTY_KEY`` (0xFFFFFFFF) is reserved: a real key equal to it is
remapped to 0xFFFFFFFE, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.ops.hashing import hash_u32

EMPTY_KEY = 0xFFFFFFFF
_EMPTY_I32 = -1  # EMPTY_KEY's int32 bit pattern
_SIGN = -(1 << 31)  # int32 sign bit: x ^ _SIGN orders as the uint32 x


class KeyDirectory(NamedTuple):
    """The directory and its free-slot stack (all on the device).

    Invariant: an entry is vacant (``keys[e] == EMPTY_KEY`` and
    ``slots[e] == -1``) or owns exactly one live slot; every slot id is
    owned by one entry or sits on the stack (``free[:free_top]``)."""

    keys: torch.Tensor  # uint32 [dir_cap]; EMPTY_KEY = vacant
    slots: torch.Tensor  # int32 [dir_cap]; slot owned by the entry, -1 vacant
    free: torch.Tensor  # int32 [slot_cap]; free[:free_top] = free slot ids
    free_top: torch.Tensor  # int32 [] — live height of the free stack

    @property
    def dir_capacity(self) -> int:
        return int(self.keys.shape[0])

    @property
    def slot_capacity(self) -> int:
        return int(self.free.shape[0])


def init_keydir(dir_capacity: int, slot_capacity: int,
                device=None) -> KeyDirectory:
    if dir_capacity < 1 or dir_capacity & (dir_capacity - 1):
        raise ValueError(
            f"dir_capacity must be a power of 2, got {dir_capacity}")
    if slot_capacity > dir_capacity:
        raise ValueError(
            "more slots than directory entries can never all be reachable")
    return KeyDirectory(
        keys=torch.full((dir_capacity,), _EMPTY_I32, dtype=torch.int32,
                        device=device).view(torch.uint32),
        slots=torch.full((dir_capacity,), -1, dtype=torch.int32,
                         device=device),
        # low slot ids pop first (free[top-1] is the next grant)
        free=torch.arange(slot_capacity - 1, -1, -1, dtype=torch.int32,
                          device=device),
        free_top=torch.tensor(slot_capacity, dtype=torch.int32,
                              device=device),
    )


def _canon(key: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 bit-pattern) keys → their int32 bit patterns, with
    EMPTY_KEY remapped to 0xFFFFFFFE."""
    k = key.view(torch.int32) if key.dtype == torch.uint32 else key.int()
    return torch.where(k == _EMPTY_I32, torch.full_like(k, -2), k)


def _probe_positions(key: torch.Tensor, dir_cap: int,
                     n_probes: int) -> torch.Tensor:
    """[B] canonical keys → int64 [B, P] probe positions (double hashing,
    odd stride), the JAX package's positions."""
    h1 = hash_u32(key, seed=0)
    h2 = hash_u32(key, seed=1) | 1
    j = torch.arange(n_probes, dtype=torch.int64, device=key.device)
    return (h1[:, None] + j[None, :] * h2[:, None]) & (dir_cap - 1)


def put_kept_(dst: torch.Tensor, idx: torch.Tensor, keep: torch.Tensor,
              values: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] = values[i]`` for the lanes where ``keep``, IN PLACE:
    the JAX ``.at[where(keep, idx, n)].set(values, mode="drop")``.

    ``idx`` must be a valid row index in every lane and unique among the
    kept lanes. The dropped lanes write lane ``j``'s value to lane ``j``'s
    target, ``j`` the first kept lane, so every write to a row carries one
    value; with no lane kept they all rewrite ``dst[idx[0]]`` as it is."""
    # j stays a 1-element tensor: indexing with a 0-d tensor would read
    # it back to the host (a sync per call)
    j = torch.argmax(keep.to(torch.int32)).view(1)
    shape = (-1,) + (1,) * (values.dim() - 1)
    idx_j = idx[j]
    fill = torch.where(keep[j].view(shape), values[j], dst[idx_j])
    tgt = torch.where(keep, idx, idx_j)
    dst.index_put_((tgt,), torch.where(keep.view(shape), values, fill))
    return dst


def _flip_at_(kv: torch.Tensor, pos: torch.Tensor) -> None:
    """Flip the sign bit of ``kv[pos]`` (int32 view), reading every
    position before writing any: duplicate positions flip once."""
    kv.index_put_((pos,), kv[pos] ^ _SIGN)


def init_stacked_keydir(dir_capacity: int, slot_capacity: int,
                        n_shards: int, device=None) -> KeyDirectory:
    """``n_shards`` independent directories as one ``KeyDirectory`` with
    a leading shard axis on every leaf (``keys``/``slots`` [n, dir_cap],
    ``free`` [n, slot_cap], ``free_top`` [n]): the sharded engine's
    layout, one directory per shard over its local slot range."""
    kd = init_keydir(dir_capacity, slot_capacity, device)
    return KeyDirectory(
        keys=kd.keys.view(torch.int32).repeat(n_shards, 1)
        .view(torch.uint32),
        slots=kd.slots.repeat(n_shards, 1),
        free=kd.free.repeat(n_shards, 1),
        free_top=kd.free_top.repeat(n_shards),
    )


def _stacked(kd: KeyDirectory) -> KeyDirectory:
    """A one-directory ``KeyDirectory`` as a stack of one: views, so an
    in-place update of the stack updates ``kd``."""
    return KeyDirectory(kd.keys[None], kd.slots[None], kd.free[None],
                        kd.free_top.view(1))


def lookup_slots(
    kd: KeyDirectory,
    key: torch.Tensor,  # uint32 [B]
    valid: torch.Tensor,  # bool [B]
    n_probes: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only probe: (slot int64 [B], hit bool [B]). Missing and invalid
    rows return slot 0 with ``hit=False``: mask them before a scatter."""
    return lookup_slots_stacked(
        _stacked(kd), torch.zeros_like(valid, dtype=torch.int64), key,
        valid, n_probes)


def lookup_slots_stacked(
    kd: KeyDirectory,  # stacked: [n_shards, ...] leaves
    owner: torch.Tensor,  # int [B] — the shard that owns each row's key
    key: torch.Tensor,  # uint32 [B]
    valid: torch.Tensor,  # bool [B]
    n_probes: int = 8,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Read-only probe into a stacked directory: row i probes shard
    ``owner[i]``'s table. Returns (slot int64 [B], hit bool [B]); the slot
    is LOCAL to the owner shard (its table row is ``owner · slot_cap +
    slot``)."""
    key = _canon(key)
    dir_cap = int(kd.keys.shape[1])
    pos = (_probe_positions(key, dir_cap, n_probes)
           + owner.long()[:, None] * dir_cap)
    found = kd.keys.view(torch.int32).reshape(-1)[pos] == key[:, None]
    pidx = torch.argmax(found.to(torch.int32), dim=1)
    entry = torch.gather(pos, 1, pidx[:, None])[:, 0]
    slot = kd.slots.reshape(-1)[entry].long()
    hit = valid & found.any(dim=1) & (slot >= 0)
    return torch.where(hit, slot, torch.zeros_like(slot)), hit


def admit_slots(
    kd: KeyDirectory,
    key: torch.Tensor,  # uint32 [B]
    valid: torch.Tensor,  # bool [B]
    n_probes: int = 8,
) -> Tuple[KeyDirectory, torch.Tensor, torch.Tensor]:
    """Lookup-or-insert a batch of keys, IN PLACE: the hot path's
    admission op.

    Returns ``(kd, slot int64 [B], admitted bool [B])``. A row is admitted
    iff its key already owned a slot, or claimed an entry within
    ``n_probes`` probes while a free slot remained; batch duplicates of
    one key share one slot. Rows not admitted return slot 0 and must be
    masked out of the hot-tier scatters (the sketch tier serves them).
    One directory is a stack of one (:func:`admit_slots_stacked`).
    """
    _, slot, admitted = admit_slots_stacked(_stacked(kd), key[None],
                                            valid[None], n_probes)
    return kd, slot[0], admitted[0]


def admit_slots_stacked(
    kd: KeyDirectory,  # stacked: [n_shards, ...] leaves
    key: torch.Tensor,  # uint32 [n_shards, L] — row s goes to shard s
    valid: torch.Tensor,  # bool [n_shards, L]
    n_probes: int = 8,
) -> Tuple[KeyDirectory, torch.Tensor, torch.Tensor]:
    """:func:`admit_slots` of every shard in one pass, IN PLACE: row s of
    ``key`` is admitted into shard s's directory, with the results of N
    separate calls (``slot`` is local to the shard). Every probe position
    is offset by ``s · dir_cap`` into the flattened tables, so a claim
    round's scatter-min never crosses shards; a claimed entry's owner is
    its lowest row; the grant rank is a cumsum along each shard's row, so
    shard s pops ``free[s, free_top[s] - 1 - rank]``."""
    n, dir_cap = (int(d) for d in kd.keys.shape)
    slot_cap = int(kd.free.shape[1])
    width = int(key.shape[1])
    key = _canon(key.reshape(-1))
    valid = valid.reshape(-1)
    b = int(key.shape[0])
    dev = key.device
    shard = torch.arange(n, dtype=torch.int64, device=dev)
    pos = (_probe_positions(key, dir_cap, n_probes)
           + shard.repeat_interleave(width)[:, None] * dir_cap)
    kv = kd.keys.view(torch.int32).view(-1)
    slots = kd.slots.view(-1)
    # The full-depth lookup comes FIRST and only keys with no entry claim:
    # a reclaim can vacate a position on a live key's probe prefix, and a
    # claim-as-you-probe insert would take that vacancy before reaching
    # the key's real entry (a duplicate key and a leaked slot).
    found = kv[pos] == key[:, None]  # [B, P]
    pidx = torch.argmax(found.to(torch.int32), dim=1)
    hit0 = found.any(dim=1) & valid
    entry = torch.where(hit0, torch.gather(pos, 1, pidx[:, None])[:, 0],
                        torch.zeros_like(pidx))
    placed = ~valid | hit0
    claimed = torch.zeros(b, dtype=torch.bool, device=dev)
    empty_flipped = torch.full_like(key, _EMPTY_I32 ^ _SIGN)
    for j in range(n_probes):
        p = pos[:, j]
        cur = kv[p]
        # batch duplicates of a key claimed in an earlier round match here
        hit = ~placed & (cur == key)
        entry = torch.where(hit, p, entry)
        placed = placed | hit
        # Claim: scatter-min the key into still-empty positions (in the
        # uint32 order, through the sign flip); the smallest key wins.
        want = ~placed & (cur == _EMPTY_I32)
        cand = torch.where(want, key ^ _SIGN, empty_flipped)
        _flip_at_(kv, p)
        kv.scatter_reduce_(0, p, cand, "amin", include_self=True)
        _flip_at_(kv, p)
        won = want & (kv[p] == key)
        entry = torch.where(won, p, entry)
        claimed = claimed | won
        placed = placed | won
    # One owner per newly claimed entry: the lowest row among the batch
    # duplicates of its key pops the slot.
    rows = torch.arange(b, dtype=torch.int32, device=dev)
    owner = torch.full((n * dir_cap + 1,), b, dtype=torch.int32, device=dev)
    owner.scatter_reduce_(
        0, torch.where(claimed, entry, torch.full_like(entry, n * dir_cap)),
        rows, "amin", include_self=True)
    new = (claimed & (owner[entry] == rows)).view(n, width)
    # Grant free slots to owners in row order, per shard; owners past the
    # stack height roll their claim back (their duplicates then miss too).
    rank = torch.cumsum(new.to(torch.int32), 1) - 1
    avail = kd.free_top[:, None]
    has = new & (rank < avail)
    slot_new = torch.gather(
        kd.free, 1, torch.clamp(avail - 1 - rank, 0, slot_cap - 1).long())
    put_kept_(slots, entry, has.view(-1), slot_new.view(-1))
    revert = new & ~(rank < avail)
    put_kept_(kv, entry, revert.view(-1), torch.full_like(key, _EMPTY_I32))
    kd.free_top.sub_(has.sum(dim=1).to(torch.int32))
    # Final resolution covers hits, grants, duplicates of grants, rolled
    # back claims and rows that never placed (probe overflow).
    slot = slots[entry].long()
    admitted = placed & valid & (kv[entry] == key) & (slot >= 0)
    slot = torch.where(admitted, slot, torch.zeros_like(slot))
    return kd, slot.view(n, width), admitted.view(n, width)


def reclaim_entries(
    kd: KeyDirectory,
    dead_entry: torch.Tensor,  # bool [dir_cap] — entries to vacate
) -> Tuple[KeyDirectory, torch.Tensor, torch.Tensor]:
    """Vacate the ``dead_entry`` positions and push their slots back on
    the free stack, IN PLACE. Returns ``(kd, dead bool [dir_cap],
    n_reclaimed int32 [])``: ``dead`` is the mask restricted to live
    entries (the caller resets those slots' window rows)."""
    slot_cap = kd.slot_capacity
    dead = dead_entry & (kd.slots >= 0)
    rank = torch.cumsum(dead.to(torch.int32), 0) - 1
    push = torch.clamp(kd.free_top + rank, 0, slot_cap - 1).long()
    put_kept_(kd.free, push, dead, kd.slots)
    n = dead.sum().to(torch.int32)
    kd.keys.view(torch.int32).masked_fill_(dead, _EMPTY_I32)
    kd.slots.masked_fill_(dead, -1)
    kd.free_top.add_(n)
    return kd, dead, n


def occupied_slots(kd: KeyDirectory) -> torch.Tensor:
    """Live slot count (int32 0-d tensor): slots granted, not reclaimed."""
    return kd.slot_capacity - kd.free_top
