"""The key hashes the tiered store's semantics are defined by, written
out from their definition (a 32-bit finalizer per seed), in int64
arithmetic masked to 32 bits.

- ``hash_u32(key, seed)``: ``h = key ^ (0x9E3779B9 · (seed + 1))``, then
  ``h ^= h >> 16; h *= 0x7FEB352D; h ^= h >> 15; h *= 0x846CA68B;
  h ^= h >> 16``, every product mod 2^32.
- The key directory probes ``(h0 + j · (h1 | 1)) mod dir_capacity`` for
  ``j < n_probes`` (double hashing, ``h0``/``h1`` the hashes of seeds 0
  and 1).
- The count-min sketch's row ``d`` column is ``hash_u32(key, d) mod
  width``.
- An id folds to its uint32 key by xor of its two 32-bit words.
"""

from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF


def fold_key(ids: torch.Tensor) -> torch.Tensor:
    """int64 ids (≥ 0) → int64 keys in [0, 2^32)."""
    return (ids ^ (ids >> 32)) & MASK32


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    # h · m mod 2^32 without leaving int64: split m into 16-bit halves
    hi = (h * (m >> 16)) & 0xFFFF
    return ((hi << 16) + h * (m & 0xFFFF)) & MASK32


def hash_u32(key: torch.Tensor, seed: int) -> torch.Tensor:
    h = (key & MASK32) ^ ((0x9E3779B9 * (seed + 1)) & MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    return h ^ (h >> 16)


def probe_positions(key: torch.Tensor, dir_cap: int,
                    n_probes: int) -> torch.Tensor:
    """int64 [n, n_probes] directory positions of each key, in order."""
    h0 = hash_u32(key, 0)
    h1 = hash_u32(key, 1) | 1
    j = torch.arange(n_probes, dtype=torch.int64, device=key.device)
    return (h0[:, None] + j[None, :] * h1[:, None]) & (dir_cap - 1)
