"""Integer hashing of uint32 keys — port of the JAX package's
``ops/hashing.py``.

Used for key→slot placement under ``key_mode="hash"`` and for the
count-min sketch's column hashes. The mixer is the JAX package's 32-bit
finalizer; here it runs in int64 arithmetic masked to 32 bits, because
torch has no ``>>``, ``%`` or ``*`` on ``torch.uint32`` tensors.

Every product stays below 2^63, so no int64 multiply wraps: a 32-bit
product ``h * m mod 2^32`` is taken as ``((h * m_hi) mod 2^16) << 16`` plus
``h * m_lo`` (``m = m_hi·2^16 + m_lo``), each partial product below 2^48.
"""

from __future__ import annotations

import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_MASK32 = 0xFFFFFFFF


def widen_u32(key: torch.Tensor) -> torch.Tensor:
    """uint32 (or int32 bit-pattern) keys → int64 in [0, 2^32): keys at
    and above 2^31 keep their unsigned value."""
    if key.dtype == torch.uint32:
        key = key.view(torch.int32)
    return key.long() & _MASK32


def _mul32(h: torch.Tensor, m: int) -> torch.Tensor:
    """``h * m mod 2^32`` for int64 ``h`` in [0, 2^32) without overflow."""
    hi = (h * (m >> 16)) & 0xFFFF
    return ((hi << 16) + h * (m & 0xFFFF)) & _MASK32


def hash_u32(key: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Mix uint32 keys; returns int64 in [0, 2^32). Distinct seeds give
    independent hashes. Bit for bit the JAX package's ``hash_u32``."""
    h = widen_u32(key) ^ ((0x9E3779B9 * (seed + 1)) & _MASK32)
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 15)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def slot_of(key: torch.Tensor, capacity: int, seed: int = 0) -> torch.Tensor:
    """Key → int64 table slot in [0, capacity); capacity is a power of
    two."""
    if capacity < 1 or capacity & (capacity - 1):
        raise ValueError(f"capacity must be a power of 2, got {capacity}")
    return hash_u32(key, seed) & (capacity - 1)


def multi_hash(key: torch.Tensor, depth: int, width: int) -> torch.Tensor:
    """[B] keys → int64 [depth, B] independent column indices in
    [0, width); width is a power of two."""
    if width < 1 or width & (width - 1):
        raise ValueError(f"width must be a power of 2, got {width}")
    wide = widen_u32(key)
    return torch.stack([hash_u32(wide, seed=d) & (width - 1)
                        for d in range(depth)])
