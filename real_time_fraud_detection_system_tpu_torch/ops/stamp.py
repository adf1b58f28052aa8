"""Device timestamps that travel with a step's outputs:
``csrc/stamp.cu`` writes the card's ``%globaltimer`` (ns) into one slot
of an int64 buffer on the current stream.

A span inside a captured CUDA graph cannot be timed by events the graph
records: the next replay records over them, and at pipeline depth 2 it is
launched before the host reads them. A buffer the step allocates and
returns is cloned out of the graph with the step's other outputs, so each
replay's stamps are read with its own results. :func:`clock_anchor` puts
the stamps on the host's ``perf_counter`` clock.

The CPU has no such clock: :func:`stamp` refuses CPU tensors, and the
callers take stamps only on the card.
"""

from __future__ import annotations

import ctypes
import functools
import time
from typing import Tuple

import torch

from real_time_fraud_detection_system_tpu_torch.ops.cuda_lib import (
    CSRC,
    count_launch,
    load_library,
)

SOURCE = CSRC / "stamp.cu"


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    lib.stamp_launch.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_void_p]
    lib.stamp_launch.restype = ctypes.c_int
    return lib


def stamp(buf: torch.Tensor, i: int) -> None:
    """Write the card's clock (ns) into ``buf[i]`` (int64, contiguous, on
    the card) once the work enqueued before this call on the current
    stream has run. No synchronisation; ``stamp.launches`` counts the
    launches (``.captured`` those recorded into a graph)."""
    if buf.device.type != "cuda" or buf.dtype != torch.int64 \
            or not buf.is_contiguous():
        raise ValueError(f"stamp: expected a contiguous int64 buffer on "
                         f"the card, got {buf.dtype} on {buf.device}")
    if not 0 <= i < buf.numel():
        raise ValueError(f"stamp: slot {i} outside [0, {buf.numel()})")
    err = _library().stamp_launch(
        buf.data_ptr(), i, torch.cuda.current_stream(buf.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"stamp kernel launch failed: CUDA error {err}")
    count_launch(stamp)


stamp.launches = 0
stamp.captured = 0


def clock_anchor(device) -> Tuple[int, float]:
    """``(card ns, perf_counter seconds)`` of one moment: a stamp
    launched onto an idle stream, which the card writes a few µs after
    the launch call; of eight tries, the one whose call took the least,
    at the middle of its two readings."""
    dev = torch.device(device)
    buf = torch.zeros(8, dtype=torch.int64, device=dev)
    best = []
    for i in range(8):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        stamp(buf, i)
        t1 = time.perf_counter()
        best.append((t1 - t0, (t0 + t1) / 2, i))
    torch.cuda.synchronize(dev)
    _, t, i = min(best)
    return int(buf[i].item()), t
