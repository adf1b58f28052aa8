"""Profiler integration — port of the JAX package's ``utils/tracing.py``:

    with profile_to("trace_dir"):
        engine.run(...)

captures a ``torch.profiler`` trace of the run (the host's ops and, on
the card, the device's kernels and copies) and writes it into the
directory as Chrome-trace JSON. The program's own spans
(``utils/trace.py``) annotate that timeline while it records.

The JAX module's ``enable_compilation_cache`` has no counterpart: it turns
on XLA's persistent compilation cache, and the port's serving step is
eager PyTorch or a CUDA graph captured in the process, with nothing
compiled ahead to cache (the kernels' nvcc builds are cached by source
digest in ``ops/cuda_lib.py``).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional


@contextlib.contextmanager
def profile_to(log_dir: Optional[str]) -> Iterator[None]:
    """Profile the block with ``torch.profiler`` (CPU, and CUDA when the
    process sees a card) and write ``<log_dir>/trace-<pid>-<ms>.json``;
    a no-op when ``log_dir`` is empty or None."""
    if not log_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace-{os.getpid()}-{int(time.time() * 1e3)}.json"))
