"""Build and bind the port's CUDA kernels.

Each kernel is a ``.cu`` file under ``csrc/`` with a plain C interface.
:func:`build_library` compiles it with ``nvcc`` for sm_90a into a shared
library under ``_build/`` at first use (once per content of the source,
the shared headers and the flags); the kernel's module loads it with
``ctypes`` (:func:`load_library`). Nothing here runs when a module is
imported: the CPU has no ``nvcc``, and the tests import every module.

A kernel that does not build or load raises ``RuntimeError``, never
``OSError``: the recovery supervisor (``runtime/faults.py``) restarts on
an ``OSError`` as on a transient fault, and a missing toolkit, an
unwritable build directory or a library that will not load is none.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# No --use_fast_math: -prec-div=true and -ftz=false stay at their
# defaults, and --fmad=false keeps every product out of an FMA, so the
# kernels compute what their plain versions compute, bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA "
                           "toolkit that builds the kernels under csrc/")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _digest(source: Path) -> str:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library(source: Path) -> Tuple[Path, str]:
    """Compile ``source`` into ``_build/lib<stem>-<digest>.so`` unless it
    is there already; return (path, the compiler's report: registers,
    shared memory and spills, or "" when the library was already built).
    Raises ``RuntimeError`` with the compiler's output when nvcc fails,
    and with the system's error when nvcc or the build directory cannot
    be reached."""
    try:
        out = BUILD_DIR / f"lib{source.stem}-{_digest(source)}.so"
        if out.exists():
            return out, ""
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
                capture_output=True, text=True, check=False)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source.name} "
                                   f"({proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    except OSError as e:
        raise RuntimeError(f"cannot build {source.name}: {e}") from e
    return out, proc.stdout + proc.stderr


def load_library(source: Path) -> ctypes.CDLL:
    """Build ``source`` (:func:`build_library`) and load the library;
    ``RuntimeError`` when it will not load."""
    path = build_library(source)[0]
    try:
        return ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path.name}: {e}") from e


def check_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple, device: torch.device) -> None:
    """Raise ``ValueError`` unless ``t`` is a contiguous ``dtype`` tensor
    of ``shape`` on ``device``: what a kernel takes through a raw
    pointer."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != shape \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {shape} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
            f"{'' if t.is_contiguous() else ' (not contiguous)'}")


def count_launch(wrapper) -> None:
    """Count one launch of ``wrapper``'s kernel: ``wrapper.launches``
    when the launch runs now; ``wrapper.captured`` when the current stream
    is capturing a CUDA graph, which records the launch and runs it only
    at each replay (the engine counts its graphs' replays,
    ``runtime/engine.py::_StepGraph``)."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1
