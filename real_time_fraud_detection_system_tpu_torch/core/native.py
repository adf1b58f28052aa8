"""ctypes loader for the repository's C++ host units — the port's own copy
of the JAX package's ``core/native.py``.

Two units under ``native/`` serve the host side of the serving loop:

- ``native/hostprep.cc``: ``latest_wins_keep`` (latest-wins dedup by
  tx_id, one O(n) hash pass) and ``pack_rows`` (the fused ``make_batch`` +
  ``pack_batch`` into the ``[7, pad]`` int32 layout);
- ``native/envelope.cc``: ``decode_envelopes``, a field scanner for
  Debezium transaction envelopes.

Each is compiled with ``g++ -O3 -shared -fPIC`` at first use into the
port's ``_build/`` directory (never into ``native/``), under a name keyed
on the source's hash: it compiles to a temporary file and renames it into
place, so processes that build at once never load a half-written library.
Where ``g++`` is missing or fails, :func:`hostprep_available` and
:func:`native_available` are False and the callers take their NumPy and
Python routes, which have the same semantics (the tests hold the two
routes bit for bit against each other).

Validity contract of the envelope scanner (the JAX package's): it
extracts the required payload fields without validating the whole JSON
document, so it is more lenient than the Python decoder. Every message it
rejects the Python decoder rejects too, and on messages both accept the
columns are bit-identical.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from real_time_fraud_detection_system_tpu_torch.ops.cuda_lib import BUILD_DIR

NATIVE_SRC = Path(__file__).resolve().parents[2] / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")


class NativeUnavailableError(RuntimeError):
    """The native library could not be built or loaded in this process;
    callers gate on :func:`hostprep_available` / :func:`native_available`."""


_lock = threading.Lock()
_libs: dict = {}  # unit name → (CDLL or None, build error or None)


def library_path(name: str) -> Path:
    """Where the unit ``native/<name>.cc`` builds: ``_build/lib<name>-
    <hash of the source and flags>.so``."""
    h = hashlib.sha256((NATIVE_SRC / f"{name}.cc").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp,
                        str(NATIVE_SRC / f"{name}.cc")],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _configure_envelope(lib) -> None:
    out_cols = [np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")] * 5 \
        + [np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS"),
           np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")]
    lib.decode_envelopes.restype = ctypes.c_int64
    lib.decode_envelopes.argtypes = [
        ctypes.c_char_p,
        np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
        ctypes.c_int64,
    ] + out_cols


def _configure_hostprep(lib) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.latest_wins_keep.restype = ctypes.c_int64
    lib.latest_wins_keep.argtypes = [
        i64p, i64p, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
    ]
    lib.pack_rows.restype = None
    lib.pack_rows.argtypes = [
        i64p, i64p, i64p, i64p,
        ctypes.c_void_p,  # label, nullable
        ctypes.c_int64, ctypes.c_int64,
        np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS"),
    ]


_CONFIGURE = {"envelope": _configure_envelope,
              "hostprep": _configure_hostprep}


def _load(name: str) -> Optional[ctypes.CDLL]:
    with _lock:
        if name not in _libs:
            try:
                lib = ctypes.CDLL(str(_build(name)))
                _CONFIGURE[name](lib)
                _libs[name] = (lib, None)
            except (subprocess.CalledProcessError, OSError,
                    subprocess.TimeoutExpired) as exc:
                _libs[name] = (None, str(exc))
        return _libs[name][0]


def _require(name: str) -> ctypes.CDLL:
    lib = _load(name)
    if lib is None:
        raise NativeUnavailableError(
            f"native {name} unavailable: {_libs[name][1]}")
    return lib


def native_available() -> bool:
    """True when the envelope scanner built and loaded."""
    return _load("envelope") is not None


def hostprep_available() -> bool:
    """True when the host-prep unit built and loaded."""
    return _load("hostprep") is not None


# ---------------------------------------------------------------------------
# host prep: dedup + pack for the serving loop
# ---------------------------------------------------------------------------


def latest_wins_keep(tx_id: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """bool [n] latest-wins mask (the semantics of
    ``ops/dedup.py::latest_wins_mask_np`` with all rows valid)."""
    lib = _require("hostprep")
    n = len(tx_id)
    keep = np.zeros(n, dtype=np.uint8)
    if n:
        lib.latest_wins_keep(np.ascontiguousarray(tx_id, np.int64),
                             np.ascontiguousarray(ts, np.int64), n, keep)
    return keep.view(bool)


def pack_rows(
    tx_datetime_us: np.ndarray,
    customer_id: np.ndarray,
    terminal_id: np.ndarray,
    amount_cents: np.ndarray,
    label: Optional[np.ndarray],
    pad: int,
    out: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Fused ``make_batch`` + ``pack_batch`` → int32 [7, pad], zeros in
    the padding, bit-identical to the NumPy composition. ``out`` (a
    C-contiguous int32 [7, pad] array, e.g. a view of pinned host memory)
    receives the rows in place of a new array."""
    lib = _require("hostprep")
    n = len(tx_datetime_us)
    if pad < n:
        raise ValueError(f"pad={pad} < batch rows {n}")
    if out is None:
        out = np.empty((7, pad), dtype=np.int32)
    elif out.dtype != np.int32 or out.shape != (7, pad) \
            or not out.flags.c_contiguous:
        raise ValueError(f"out: expected a C-contiguous int32 (7, {pad}) "
                         f"array, got {out.dtype} {out.shape}")
    lab = (np.ascontiguousarray(label, np.int64)
           if label is not None else None)
    lib.pack_rows(
        np.ascontiguousarray(tx_datetime_us, np.int64),
        np.ascontiguousarray(customer_id, np.int64),
        np.ascontiguousarray(terminal_id, np.int64),
        np.ascontiguousarray(amount_cents, np.int64),
        lab.ctypes.data if lab is not None else None,
        n, pad, out)
    return out


# ---------------------------------------------------------------------------
# envelope decode
# ---------------------------------------------------------------------------

AUTO_DECODE_WORKERS = min(8, os.cpu_count() or 1)
_PARALLEL_MIN = 8192  # below this, thread fan-out costs more than it saves
_pools: dict = {}  # worker count → ThreadPoolExecutor


def _pool(workers: int) -> ThreadPoolExecutor:
    """One decode pool per distinct worker count, made at first use."""
    with _lock:
        pool = _pools.get(workers)
        if pool is None:
            pool = ThreadPoolExecutor(workers,
                                      thread_name_prefix="envelope-decode")
            _pools[workers] = pool
        return pool


def decode_envelopes_slab(buf: bytes, offsets: np.ndarray, a: int, b: int,
                          *outs: np.ndarray) -> None:
    """Decode envelopes [a, b) of one packed byte buffer into rows [a, b)
    of the output columns (tx_id, t_us, cust, term, cents, op, valid).
    ``offsets`` is the full absolute table (n+1 entries into ``buf``);
    slabs write disjoint slices, so concurrent slabs never contend."""
    lib = _require("envelope")
    if b > a:
        lib.decode_envelopes(buf, offsets[a:b + 1], b - a,
                             *(o[a:b] for o in outs))


def decode_transaction_envelopes_native(
    messages: Iterable[bytes],
    kafka_timestamps_ms: Optional[Sequence[int]] = None,
    workers: int = 0,
) -> Tuple[dict, np.ndarray]:
    """Columnar decode through the C++ scanner, with the Python decoder's
    interface: ``(columns, tombstone_mask)``. Batches of at least 8,192
    messages are cut into ``workers`` contiguous slabs decoded on a thread
    pool (the ctypes call releases the GIL; 0 = auto, min(8, cores); 1 =
    serial). Raises :class:`NativeUnavailableError` without the library."""
    _require("envelope")
    msgs: List[bytes] = (messages if isinstance(messages, list)
                         else list(messages))
    n = len(msgs)
    offsets = np.zeros(n + 1, dtype=np.int64)
    if n:
        np.cumsum(np.fromiter((len(m) for m in msgs), dtype=np.int64,
                              count=n), out=offsets[1:])
    buf = b"".join(msgs)
    outs = tuple(np.zeros(n, dtype=np.int64) for _ in range(5)) \
        + (np.zeros(n, dtype=np.int8), np.zeros(n, dtype=np.uint8))
    n_workers = max(1, int(workers) or AUTO_DECODE_WORKERS)
    if n >= _PARALLEL_MIN and n_workers > 1:
        bounds = np.linspace(0, n, n_workers + 1, dtype=np.int64)
        list(_pool(n_workers).map(
            lambda ab: decode_envelopes_slab(buf, offsets, int(ab[0]),
                                             int(ab[1]), *outs),
            zip(bounds[:-1], bounds[1:])))
    else:
        decode_envelopes_slab(buf, offsets, 0, n, *outs)
    tx_id, t_us, cust, term, cents, op, valid = outs
    kts = (t_us // 1000 if kafka_timestamps_ms is None
           else np.asarray(kafka_timestamps_ms, dtype=np.int64))
    cols = {
        "tx_id": tx_id,
        "tx_datetime_us": t_us,
        "customer_id": cust,
        "terminal_id": term,
        "tx_amount_cents": cents,
        "op": op,
        "kafka_ts_ms": kts,
    }
    return cols, valid == 0
