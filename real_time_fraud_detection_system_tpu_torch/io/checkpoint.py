"""Verified, atomic checkpoints of the full streaming state — port of the
JAX package's ``io/checkpoint.py`` (format v2).

One checkpoint holds everything the step reads — source offsets, the
feature state, the model params, the scaler and the batch counters — in
one ``.npz`` written atomically (a temporary file and ``os.replace``, or
one object PUT), so offsets and state are saved together and a replay
resumes exactly once at micro-batch granularity.

The file is the JAX package's, byte layout and names alike, so a
checkpoint moves between the two packages in both directions:

- the leaves are ``fs_i``/``p_i``/``s_i`` in the JAX package's pytree
  order (``utils/tree.py``) — NamedTuple fields, tuple and list items in
  order, ``None`` fields dropped, a Python ``int`` field
  (``TreeEnsemble.max_depth`` of the descent form) a 0-d leaf — whatever
  the kind: an mlp's list of ``(w, b)`` pairs, a transformer's tuple of
  blocks, the sequence kind's ``HistoryState`` (``fs_leaves`` ``.events``,
  ``.pos``, ``.count``, ``.last_t``; stacked ``[n, C/n + 1, ...]`` from the
  sharded engine, whose restore at another width converts the state
  through ``feature_state_n_old``, as in the JAX package) — and
  ``__meta__`` carries the JAX keys
  (``layout_devices``, the shard count the feature state is laid out for:
  1, or the sharded engine's width; the writer's fleet topology,
  ``process_count`` and ``process_id``; the fleet's ``resize_epochs``; and
  the state's registry ``model_version``; a restore hands them back);
- ``__manifest__`` carries a CRC32 per leaf, the structural fingerprint
  (sha256 over every leaf's key, shape and dtype), the writer's
  incarnation token and, for a delta, its base and the CRC32 of the base's
  manifest.

``restore()`` verifies the checksums, the chain and the structure against
the engine's state; on any mismatch it quarantines the entry
(``stale-<token>-…``), counts ``rtfds_checkpoint_corrupt_total{reason}``
and falls back down the lineage (``rtfds_checkpoint_fallbacks_total``).
A healthy checkpoint written under another process topology is refused
(:class:`CheckpointTopologyError`, the fix named), never quarantined;
the one topology change a restore takes is a single-process global
state into a fleet process, which the sharded engine re-slices to its
residue block (``parallel/mesh.py::adopt_process_slice``). A checkpoint
of another
shard width restores as in the JAX package: the per-shard planes (the
sketches' shard axis, the tiered store's stacked directories) may differ
from the template's, the state's ``layout_devices`` becomes the writer's,
and the checkpoint's feature state waits as host arrays in
``EngineState.layout_pending`` until the engine converts it into its own
tensors (``ScoringEngine._ensure_layout``, through ``parallel/mesh.py``:
directory entries re-homed by ``key % n``). The tiered store's leaves
(key directories, the terminal sketch with its fraud column) move both
ways like any other, and the meta carries the directories' occupancy
(``feature_state_occupancy``) and the cold tier's segment lineage
(``cold_lineage``), which a restore hands back to the engine
(``EngineState.cold_lineage``); :func:`feature_state_report` and
:func:`cold_tier_report` read them from a manifest alone.

Restore writes in place: every restored array is copied into the tensor
the engine already holds (``Tensor.copy_``), so the state never leaves
the engine's device and the tensors keep their addresses. When the
restored params differ from the live ones (by CRC32), the state's
``params_epoch`` advances and the engine re-derives its kernel tables
before the next step. A save first makes the current stream wait for the
event recorded behind the step that last wrote the state
(``EngineState.ready``), then reads it.

The ``ckpt`` command (``cli_ops.py``) lists, verifies and inspects a
lineage through :func:`make_checkpointer`, ``verify_all``, ``manifest``
and :func:`feature_state_report`.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import threading
import time
import uuid
import zipfile
import zlib
from typing import List, Optional, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)

CORRUPT_REASONS = ("checksum", "truncated", "incompatible")


class CorruptCheckpointError(Exception):
    """A checkpoint (or its delta chain) failed restore verification.

    ``reason``: ``checksum`` (bytes present but wrong — a bit flip, a
    broken chain link), ``truncated`` (bytes missing or unreadable — a
    torn write, a missing base) or ``incompatible`` (readable but of
    another structure than the engine's state)."""

    def __init__(self, reason: str, detail: str = ""):
        assert reason in CORRUPT_REASONS, reason
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}: {detail}" if detail else reason)


class CheckpointTopologyError(ValueError):
    """A healthy checkpoint written under another fleet topology than the
    restoring engine serves. Restore refuses it instead of quarantining
    it: every entry of the lineage shares the topology, so falling back
    would only rewind the fleet."""


def _observe_checkpoint(op: str, backend: str, t0: float, nbytes: int,
                        batches_done: int, kind: str = "full") -> None:
    dt = time.perf_counter() - t0
    reg = get_registry()
    reg.histogram("rtfds_checkpoint_seconds",
                  "checkpoint save/restore wall time", op=op,
                  backend=backend).observe(dt)
    reg.counter("rtfds_checkpoint_ops_total", "checkpoint operations",
                op=op, backend=backend).inc()
    if nbytes:
        reg.gauge("rtfds_checkpoint_bytes",
                  "size of the last checkpoint").set(nbytes)
        reg.gauge("rtfds_checkpoint_bytes",
                  "size of the last checkpoint", kind=kind).set(nbytes)
    rec = active_recorder()
    if rec is not None:
        rec.record_event("checkpoint", op=op, batches_done=batches_done,
                         bytes=nbytes, seconds=round(dt, 6),
                         ckpt_kind=kind)


# ---------------------------------------------------------------------------
# State (de)serialization
# ---------------------------------------------------------------------------


# A Python int leaf is written as int32: the JAX engine's jitted step
# returns its params, so from the first batch on it holds such a leaf as
# an int32 array (64-bit types off), and that is what its checkpoints
# carry. A fresh JAX state still holds the int (np.asarray: int64), so a
# restore takes either there.
_SCALAR_INT_DTYPES = ("int32", "int64")


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(_to_numpy(leaf).dtype)


def _wait_ready(engine_state) -> None:
    """Order the reads of a save after the step that last wrote the
    state: the current stream waits for the event recorded behind it (not
    a device-wide synchronize), so a save made from another thread or
    stream than the step's never reads a half-written table."""
    ready = getattr(engine_state, "ready", None)
    if ready is not None:
        torch.cuda.current_stream().wait_event(ready)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, dtype=np.int32)
    return np.asarray(leaf)


def _fs_leaf_names(feature_state) -> dict:
    """``fs_i`` → the JAX key path of the feature-state leaf (``ckpt
    --inspect`` attributes bytes to named planes from these)."""
    return {f"fs_{i}": path for i, (path, _) in
            enumerate(tree.leaves_with_path(feature_state))}


def _state_arrays(engine_state) -> Tuple[dict, dict]:
    """An EngineState → the npz array dict and the meta dict: the one
    place the on-disk leaf naming lives."""
    _wait_ready(engine_state)
    # a cross-width restore not yet converted by the engine: the state is
    # still the checkpoint's, in its writer's layout
    fstate = getattr(engine_state, "layout_pending", None)
    if fstate is None:
        fstate = engine_state.feature_state
    arrays = {}
    for prefix, sub in (("fs", fstate),
                        ("p", engine_state.params),
                        ("s", engine_state.scaler)):
        for i, leaf in enumerate(tree.leaves(sub)):
            arrays[f"{prefix}_{i}"] = _to_numpy(leaf)
    meta = {
        "offsets": list(map(int, engine_state.offsets)),
        "batches_done": int(engine_state.batches_done),
        "rows_done": int(engine_state.rows_done),
        "n_fs": len(tree.leaves(fstate)),
        "n_p": len(tree.leaves(engine_state.params)),
        "n_s": len(tree.leaves(engine_state.scaler)),
        "fs_leaves": _fs_leaf_names(fstate),
        # the JAX package's topology and lineage stamps: the shard count
        # the feature state is laid out for, and the writer's fleet
        # topology (a fleet process's state holds its residue block only)
        "layout_devices": int(getattr(engine_state, "layout_devices", 1)
                              or 1),
        "process_count": int(getattr(engine_state, "process_count", 1)
                             or 1),
        "process_id": int(getattr(engine_state, "process_id", 0) or 0),
        # the registry version the params descend from (the learning
        # loop's resync stamp)
        "model_version": getattr(engine_state, "model_version", None),
    }
    occ = _directory_occupancy(fstate)
    if occ:
        # hot-tier occupancy at save time, readable from the manifest
        meta["feature_state_occupancy"] = occ
    lineage = getattr(engine_state, "cold_lineage", None)
    if lineage:
        # the live cold segments this state pairs with (io/coldstore.py)
        meta["cold_lineage"] = lineage
    epochs = getattr(engine_state, "resize_epochs", None)
    if epochs:
        # the fleet resizes this state lived through; a restored worker
        # re-derives its resume floors from the newest record
        meta["resize_epochs"] = epochs
    return arrays, meta


def _directory_occupancy(feature_state) -> dict:
    """Occupied hot-tier slots per table with a key directory, one entry
    per shard (the JAX package's per-shard lists); ``{}`` without one."""
    out = {}
    for table in ("customer", "terminal"):
        kd = getattr(feature_state, f"{table}_dir", None)
        if kd is not None:
            tops = np.atleast_1d(_to_numpy(kd.free_top))
            out[table] = [int(kd.free.shape[-1]) - int(t) for t in tops]
    return out


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(memoryview(np.ascontiguousarray(arr)).cast("B"))


def _restore_tree(state, prefix: str, arrays: dict):
    """Write ``arrays[prefix_i]`` into the tree's tensors in place (on
    their own device: a copy that cannot reach it raises) and rebuild its
    Python scalars."""
    values = []
    for i, (path, leaf) in enumerate(tree.leaves_with_path(state)):
        a = np.asarray(arrays[f"{prefix}_{i}"])
        if isinstance(leaf, torch.Tensor):
            # np.require keeps a 0-d array 0-d (ascontiguousarray would not)
            src = torch.from_numpy(np.require(a, requirements="C"))
            if src.dtype != leaf.dtype or src.shape != leaf.shape:
                raise CorruptCheckpointError(
                    "incompatible",
                    f"{prefix}_{i} ({path}) is {a.dtype} {list(a.shape)}, "
                    f"the state {_dtype_name(leaf)} {list(leaf.shape)}")
            leaf.copy_(src)
            values.append(leaf)
        else:
            values.append(type(leaf)(a.item()))
    # the same tensor objects (written in place above), new scalars
    return tree.unflatten(state, values)


def _param_crcs(params) -> dict:
    return {f"p_{i}": _crc(_to_numpy(leaf))
            for i, leaf in enumerate(tree.leaves(params))}


def _apply_arrays(engine_state, meta: dict, arrays: dict,
                  crcs: Optional[dict] = None):
    """Restore the (composed) arrays into an EngineState in place.

    ``crcs`` are the arrays' CRC32s where the caller verified them. When
    the restored params differ from the live ones, ``params_epoch``
    advances (the engine then re-derives its kernel tables)."""
    new = {k: (int(crcs[k]) if crcs and k in crcs else _crc(arrays[k]))
           for k in arrays if k.startswith("p_")}
    live = getattr(engine_state, "params_crcs", None)
    if live is None:
        live = _param_crcs(engine_state.params)
    n_old = int(meta.get("layout_devices", 1) or 1)
    ck_pc = int(meta.get("process_count", 1) or 1)
    # a global state restored by a fleet process: re-sliced to its
    # residue block by the engine (ShardedScoringEngine._ensure_layout)
    adopt = ck_pc == 1 and int(getattr(engine_state, "process_count", 1)
                               or 1) > 1
    if adopt or n_old != int(getattr(engine_state, "layout_devices", 1)
                             or 1):
        # another width: the layouts are permutations (and the sketch's
        # shard axis differs), so the engine converts the checkpoint's
        # state before its next step (ScoringEngine._ensure_layout); its
        # own tensors stay as they are until then
        engine_state.layout_pending = tree.unflatten(
            engine_state.feature_state,
            [np.asarray(arrays[f"fs_{i}"]) for i in range(
                len(tree.leaves(engine_state.feature_state)))])
        engine_state.layout_devices = n_old
    else:
        engine_state.feature_state = _restore_tree(
            engine_state.feature_state, "fs", arrays)
        engine_state.layout_pending = None
    engine_state.params = _restore_tree(engine_state.params, "p", arrays)
    engine_state.scaler = _restore_tree(engine_state.scaler, "s", arrays)
    if new != live:
        engine_state.params_epoch = getattr(
            engine_state, "params_epoch", 0) + 1
    engine_state.params_crcs = new
    engine_state.offsets = list(meta["offsets"])
    engine_state.batches_done = int(meta["batches_done"])
    engine_state.rows_done = int(meta["rows_done"])
    if meta.get("cold_lineage") is not None:
        engine_state.cold_lineage = meta["cold_lineage"]
    if meta.get("model_version") is not None:
        engine_state.model_version = int(meta["model_version"])
    # the writer's topology (a checkpoint without stamps was written by
    # one process)
    engine_state.process_count = ck_pc
    engine_state.process_id = int(meta.get("process_id", 0) or 0)
    if meta.get("resize_epochs") is not None:
        engine_state.resize_epochs = meta["resize_epochs"]
    return engine_state


def write_state_npz(fileobj, engine_state) -> None:
    """The raw payload (no manifest): in-memory snapshots of the poison
    isolation probes, object-store PUT bodies."""
    arrays, meta = _state_arrays(engine_state)
    np.savez(fileobj, __meta__=json.dumps(meta), **arrays)


def state_to_bytes(engine_state) -> bytes:
    buf = _io.BytesIO()
    write_state_npz(buf, engine_state)
    return buf.getvalue()


def bytes_to_state(data: bytes, engine_state):
    """Restore npz bytes into an EngineState of the same shapes, in
    place; returns it."""
    return read_state_npz(_io.BytesIO(data), engine_state)


def read_state_npz(fileobj, engine_state):
    """The trusting raw reader (snapshots): no verification."""
    with np.load(fileobj, allow_pickle=False) as z:
        meta = json.loads(str(z["__meta__"]))
        arrays = {k: z[k] for k in z.files if k != "__meta__"
                  and k != "__manifest__"}
    return _apply_arrays(engine_state, meta, arrays)


# ---------------------------------------------------------------------------
# v2 manifest
# ---------------------------------------------------------------------------


def _spec_of_arrays(arrays: dict) -> dict:
    return {k: [list(np.shape(a)), str(np.asarray(a).dtype)]
            for k, a in sorted(arrays.items())}


def _fingerprint(spec: dict) -> str:
    """sha256 over every leaf's key, shape and dtype: a window count, a
    capacity, a model width or a dtype change all change it."""
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _template_spec(engine_state) -> dict:
    """Leaf spec of the state a restore writes into, from shapes and
    dtypes only (no copy to the host)."""
    out = {}
    for prefix, sub in (("fs", engine_state.feature_state),
                        ("p", engine_state.params),
                        ("s", engine_state.scaler)):
        for i, leaf in enumerate(tree.leaves(sub)):
            out[f"{prefix}_{i}"] = [list(np.shape(leaf)), _dtype_name(leaf)]
    return dict(sorted(out.items()))


def _parse_entry(data: bytes):
    """npz bytes → (meta, manifest|None, manifest_raw|None, arrays);
    ``truncated`` for unreadable bytes, ``checksum`` where the zip
    layer's own CRC catches a flip."""
    try:
        with np.load(_io.BytesIO(data), allow_pickle=False) as z:
            files = set(z.files)
            meta = json.loads(str(z["__meta__"]))
            man_raw = (str(z["__manifest__"])
                       if "__manifest__" in files else None)
            arrays = {k: z[k] for k in files
                      if k not in ("__meta__", "__manifest__")}
    except zipfile.BadZipFile as e:
        reason = "checksum" if "CRC-32" in str(e) else "truncated"
        raise CorruptCheckpointError(reason, str(e)) from None
    except (KeyError, EOFError, OSError, ValueError) as e:
        raise CorruptCheckpointError(
            "truncated", f"{type(e).__name__}: {e}") from None
    manifest = None
    if man_raw is not None:
        try:
            manifest = json.loads(man_raw)
        except ValueError as e:
            raise CorruptCheckpointError(
                "truncated", f"manifest unparseable: {e}") from None
    return meta, manifest, man_raw, arrays


def _write_checkpoint_npz(fileobj, arrays: dict, meta: dict,
                          manifest: dict) -> None:
    np.savez(fileobj,
             __meta__=json.dumps(meta),
             __manifest__=json.dumps(manifest, sort_keys=True,
                                     separators=(",", ":")),
             **arrays)


# ---------------------------------------------------------------------------
# Storage backends
# ---------------------------------------------------------------------------


class _LocalBackend:
    """Flat-directory storage; names are bare file names."""

    kind = "local"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def path_of(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def name_of(self, path: str) -> str:
        return os.path.basename(path)

    def read(self, name: str) -> bytes:
        try:
            with open(self.path_of(name), "rb") as f:
                return f.read()
        except FileNotFoundError:
            raise KeyError(name) from None

    def write(self, name: str, data: bytes) -> None:
        self.write_via(name, lambda f: f.write(data))

    def write_via(self, name: str, writer) -> int:
        """A temporary file and an atomic rename around ``writer(f)``;
        returns the committed size."""
        path = self.path_of(name)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            writer(f)
        os.replace(tmp, path)
        return os.path.getsize(path)

    def delete(self, name: str) -> None:
        try:
            os.remove(self.path_of(name))
        except FileNotFoundError:
            pass

    def move(self, name: str, new_name: str) -> None:
        os.replace(self.path_of(name), self.path_of(new_name))

    def exists(self, name: str) -> bool:
        return os.path.exists(self.path_of(name))

    def list_names(self) -> List[str]:
        return sorted(os.listdir(self.directory))

    def info(self, name: str) -> dict:
        try:
            st = os.stat(self.path_of(name))
            return {"size": st.st_size, "mtime": st.st_mtime}
        except OSError:
            return {"size": None, "mtime": None}

    def sweep_orphan_tmps(self) -> List[str]:
        """Remove the ``ckpt-*.tmp`` a crash between the write and the
        rename leaves behind (never part of the committed lineage)."""
        swept = []
        for f in self.list_names():
            if f.startswith("ckpt-") and f.endswith(".tmp"):
                self.delete(f)
                swept.append(f)
        return swept


class _StoreBackend:
    """Object-store storage: every op runs through ``with_retries``
    (errors keep their type; a missing key's ``KeyError`` is not retried)
    with an optional per-op timeout that turns a hung call into a
    transient. Object PUTs are atomic."""

    kind = "store"

    def __init__(self, store, prefix: str, op_timeout_s: float = 0.0,
                 op_attempts: int = 3):
        self.store = store
        self.prefix = prefix.strip("/")
        self.op_timeout_s = float(op_timeout_s)
        self.op_attempts = max(1, int(op_attempts))

    def _retrying(self, fn):
        from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
            RetryPolicy,
            TransientError,
            with_retries,
        )

        def attempt():
            if self.op_timeout_s <= 0:
                return fn()
            box: dict = {}

            def run():
                try:
                    box["v"] = fn()
                # the thread boundary: park the original exception for
                # the caller to re-raise through the retry policy
                except BaseException as e:  # noqa: BLE001
                    box["e"] = e

            t = threading.Thread(target=run, daemon=True,
                                 name="ckpt-store-op")
            t.start()
            t.join(self.op_timeout_s)
            if t.is_alive():
                raise TransientError(
                    f"store op timed out after {self.op_timeout_s:.1f}s")
            if "e" in box:
                raise box["e"]
            return box.get("v")

        return with_retries(
            attempt,
            RetryPolicy(max_attempts=self.op_attempts, base_delay_s=0.1,
                        multiplier=2.0, max_delay_s=2.0),
            retry_on=(TransientError, ConnectionError, TimeoutError,
                      OSError),
        )

    def path_of(self, name: str) -> str:
        return f"{self.prefix}/{name}" if self.prefix else name

    def name_of(self, path: str) -> str:
        pre = self.prefix + "/" if self.prefix else ""
        return path[len(pre):] if path.startswith(pre) else path

    def read(self, name: str) -> bytes:
        return self._retrying(lambda: self.store.get(self.path_of(name)))

    def write(self, name: str, data: bytes) -> None:
        self._retrying(lambda: self.store.put(self.path_of(name), data))

    def write_via(self, name: str, writer) -> int:
        buf = _io.BytesIO()
        writer(buf)
        data = buf.getvalue()
        self.write(name, data)
        return len(data)

    def delete(self, name: str) -> None:
        self._retrying(lambda: self.store.delete(self.path_of(name)))

    def move(self, name: str, new_name: str) -> None:
        src, dst = self.path_of(name), self.path_of(new_name)
        move = getattr(self.store, "move", None)
        if move is not None:
            self._retrying(lambda: move(src, dst))
        else:  # a store without move: copy, then delete
            data = self._retrying(lambda: self.store.get(src))
            self._retrying(lambda: self.store.put(dst, data))
            self._retrying(lambda: self.store.delete(src))

    def exists(self, name: str) -> bool:
        return self._retrying(
            lambda: self.store.exists(self.path_of(name)))

    def list_names(self) -> List[str]:
        pre = self.prefix + "/" if self.prefix else ""
        keys = self._retrying(lambda: self.store.list(pre))
        # flat-directory semantics: deeper keys belong to other lineages
        return sorted(k[len(pre):] for k in keys
                      if "/" not in k[len(pre):])

    def info(self, name: str) -> dict:
        head = getattr(self.store, "head", None)
        if head is None:
            return {"size": None, "mtime": None}
        try:
            h = self._retrying(lambda: head(self.path_of(name)))
        except KeyError:
            return {"size": None, "mtime": None}
        etag = str(h.get("etag", ""))
        mtime = int(etag) / 1e9 if etag.isdigit() else None
        return {"size": h.get("size"), "mtime": mtime}


# ---------------------------------------------------------------------------
# Checkpointers
# ---------------------------------------------------------------------------


class _CheckpointerBase:
    """The lineage over a storage backend: v2 manifests, delta chains,
    verified restore with quarantine and fallback, chain-aware GC."""

    def __init__(self, backend, keep: int = 3, full_every: int = 1):
        self._backend = backend
        self.keep = keep
        self.full_every = max(1, int(full_every))
        self.incarnation = uuid.uuid4().hex[:12]
        # (name, manifest_raw, manifest) of this writer's last save: the
        # delta base. A fresh process always starts with a full.
        self._last: Optional[Tuple[str, str, dict]] = None
        self._since_full = 0
        self._manifest_cache: dict = {}

    # -- lineage API ------------------------------------------------------

    def _live_names(self) -> List[str]:
        return [
            f for f in self._backend.list_names()
            if f.startswith("ckpt-") and f.endswith(".npz")
            and ".tmp" not in f
        ]

    def list_checkpoints(self) -> list:
        """Live checkpoint paths, oldest → newest."""
        return [self._backend.path_of(n) for n in self._live_names()]

    def latest(self) -> Optional[str]:
        ckpts = self.list_checkpoints()
        return ckpts[-1] if ckpts else None

    def exists(self, path: str) -> bool:
        return self._backend.exists(self._backend.name_of(path))

    def quarantine(self, paths, token: str,
                   clear_previous: bool = True) -> None:
        """Rename checkpoints to ``stale-<token>-…`` (bytes kept, hidden
        from ``latest()`` and the GC). The fresh-start fence clears an
        earlier stash first; the corruption path keeps it."""
        if clear_previous:
            for old in self._backend.list_names():
                if old.startswith("stale-") and old.endswith(".npz"):
                    self._backend.delete(old)
        for p in paths:
            name = self._backend.name_of(p)
            if self._backend.exists(name):
                self._backend.move(name, f"stale-{token}-{name}")
            self._manifest_cache.pop(name, None)
            if self._last is not None and self._last[0] == name:
                # the delta base left the lineage: the next save is full
                self._last = None

    # -- save -------------------------------------------------------------

    def save(self, engine_state) -> str:
        t0 = time.perf_counter()
        arrays, meta = _state_arrays(engine_state)
        crcs = {k: _crc(a) for k, a in arrays.items()}
        spec = _spec_of_arrays(arrays)
        fp = _fingerprint(spec)
        step = meta["batches_done"]
        kind = "full"
        name = f"ckpt-{step:010d}.npz"
        stored = arrays
        base = base_crc = None
        if (self.full_every > 1 and self._last is not None
                and self._since_full + 1 < self.full_every):
            last_name, last_raw, last_man = self._last
            dname = f"ckpt-{step:010d}-delta.npz"
            if (last_man.get("fingerprint") == fp
                    and dname != last_name
                    and not self._backend.exists(dname)
                    # the base may have been quarantined or collected
                    # since this writer saw it
                    and self._backend.exists(last_name)):
                kind = "delta"
                name = dname
                base = last_name
                base_crc = zlib.crc32(last_raw.encode())
                last_crcs = last_man.get("crcs", {})
                stored = {k: a for k, a in arrays.items()
                          if crcs[k] != last_crcs.get(k)}
        manifest = {
            "format": 2,
            "kind": kind,
            "incarnation": self.incarnation,
            "batches_done": step,
            "fingerprint": fp,
            "spec": spec,
            "crcs": crcs,
            "stored": sorted(stored),
            "base": base,
            "base_manifest_crc": base_crc,
        }
        nbytes = self._backend.write_via(
            name, lambda f: _write_checkpoint_npz(f, stored, meta,
                                                  manifest))
        man_raw = json.dumps(manifest, sort_keys=True,
                             separators=(",", ":"))
        self._last = (name, man_raw, manifest)
        self._since_full = 0 if kind == "full" else self._since_full + 1
        self._manifest_cache[name] = manifest
        self._gc()
        reg = get_registry()
        reg.gauge("rtfds_last_checkpoint_unix_seconds",
                  "wall-clock time of the last checkpoint save").set(
            time.time())
        reg.gauge("rtfds_checkpoint_lineage_depth",
                  "live checkpoints in the lineage").set(
            len(self._live_names()))
        reg.gauge("rtfds_checkpoint_serving_fallback",
                  "1 while the engine serves off a fallback (non-newest) "
                  "checkpoint restore").set(0)
        _observe_checkpoint("save", self._backend.kind, t0, nbytes,
                            step, kind=kind)
        return self._backend.path_of(name)

    # -- restore ----------------------------------------------------------

    def _manifest_of(self, name: str) -> Optional[dict]:
        man = self._manifest_cache.get(name)
        if man is not None:
            return man
        try:
            _, man, _, _ = _parse_entry(self._backend.read(name))
        except (KeyError, CorruptCheckpointError):
            return None
        if man is not None:
            self._manifest_cache[name] = man
        return man

    def _resolve_chain(self, name: str, template=None
                       ) -> Tuple[dict, dict, Optional[dict]]:
        """Load and verify the checkpoint at ``name`` and its delta chain
        → (meta, composed arrays, their verified CRC32s or None for a v1
        entry). Raises :class:`CorruptCheckpointError` on a broken
        invariant, and refuses state the port cannot serve."""
        entries = []  # tip first: (name, meta, manifest, arrays)
        seen = set()
        cur: Optional[str] = name
        expect_crc: Optional[int] = None
        while cur is not None:
            if cur in seen:
                raise CorruptCheckpointError(
                    "checksum", f"delta chain cycle at {cur}")
            seen.add(cur)
            try:
                data = self._backend.read(cur)
            except KeyError:
                raise CorruptCheckpointError(
                    "truncated", f"chain entry {cur} is missing") from None
            meta, man, man_raw, arrays = _parse_entry(data)
            if expect_crc is not None:
                if man_raw is None or zlib.crc32(
                        man_raw.encode()) != expect_crc:
                    raise CorruptCheckpointError(
                        "checksum",
                        f"chain link mismatch: {cur} is not the base its "
                        f"delta was built from")
            entries.append((cur, meta, man, arrays))
            if man is not None and man.get("kind") == "delta":
                base = man.get("base")
                if not base:
                    raise CorruptCheckpointError(
                        "truncated", f"delta {cur} names no base")
                expect_crc = man.get("base_manifest_crc")
                cur = base
            else:
                cur = None
        tip_name, tip_meta, tip_man, _ = entries[0]
        composed: dict = {}
        for _, _, _, arrays in reversed(entries):
            composed.update(arrays)
        crcs = None
        if tip_man is not None:
            crcs = tip_man.get("crcs", {})
            missing = [k for k in crcs if k not in composed]
            if missing:
                raise CorruptCheckpointError(
                    "truncated",
                    f"composed state is missing leaves {missing[:4]}")
            for k, want in crcs.items():
                if _crc(composed[k]) != int(want):
                    raise CorruptCheckpointError(
                        "checksum", f"leaf {k} fails its manifest CRC32")
        if template is not None:
            # after the checksums held, before the structural check could
            # call a healthy entry incompatible: a topology change is a
            # refusal, never a quarantine
            self._check_topology(tip_name, tip_meta, template)
            self._check_template(tip_name, tip_meta, tip_man, composed,
                                 template)
        return tip_meta, composed, crcs

    @staticmethod
    def _check_topology(name, meta, template) -> None:
        """Refuse a healthy checkpoint written under another fleet
        topology, as the JAX checkpointer does. Allowed: the same
        topology (process count, and this process's id), and a
        single-process global checkpoint restored by a fleet process,
        which the engine re-slices. Every other case names its fix."""
        ck_pc = int(meta.get("process_count", 1) or 1)
        ck_pid = int(meta.get("process_id", 0) or 0)
        tpl_pc = int(getattr(template, "process_count", 1) or 1)
        tpl_pid = int(getattr(template, "process_id", 0) or 0)
        if ck_pc == tpl_pc and (ck_pc == 1 or ck_pid == tpl_pid):
            if ck_pc > 1:
                # the same process of the same fleet at another width:
                # ownership is key % (P·L), so keys would move BETWEEN
                # processes, which no per-process reshard can do
                ck_ld = int(meta.get("layout_devices", 1) or 1)
                tpl_ld = int(getattr(template, "layout_devices", 1) or 1)
                if ck_ld != tpl_ld:
                    raise CheckpointTopologyError(
                        f"{name} was written at {ck_ld} device(s) per "
                        f"process but this engine serves {tpl_ld} — in "
                        f"a {ck_pc}-process fleet that changes the "
                        "residue-block ownership (key % (P·L)), moving "
                        "keys BETWEEN processes: merge the fleet's "
                        "checkpoints to a global state (parallel.mesh."
                        "merge_process_states → save single-process) "
                        "and let the new fleet's elastic 1→N adoption "
                        "re-slice it, or relaunch at the original "
                        f"--devices {ck_ld}")
            return
        if ck_pc == 1 and tpl_pc > 1:
            return  # the 1→P adoption: the engine re-slices
        if ck_pc == tpl_pc:
            raise CheckpointTopologyError(
                f"{name} was written by process {ck_pid} of the "
                f"{ck_pc}-process fleet, but this engine is process "
                f"{tpl_pid} — each process restores its OWN residue "
                "block; point every worker at its own proc-NN "
                "checkpoint directory (the launcher does this when the "
                "checkpoint root and process ids are unchanged)")
        raise CheckpointTopologyError(
            f"{name} was written by a {ck_pc}-process fleet; this "
            f"engine serves a {tpl_pc}-process topology. A per-process "
            "checkpoint holds only its residue block's keys, so a "
            "process-count change cannot restore directly: merge every "
            "process's final checkpoint into one global state "
            "(parallel.mesh.merge_process_states), save it from a "
            "single-process engine, and let the new fleet's elastic "
            "1→N adoption re-slice it — or relaunch at the original "
            f"--num-processes {ck_pc}")

    @staticmethod
    def _check_template(name, meta, manifest, arrays, template) -> None:
        """Leaf counts and shapes always; dtypes for v2 entries (a Python
        int leaf takes int32 or int64)."""
        spec = _template_spec(template)
        scalars = {f"{prefix}_{i}"
                   for prefix, sub in (("fs", template.feature_state),
                                       ("p", template.params),
                                       ("s", template.scaler))
                   for i, leaf in enumerate(tree.leaves(sub))
                   if isinstance(leaf, int)}
        n_fs = sum(1 for k in spec if k.startswith("fs_"))
        n_p = sum(1 for k in spec if k.startswith("p_"))
        n_s = sum(1 for k in spec if k.startswith("s_"))
        if (meta.get("n_fs"), meta.get("n_p"), meta.get("n_s")) != (
                n_fs, n_p, n_s):
            raise CorruptCheckpointError(
                "incompatible",
                f"{name}: leaf counts {meta.get('n_fs')}/{meta.get('n_p')}"
                f"/{meta.get('n_s')} vs template {n_fs}/{n_p}/{n_s}")
        # At another width the per-shard planes change shape: the
        # sketches' shard axis and the tiered store's directory stacks.
        # The window tables are global [cap, NB] at every width, so their
        # shapes still must match (a capacity mismatch stays an
        # incompatible checkpoint); the engine's re-layout then checks the
        # rest itself.
        cross_width = int(meta.get("layout_devices", 1) or 1) != int(
            getattr(template, "layout_devices", 1) or 1)
        fs_names = meta.get("fs_leaves") or {}

        def width_dependent(k: str) -> bool:
            path = fs_names.get(k, "")
            return k.startswith("fs_") and ("_dir" in path or "cms" in path)

        for k, (shape, dtype) in spec.items():
            a = arrays.get(k)
            if a is None:
                raise CorruptCheckpointError(
                    "truncated", f"{name}: leaf {k} absent")
            if list(np.shape(a)) != list(shape) and not (
                    cross_width and width_dependent(k)):
                raise CorruptCheckpointError(
                    "incompatible",
                    f"{name}: leaf {k} shape {list(np.shape(a))} vs "
                    f"template {list(shape)}")
            if k in scalars and str(a.dtype) in _SCALAR_INT_DTYPES:
                continue
            if manifest is not None and str(a.dtype) != str(dtype):
                raise CorruptCheckpointError(
                    "incompatible",
                    f"{name}: leaf {k} dtype {a.dtype} vs template "
                    f"{dtype}")

    def _note_corrupt(self, name: str, err: CorruptCheckpointError) -> None:
        get_registry().counter(
            "rtfds_checkpoint_corrupt_total",
            "checkpoints that failed restore verification, by reason",
            reason=err.reason).inc()
        rec = active_recorder()
        if rec is not None:
            rec.record_event("checkpoint_fallback", path=name,
                             reason=err.reason, detail=err.detail[:200])
        from real_time_fraud_detection_system_tpu_torch.utils.logging import (
            get_logger,
        )

        get_logger("checkpoint").error(
            "corrupt checkpoint %s (%s: %s) — quarantining and falling "
            "back down the lineage", name, err.reason, err.detail[:200])
        self.quarantine([self._backend.path_of(name)],
                        uuid.uuid4().hex[:8], clear_previous=False)

    def restore(self, engine_state, path: Optional[str] = None):
        """Restore into an EngineState in place, verified; on a mismatch
        quarantine the entry and fall back to the next newest. Returns
        the state, or None when no valid checkpoint exists."""
        names = self._live_names()
        if path is not None:
            want = self._backend.name_of(path)
            names = [n for n in names if n <= want]
            if want not in names and self._backend.exists(want):
                names.append(want)
        if not names:
            return None
        tip = names[-1]
        corrupt = 0
        for n in reversed(names):
            t0 = time.perf_counter()
            try:
                meta, arrays, crcs = self._resolve_chain(
                    n, template=engine_state)
            except CorruptCheckpointError as e:
                corrupt += 1
                self._note_corrupt(n, e)
                continue
            out = _apply_arrays(engine_state, meta, arrays, crcs)
            nbytes = sum(a.nbytes for a in arrays.values())
            _observe_checkpoint("restore", self._backend.kind, t0, nbytes,
                                int(out.batches_done))
            if corrupt:
                reg = get_registry()
                reg.counter(
                    "rtfds_checkpoint_fallbacks_total",
                    "restores that fell back past corrupt checkpoints"
                ).inc()
                reg.gauge(
                    "rtfds_checkpoint_serving_fallback",
                    "1 while the engine serves off a fallback "
                    "(non-newest) checkpoint restore").set(1)
                rec = active_recorder()
                if rec is not None:
                    rec.record_event(
                        "checkpoint_fallback", restored=n, skipped=corrupt,
                        from_tip=tip, batches_done=int(out.batches_done))
            return out
        return None  # every lineage entry failed verification

    # -- verification -----------------------------------------------------

    def verify_all(self, deep: bool = True) -> List[dict]:
        """A report on every live checkpoint, without quarantining or
        counting. ``deep`` re-checksums each entry and its composed
        chain; otherwise one read per entry (the zip layer's CRCs)."""
        now = time.time()  # against the backend's mtime
        out = []
        for n in self._live_names():
            info = self._backend.info(n)
            entry = {
                "path": self._backend.path_of(n),
                "size": info.get("size"),
                "age_s": (round(now - info["mtime"], 1)
                          if info.get("mtime") else None),
            }
            try:
                meta, man, _, _ = _parse_entry(self._backend.read(n))
                entry["kind"] = (man.get("kind", "full") if man else "v1")
                entry["batches_done"] = meta.get("batches_done")
                entry["incarnation"] = (man or {}).get("incarnation")
                if deep:
                    self._resolve_chain(n)
                entry["valid"] = True
            except CorruptCheckpointError as e:
                entry["valid"] = False
                entry["reason"] = e.reason
                entry["detail"] = e.detail[:200]
            except KeyError:
                entry["valid"] = False
                entry["reason"] = "truncated"
                entry["detail"] = "entry vanished mid-verify"
            out.append(entry)
        return out

    def manifest(self, path: str) -> dict:
        """Meta and manifest of one checkpoint (v1: ``{"format": 1}``)."""
        name = self._backend.name_of(path)
        meta, man, _, _ = _parse_entry(self._backend.read(name))
        if man is None:
            return {"format": 1, "meta": meta}
        return {**man, "meta": meta}

    # -- retention --------------------------------------------------------

    def _gc(self) -> None:
        names = self._live_names()
        if len(names) <= self.keep:
            return
        keep_set = set(names[-self.keep:])
        # never collect a base that a kept delta still composes from
        frontier = list(keep_set)
        live = set(names)
        while frontier:
            n = frontier.pop()
            man = self._manifest_of(n)
            base = (man or {}).get("base") if (man or {}).get(
                "kind") == "delta" else None
            if base and base in live and base not in keep_set:
                keep_set.add(base)
                frontier.append(base)
        for n in names:
            if n not in keep_set:
                self._backend.delete(n)
                self._manifest_cache.pop(n, None)


class Checkpointer(_CheckpointerBase):
    """Filesystem checkpointer (a temporary file and an atomic rename).
    Construction sweeps the ``ckpt-*.tmp`` orphans of a killed save."""

    def __init__(self, directory: str, keep: int = 3, full_every: int = 1):
        self.directory = directory
        super().__init__(_LocalBackend(directory), keep=keep,
                         full_every=full_every)
        self._backend.sweep_orphan_tmps()


class StoreCheckpointer(_CheckpointerBase):
    """Checkpointer over an object store (:mod:`..io.store`): atomic PUTs,
    every op retried with its error's type kept and an optional per-op
    timeout (``op_timeout_s``; 0 = wait)."""

    def __init__(self, store, prefix: str = "checkpoints", keep: int = 3,
                 full_every: int = 1, op_timeout_s: float = 0.0,
                 op_attempts: int = 3):
        self.store = store
        self.prefix = prefix.strip("/")
        super().__init__(
            _StoreBackend(store, prefix, op_timeout_s=op_timeout_s,
                          op_attempts=op_attempts),
            keep=keep, full_every=full_every)


def make_checkpointer(path_or_url: str, keep: int = 3, full_every: int = 1,
                      op_timeout_s: float = 0.0, op_attempts: int = 3):
    """``s3://bucket/prefix`` → :class:`StoreCheckpointer` over an
    :class:`~.store.S3Store`, ``file://dir`` → one over a
    :class:`~.store.LocalStore`; a local path → :class:`Checkpointer`."""
    if "://" in path_or_url:
        from real_time_fraud_detection_system_tpu_torch.io.store import (
            make_store,
        )

        return StoreCheckpointer(make_store(path_or_url), prefix="",
                                 keep=keep, full_every=full_every,
                                 op_timeout_s=op_timeout_s,
                                 op_attempts=op_attempts)
    return Checkpointer(path_or_url, keep=keep, full_every=full_every)


def feature_state_report(man: dict) -> Optional[dict]:
    """Operator view of a checkpoint's feature-state plane from the
    MANIFEST alone (no array loads): named leaves with per-shard byte
    attribution, plus the per-shard directory occupancy the writer
    recorded — the JAX package's ``ckpt --inspect`` report, for either
    package's checkpoints.

    Returns None when the entry predates leaf naming (v1, or a pre-
    sharded-state v2 manifest)."""
    meta = man.get("meta") or {}
    names = meta.get("fs_leaves") or {}
    spec = man.get("spec") or {}
    if not names or not spec:
        return None
    layout = int(meta.get("layout_devices", 1) or 1)
    stored = set(man.get("stored") or [])
    leaves = []
    total = 0
    for k in sorted(names, key=lambda k: int(k.split("_")[1])):
        if k not in spec:
            continue
        shape, dtype = spec[k]
        nbytes = int(np.prod(shape, dtype=np.int64) if shape else 1) \
            * np.dtype(dtype).itemsize
        total += nbytes
        row = {"leaf": k, "path": names[k], "shape": shape,
               "dtype": dtype, "bytes": nbytes}
        if stored:
            # delta checkpoints: which state leaves actually churned
            row["stored_in_entry"] = k in stored
        if layout > 1 and shape and int(shape[0]) == layout:
            # stacked per-shard leaf (directories, sketch replicas)
            row["per_shard_bytes"] = nbytes // layout
        leaves.append(row)
    out: dict = {"layout_devices": layout, "total_bytes": total,
                 "leaves": leaves}
    pc = int(meta.get("process_count", 1) or 1)
    if pc > 1:
        # fleet writer: this entry holds ONE process's residue block
        out["process_count"] = pc
        out["process_id"] = int(meta.get("process_id", 0) or 0)
        out["fleet_shards_total"] = pc * layout
    occ = meta.get("feature_state_occupancy")
    if occ:
        out["occupancy_per_shard"] = occ
        worst = {
            t: int(max(range(len(v)), key=lambda s: v[s]))
            for t, v in occ.items() if v}
        out["worst_shard"] = {
            t: {"shard": s, "occupied": occ[t][s]}
            for t, s in worst.items()}
    cold = cold_tier_report(meta.get("cold_lineage"))
    if cold is not None:
        out["cold"] = cold
    return out


def cold_tier_report(lineage: Optional[dict]) -> Optional[dict]:
    """Cold-tier plane of the inspect report, from MANIFESTS alone
    (no segment-blob reads): the lineage the checkpoint recorded, plus a
    per-segment CRC VERDICT against the cold store's on-disk manifests —
    ``ok`` (manifest present, crc matches the lineage), ``mismatch``
    (the segment was rewritten/corrupted since the save), ``missing``
    (segment gone — e.g. gc after a newer checkpoint; its keys degrade
    to CMS on restore), ``unavailable`` (cold store unreachable)."""
    if not lineage:
        return None
    segs = list(lineage.get("segments", []))
    out = {
        "cold_store": lineage.get("cold_store", ""),
        "segments": len(segs),
        "total_keys": int(lineage.get("total_keys", 0) or 0),
        "total_bytes": int(lineage.get("total_bytes", 0) or 0),
    }
    rows = []
    for s in segs:
        seq = int(s["seq"])
        row = {"seq": seq, "blob": s.get("blob"),
               "bytes": int(s.get("bytes", 0) or 0),
               "keys": s.get("keys", {})}
        row["crc_verdict"] = _cold_seg_verdict(
            lineage.get("cold_store", ""), seq, s.get("crc"))
        rows.append(row)
    out["segment_rows"] = rows
    verdicts = {r["crc_verdict"] for r in rows}
    out["crc_verdict"] = ("ok" if not verdicts or verdicts == {"ok"}
                          else "mismatch" if "mismatch" in verdicts
                          else "missing" if "missing" in verdicts
                          else "unavailable")
    return out


def _cold_seg_verdict(cold_store: str, seq: int, crc) -> str:
    """Best-effort on-disk manifest check for one lineage segment."""
    if not cold_store:
        return "unavailable"
    name = f"seg-{seq:08d}.json"
    try:
        if cold_store.startswith("s3://"):
            from real_time_fraud_detection_system_tpu_torch.io.store import (
                make_store,
            )

            data = _StoreBackend(make_store(cold_store),
                                 prefix="").read(name)
        else:
            data = _LocalBackend(cold_store).read(name)
        man = json.loads(data.decode("utf-8"))
    except KeyError:
        return "missing"
    # read-only forensics: any failure to reach or parse the cold store is
    # a verdict, never a crash
    except Exception:  # noqa: BLE001
        return "unavailable"
    return "ok" if crc is not None and int(man.get("crc", -1)) == \
        int(crc) else "mismatch"
