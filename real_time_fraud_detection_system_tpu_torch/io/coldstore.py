"""Host cold tier of the exact feature store: demote, don't discard —
port of the JAX package's ``io/coldstore.py``, over the port's
checkpoint storage backends (``io/checkpoint.py``, ``io/store.py``).

Recency compaction under pressure demotes the oldest keys' window rows
(``features/online.py::compact_feature_state``); this module keeps them on
the host, and a promoter thread reads a returning key's rows back so the
engine can merge them between steps (``promote_rows``).

The files are the JAX package's, so a store written by either package
opens in the other: demoted rows buffer in memory and flush as immutable
segments, a blob ``seg-<seq>.npz`` (per table ``{t}_keys`` u32 [n],
``{t}_bd`` i32 [n, NB], ``{t}_cnt/amt/frd`` f32 [n, NB]) written first,
then a JSON manifest ``seg-<seq>.json`` as the commit point: ``{"format",
"seq", "blob", "crc", "bytes", "keys": {table: [...]}}``. The manifests
hold the key lists, so :class:`ColdStore` rebuilds its index from them
alone; an orphan blob (a crash between the two writes) is deleted on
open, and a torn manifest is quarantined, never trusted.

The contracts:

- **Newest wins.** A key demoted twice resolves to its newest rows.
- **Reads verify.** ``get_rows`` checks a segment's CRC32 before serving
  from it; a mismatch quarantines the segment, drops its keys and raises
  :class:`ColdStoreCorruptError` (the keys then serve from the sketch).
- **Checkpoint lineage = live segments.** :meth:`ColdStore.lineage` lists
  the segments that still hold un-promoted keys; :meth:`ColdStore.sync_to`
  (restore) deletes every other one (replay writes them again).
- **The promoter is bounded and fenced**: a full request queue drops the
  request (the key asks again on its next touch); a worker error
  re-raises with its own type on the loop thread; :meth:`ColdPromoter.reset`
  fences the generation across a restore; a corrupt segment is isolated
  per key. A store handle can itself be fenced
  (:meth:`ColdStore.fence`): the recovery supervisor does so for an
  incarnation it abandons, so a zombie never writes under its successor.

- **Fleet resizes**: :meth:`ColdStore.rehome` unindexes the keys a
  process no longer owns after a topology change, and
  :func:`consolidate_cold_stores` merges the live rows of several
  per-process stores into one fresh store (the cold half of a shrink
  merge).
"""

from __future__ import annotations

import io as _io
import json
import os
import queue
import threading
import time
import zlib
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    _LocalBackend,
    _StoreBackend,
)
from real_time_fraud_detection_system_tpu_torch.io.store import make_store
from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)

SEG_FORMAT = 1
_EMPTY_KEY = 0xFFFFFFFF


class ColdStoreCorruptError(Exception):
    """A cold segment failed CRC/parse verification (quarantined)."""


class ColdStoreFencedError(RuntimeError):
    """A write through a store handle that was fenced off (its engine's
    incarnation was abandoned or crashed; a newer one owns the store)."""


def _seg_blob(seq: int) -> str:
    return f"seg-{seq:08d}.npz"


def _seg_manifest(seq: int) -> str:
    return f"seg-{seq:08d}.json"


class ColdStore:
    """Append+compact keyed store over the checkpoint storage backends
    (``_LocalBackend``/``_StoreBackend`` — flaky-store retries and the
    atomic tmp+rename / atomic-PUT write discipline are inherited)."""

    def __init__(self, path_or_url: str, segment_mb: float = 4.0):
        self.path = path_or_url
        if path_or_url.startswith("s3://"):
            self._backend = _StoreBackend(make_store(path_or_url),
                                          prefix="")
        else:
            self._backend = _LocalBackend(path_or_url)
        self._segment_bytes = max(1, int(segment_mb * (1 << 20)))
        self._lock = threading.RLock()
        # (table, key) -> (seq, row) for flushed rows; (None, key) for
        # rows still sitting in the flush buffer. Newest location wins.
        self._index: Dict[Tuple[str, int], Tuple[Optional[int], int]] = {}
        self._seg_meta: Dict[int, dict] = {}  # seq -> manifest dict
        self._buf: Dict[str, "OrderedDict"] = {}  # table -> key -> row
        self._buf_bytes = 0
        self._next_seq = 0
        self._cache: "OrderedDict" = OrderedDict()  # seq -> arrays (LRU)
        self._cache_depth = 4
        self._fenced = False
        self._open()

    # -- open / crash hygiene -------------------------------------------

    def _log(self):
        return get_logger("coldstore")

    def _open(self) -> None:
        """Rebuild the key index from segment MANIFESTS alone (no blob
        reads). Torn manifests are quarantined; orphan blobs (crash
        between blob write and manifest commit) and orphan tmps are
        deleted — they are by definition uncommitted."""
        names = self._backend.list_names()
        for n in names:
            if n.startswith("seg-") and n.endswith(".tmp"):
                self._backend.delete(n)
        blobs = {n for n in names
                 if n.startswith("seg-") and n.endswith(".npz")}
        for n in sorted(names):
            if not (n.startswith("seg-") and n.endswith(".json")):
                continue
            try:
                man = json.loads(self._backend.read(n).decode("utf-8"))
                seq = int(man["seq"])
                blob = str(man["blob"])
                int(man["crc"])
                keys = {t: [int(k) for k in ks]
                        for t, ks in dict(man["keys"]).items()}
            # crash-safe re-open: any unparsable manifest is quarantined
            except Exception:
                self._quarantine_name(n)
                continue
            if blob not in blobs:
                # manifest without its blob: a deleted/torn blob —
                # quarantine the manifest, keys degrade to CMS honestly
                self._quarantine_name(n)
                continue
            self._seg_meta[seq] = man
            for table, ks in keys.items():
                for row, k in enumerate(ks):
                    self._index[(table, k)] = (seq, row)
            self._next_seq = max(self._next_seq, seq + 1)
        committed = {m["blob"] for m in self._seg_meta.values()}
        for b in blobs:
            if b not in committed:
                self._backend.delete(b)  # orphan blob: never committed

    def fence(self) -> None:
        """Refuse every further write through this handle: the recovery
        supervisor fences the store of an incarnation it gave up on, so
        a zombie never writes under the next incarnation's store."""
        with self._lock:
            self._fenced = True

    def _check_fence(self) -> None:
        if self._fenced:
            raise ColdStoreFencedError(
                f"cold store {self.path} was fenced off: its engine's "
                f"incarnation was abandoned")

    def _quarantine_name(self, name: str) -> None:
        self._check_fence()
        try:
            self._backend.move(name, "quarantine-" + name)
        except (OSError, KeyError):
            self._backend.delete(name)

    # -- append (loop thread: compaction demotions) ---------------------

    def append(self, table: str, keys, bd, cnt, amt, frd) -> int:
        """Buffer demoted rows (``EMPTY_KEY`` lanes skipped); flush a
        segment once the buffer crosses the segment threshold. Returns
        the number of rows actually appended."""
        keys = np.asarray(keys, dtype=np.uint32)
        bd = np.asarray(bd, dtype=np.int32)
        cnt = np.asarray(cnt, dtype=np.float32)
        amt = np.asarray(amt, dtype=np.float32)
        frd = np.asarray(frd, dtype=np.float32)
        nb = bd.shape[1] if bd.ndim == 2 else 0
        row_bytes = 4 + 16 * nb
        n = 0
        with self._lock:
            self._check_fence()
            buf = self._buf.setdefault(table, OrderedDict())
            for i in range(keys.shape[0]):
                k = int(keys[i])
                if k == _EMPTY_KEY:
                    continue
                if k not in buf:
                    self._buf_bytes += row_bytes
                buf[k] = (bd[i], cnt[i], amt[i], frd[i])
                self._index[(table, k)] = (None, k)
                n += 1
            if self._buf_bytes >= self._segment_bytes:
                self._flush_locked()
        return n

    def flush(self) -> Optional[int]:
        """Flush buffered rows as a committed segment (checkpoint save
        calls this so the lineage it records is durable). Returns the
        new segment's seq, or None when the buffer was empty."""
        with self._lock:
            return self._flush_locked()

    def _flush_locked(self) -> Optional[int]:
        self._check_fence()
        if not any(self._buf.values()):
            return None
        seq = self._next_seq
        arrays = {}
        man_keys: Dict[str, List[int]] = {}
        for table, rows in self._buf.items():
            if not rows:
                continue
            ks = list(rows.keys())
            man_keys[table] = ks
            arrays[f"{table}_keys"] = np.array(ks, dtype=np.uint32)
            arrays[f"{table}_bd"] = np.stack([rows[k][0] for k in ks])
            arrays[f"{table}_cnt"] = np.stack([rows[k][1] for k in ks])
            arrays[f"{table}_amt"] = np.stack([rows[k][2] for k in ks])
            arrays[f"{table}_frd"] = np.stack([rows[k][3] for k in ks])
        bio = _io.BytesIO()
        np.savez(bio, **arrays)
        data = bio.getvalue()
        man = {
            "format": SEG_FORMAT,
            "seq": seq,
            "blob": _seg_blob(seq),
            "crc": zlib.crc32(data) & 0xFFFFFFFF,
            "bytes": len(data),
            "keys": man_keys,
        }
        # Blob FIRST, manifest as the commit point: a crash between the
        # two leaves an orphan blob that open() deletes.
        self._backend.write(_seg_blob(seq), data)
        self._backend.write(
            _seg_manifest(seq),
            json.dumps(man, sort_keys=True).encode("utf-8"))
        self._next_seq = seq + 1
        self._seg_meta[seq] = man
        for table, ks in man_keys.items():
            for row, k in enumerate(ks):
                loc = self._index.get((table, k))
                if loc is not None and loc[0] is None:
                    self._index[(table, k)] = (seq, row)
        self._buf = {}
        self._buf_bytes = 0
        return seq

    # -- reads (promoter thread) ----------------------------------------

    def _load_segment(self, seq: int) -> dict:
        with self._lock:
            if seq in self._cache:
                self._cache.move_to_end(seq)
                return self._cache[seq]
            man = self._seg_meta.get(seq)
        if man is None:
            raise ColdStoreCorruptError(f"segment {seq} unknown")
        try:
            data = self._backend.read(man["blob"])
        except KeyError:
            self._drop_segment(seq, quarantine=True)
            raise ColdStoreCorruptError(
                f"segment {seq} blob missing") from None
        if (zlib.crc32(data) & 0xFFFFFFFF) != int(man["crc"]):
            self._drop_segment(seq, quarantine=True)
            raise ColdStoreCorruptError(
                f"segment {seq} CRC mismatch (byte corruption)")
        try:
            with np.load(_io.BytesIO(data)) as z:
                arrays = {k: z[k] for k in z.files}
        # a CRC-valid but unparsable blob is poison all the same
        except Exception:
            self._drop_segment(seq, quarantine=True)
            raise ColdStoreCorruptError(
                f"segment {seq} blob unparsable") from None
        with self._lock:
            self._cache[seq] = arrays
            while len(self._cache) > self._cache_depth:
                self._cache.popitem(last=False)
        return arrays

    def get_rows(self, table: str, keys: Sequence[int]) -> dict:
        """Resolve ``keys`` to their newest cold rows. Missing keys are
        simply absent from the result; a corrupt segment raises
        :class:`ColdStoreCorruptError` after quarantining itself."""
        with self._lock:
            locs = {int(k): self._index.get((table, int(k)))
                    for k in keys}
        out = {}
        for k, loc in locs.items():
            if loc is None:
                continue
            seq, row = loc
            if seq is None:
                with self._lock:
                    r = self._buf.get(table, {}).get(k)
                if r is not None:
                    out[k] = r
                continue
            arrays = self._load_segment(seq)
            out[k] = (
                arrays[f"{table}_bd"][row],
                arrays[f"{table}_cnt"][row],
                arrays[f"{table}_amt"][row],
                arrays[f"{table}_frd"][row],
            )
        return out

    def contains(self, table: str, key: int) -> bool:
        with self._lock:
            return (table, int(key)) in self._index

    def index_snapshot(self, table: str) -> np.ndarray:
        """Sorted u32 array of this table's cold keys — the host-side
        membership set the engine intersects batches against
        (``np.isin``). Rebuilt by the caller when :meth:`version`
        changes (append/promotion/quarantine), not per batch."""
        with self._lock:
            ks = [k for (t, k) in self._index if t == table]
        return np.sort(np.asarray(ks, dtype=np.uint32))

    def version(self) -> int:
        """Monotonic-ish index mutation stamp for snapshot caching."""
        with self._lock:
            return len(self._index) + (self._next_seq << 32)

    # -- promotion / retention ------------------------------------------

    def mark_promoted(self, table: str, keys: Sequence[int]) -> None:
        """A key's rows landed back in the hot tier: drop its index
        entry (stops re-detection; segment bytes stay until gc)."""
        with self._lock:
            self._check_fence()
            for k in keys:
                loc = self._index.pop((table, int(k)), None)
                if loc is not None and loc[0] is None:
                    self._buf.get(table, {}).pop(int(k), None)

    def gc(self) -> List[int]:
        """Delete segments with zero live index entries. Call AFTER a
        checkpoint save: the just-recorded lineage lists only live
        segments, so nothing the newest checkpoint can need is removed
        (an *older* checkpoint restored over a gc'd store degrades those
        keys to CMS honestly, with a warning from :meth:`sync_to`)."""
        with self._lock:
            self._check_fence()
            live = {loc[0] for loc in self._index.values()
                    if loc[0] is not None}
            dead = [s for s in self._seg_meta if s not in live]
            for seq in dead:
                self._drop_segment(seq, quarantine=False)
            return dead

    def _drop_segment(self, seq: int, quarantine: bool) -> None:
        with self._lock:
            man = self._seg_meta.pop(seq, None)
            self._cache.pop(seq, None)
            for key in [key for key, loc in self._index.items()
                        if loc[0] == seq]:
                del self._index[key]
        if man is None:
            return
        if quarantine:
            self._quarantine_name(man["blob"])
            self._quarantine_name(_seg_manifest(seq))
        else:
            self._backend.delete(man["blob"])
            self._backend.delete(_seg_manifest(seq))

    # -- checkpoint lineage ---------------------------------------------

    def lineage(self) -> dict:
        """LIVE-segment lineage for the checkpoint meta (call after
        :meth:`flush`). Per segment: seq/blob/crc/bytes + per-table key
        COUNTS (the full key lists live in the on-disk manifests)."""
        with self._lock:
            live = {loc[0] for loc in self._index.values()
                    if loc[0] is not None}
            segs = []
            for seq in sorted(self._seg_meta):
                if seq not in live:
                    continue
                man = self._seg_meta[seq]
                segs.append({
                    "seq": seq,
                    "blob": man["blob"],
                    "crc": int(man["crc"]),
                    "bytes": int(man["bytes"]),
                    "keys": {t: len(ks)
                             for t, ks in man["keys"].items()},
                })
            return {
                "cold_store": self.path,
                "segments": segs,
                "total_keys": len(self._index),
                "total_bytes": sum(s["bytes"] for s in segs),
            }

    def sync_to(self, lineage: Optional[dict]) -> None:
        """Adopt a restored checkpoint's cold lineage: segments the
        checkpoint does not list are deleted (post-checkpoint demotions
        — replay regenerates them exactly-once; fully-promoted ones are
        covered by the checkpointed hot state), listed-but-missing
        segments warn (their keys serve from CMS honestly), and the
        flush buffer is dropped (its rows post-date the checkpoint)."""
        listed = {int(s["seq"]): s
                  for s in (lineage or {}).get("segments", [])}
        with self._lock:
            self._check_fence()
            for seq in [s for s in self._seg_meta if s not in listed]:
                self._drop_segment(seq, quarantine=False)
            for key in [key for key, loc in self._index.items()
                        if loc[0] is None]:
                del self._index[key]
            self._buf = {}
            self._buf_bytes = 0
            missing = [s for s in listed if s not in self._seg_meta]
            top = max(list(listed) + list(self._seg_meta), default=-1)
            self._next_seq = max(self._next_seq, top + 1)
        if missing:
            self._log().warning(
                "cold-tier lineage lists segment(s) %s that are missing "
                "from %s — their keys will serve from the CMS sketch "
                "(exactness degraded, counted) instead of promoting",
                missing, self.path)

    def rehome(self, owned_fn) -> int:
        """Unindex the keys this process no longer owns after a topology
        change (a fleet resize's restore). ``owned_fn(table, keys_u32) ->
        bool mask`` is the NEW topology's ownership; the segment bytes of
        the keys dropped stay until :meth:`gc`, their buffered rows are
        discarded (the owning process promotes them from its own store).
        Returns the number of keys dropped."""
        dropped = 0
        with self._lock:
            tables = sorted({t for (t, _k) in self._index})
            for table in tables:
                ks = np.asarray(
                    [k for (t, k) in self._index if t == table],
                    dtype=np.uint32)
                if not ks.size:
                    continue
                mine = np.asarray(owned_fn(table, ks), dtype=bool)
                for k in ks[~mine]:
                    loc = self._index.pop((table, int(k)), None)
                    if loc is not None and loc[0] is None:
                        self._buf.get(table, {}).pop(int(k), None)
                dropped += int((~mine).sum())
        return dropped

    # -- gauges ----------------------------------------------------------

    @property
    def keys_count(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def bytes(self) -> int:
        with self._lock:
            live = {loc[0] for loc in self._index.values()
                    if loc[0] is not None}
            seg = sum(int(m["bytes"]) for s, m in self._seg_meta.items()
                      if s in live)
            return seg + self._buf_bytes


def consolidate_cold_stores(src_paths: Sequence[str], dest_path: str,
                            segment_mb: float = 4.0) -> ColdStore:
    """Merge the live rows of several per-process cold stores into one
    fresh store: the cold half of a fleet-shrink merge. Each source is
    read through its committed index (the newest row per key) and
    appended into ``dest_path`` in sorted-key order per table, then
    flushed; ownership makes the sources' key sets disjoint, and a
    corrupt source segment degrades as at serve time (quarantined, its
    keys fall back to the sketch). Returns the opened destination."""
    dest = ColdStore(dest_path, segment_mb=segment_mb)
    for src_path in src_paths:
        if os.path.abspath(src_path) == os.path.abspath(dest_path):
            raise ValueError(
                f"cold consolidation destination {dest_path} is also a "
                "source — merge into a fresh generation directory")
        src = ColdStore(src_path, segment_mb=segment_mb)
        with src._lock:
            tables = sorted({t for (t, _k) in src._index})
        for table in tables:
            ks = src.index_snapshot(table)
            rows = None
            # a corrupt segment quarantines itself on first touch, so one
            # more attempt per segment always ends
            for _ in range(len(src._seg_meta) + 1):
                try:
                    rows = src.get_rows(table, ks)
                    break
                except ColdStoreCorruptError:
                    continue
            if not rows:
                continue
            kept = np.asarray(sorted(rows), dtype=np.uint32)
            dest.append(
                table, kept,
                np.stack([rows[int(k)][0] for k in kept]),
                np.stack([rows[int(k)][1] for k in kept]),
                np.stack([rows[int(k)][2] for k in kept]),
                np.stack([rows[int(k)][3] for k in kept]))
    dest.flush()
    return dest


class _Err:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class ColdPromoter:
    """Background cold→hot promotion reader: the loop thread enqueues
    returning keys, the worker resolves their rows from the :class:`ColdStore`
    off-thread, and the loop drains ready rows between device steps.

    - the request queue is BOUNDED (``maxsize=depth``): a full queue
      drops the request (``request()`` → False) and the key re-enqueues
      on its next touch — backpressure, never unbounded host growth;
    - worker errors ship to the loop thread and re-raise with their
      ORIGINAL type from :meth:`poll_ready`;
    - :meth:`reset` fences the generation across checkpoint restore
      (fresh stop-event + queues; a worker wedged in a hung store read
      is abandoned with its orphaned queues);
    - a corrupt segment is POISON-ISOLATED per key: the store
      quarantines it, the worker counts the skip and the key surfaces
      with ``rows=None`` so the engine clears it from pending (served
      from CMS honestly) instead of wedging the promotion pipeline.
    """

    def __init__(self, store: ColdStore, depth: int = 64):
        self.store = store
        self.depth = max(1, int(depth))
        self.corrupt_skipped = 0
        self._gen = 0
        self._stop = threading.Event()
        self._req: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._ready: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._thread: Optional[threading.Thread] = None
        self._start_worker()

    def _start_worker(self) -> None:
        self._stop = threading.Event()
        self._req = queue.Queue(maxsize=self.depth)
        self._ready = queue.Queue(maxsize=self.depth)
        self._thread = threading.Thread(
            target=self._work,
            args=(self._stop, self._gen, self._req, self._ready),
            daemon=True, name="cold-promoter")
        self._thread.start()

    def _work(self, stop: threading.Event, gen: int, req: "queue.Queue",
              ready: "queue.Queue") -> None:
        def put(item) -> bool:
            # bounded put that a generation fence can interrupt
            while not stop.is_set():
                try:
                    ready.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        while not stop.is_set():
            try:
                g, table, key, t_enq = req.get(timeout=0.1)
            except queue.Empty:
                continue
            if g != gen:
                continue  # stale generation: fenced request
            try:
                rows = self.store.get_rows(table, [key]).get(int(key))
            except ColdStoreCorruptError:
                # poison isolation: the store quarantined the segment;
                # surface the key with no rows so pending clears and it
                # degrades to CMS honestly
                self.corrupt_skipped += 1
                rows = None
            # the thread boundary: the original exception crosses to the
            # loop thread, which re-raises it from poll_ready
            except BaseException as e:
                put(_Err(e))
                return
            if not put((table, int(key), rows, t_enq)):
                return

    # -- loop thread ------------------------------------------------------

    def request(self, table: str, key: int) -> bool:
        """Enqueue a returning key for promotion. Non-blocking: returns
        False on a full queue (the key re-enqueues on its next touch)."""
        try:
            self._req.put_nowait(
                (self._gen, table, int(key), time.perf_counter()))
            return True
        except queue.Full:
            return False

    def poll_ready(self, max_items: int = 64) -> list:
        """Drain up to ``max_items`` resolved promotions without
        blocking: ``[(table, key, rows|None, t_enq), ...]``. Re-raises a
        worker-side failure with its original type."""
        out = []
        while len(out) < max_items:
            try:
                item = self._ready.get_nowait()
            except queue.Empty:
                break
            if isinstance(item, _Err):
                raise item.exc
            out.append(item)
        return out

    def backlog(self) -> int:
        """Keys enqueued or resolved but not yet landed on device."""
        return self._req.qsize() + self._ready.qsize()

    def reset(self) -> None:
        """Generation fence (checkpoint restore): stop the worker,
        orphan its queues, start a fresh generation. In-flight requests
        and un-landed ready rows are discarded — the restored engine
        re-detects returning keys against the synced cold index."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
            if t.is_alive():
                get_logger("coldstore").warning(
                    "cold promoter did not exit within 5s (store read "
                    "wedged); abandoning it — its late results land in "
                    "an orphaned queue nothing reads")
        self._gen += 1
        self._start_worker()

    def close(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
