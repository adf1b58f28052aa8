"""Versioned model registry — port of the JAX package's
``io/registry.py``, the continuous-learning artifact plane.

Every artifact that can ever serve gets:

- a monotonically increasing version (``model-v0000001.npz``), never
  overwritten in place;
- a content hash (sha256 over the artifact bytes, in the side manifest
  ``model-v0000001.json``) verified on every ``get``: a corrupt version is
  quarantined (``stale-<token>-…``) and counted in
  ``rtfds_model_artifact_corrupt_total{reason}``, on top of the artifact's
  own content hash (``io/artifacts.py``, format v1);
- training-window metadata (labels trained on, source, wall time) and its
  lineage (the parent version it was warm-started from).

The champion pointer (``champion.json``) records the serving version and
the promotion history, so ``rollback()`` is one pointer move. The files
are the JAX package's, byte layout and names alike: a registry directory
written by either package opens in the other.

Storage is the checkpoint plane's backends (``io/checkpoint.py``): a local
directory (tmp write + atomic rename) or an object store (``s3://`` or
``file://``, ``io/store.py``) with retries and per-op timeouts. Artifacts load
into host memory (``device="cpu"``); the engine and the shadow scorer move
them to their device.
"""

from __future__ import annotations

import hashlib
import json
import re
import threading
import time
import uuid
from typing import List, Optional

from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    CorruptModelError,
    dump_model_bytes,
    load_model_bytes,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    _LocalBackend,
    _StoreBackend,
)
from real_time_fraud_detection_system_tpu_torch.utils.logging import (
    get_logger,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    active_recorder,
    get_registry,
)

CHAMPION_KEY = "champion.json"
_ENTRY_RE = re.compile(r"^model-v(\d{7})\.json$")

log = get_logger("registry")


def _name_of(version: int, ext: str) -> str:
    return f"model-v{int(version):07d}.{ext}"


class ModelRegistry:
    """Append-only versioned artifacts and an atomic champion pointer.

    Thread-safe: the learner's worker thread publishes while the serving
    loop promotes and reads. Version allocation and the pointer have a
    lock each; the artifact writes run outside both, so a slow store never
    holds up the loop's pointer moves.
    """

    def __init__(self, backend):
        self._backend = backend
        self._alloc_lock = threading.Lock()
        self._ptr_lock = threading.Lock()
        # versions this process handed out whose writes may be in flight;
        # allocation re-lists the backend each time (another process may
        # publish beside this one)
        self._alloc_floor = 0
        reg = get_registry()
        self._m_ops = {
            op: reg.counter("rtfds_model_registry_ops_total",
                            "model registry operations", op=op)
            for op in ("publish", "get", "promote", "rollback")
        }
        self._m_corrupt = {
            r: reg.counter(
                "rtfds_model_artifact_corrupt_total",
                "model artifacts that failed load-time verification",
                reason=r)
            for r in ("checksum", "truncated")
        }
        self._g_version = {
            role: reg.gauge(
                "rtfds_model_version",
                "registry model version by role (champion = serving, "
                "candidate = newest published)", role=role)
            for role in ("champion", "candidate")
        }
        ch = self.champion_version()
        if ch is not None:
            self._g_version["champion"].set(ch)
        vs = self.versions()
        if vs:
            self._g_version["candidate"].set(vs[-1])

    # -- listing ----------------------------------------------------------

    def versions(self) -> List[int]:
        """Live versions, oldest → newest."""
        out = []
        for n in self._backend.list_names():
            m = _ENTRY_RE.match(n)
            if m is not None:
                out.append(int(m.group(1)))
        return sorted(out)

    def meta(self, version: int) -> dict:
        """The side manifest of one version. ``KeyError`` when it does not
        exist; :class:`CorruptModelError` (``truncated``) when its bytes
        do not parse (a torn manifest is corruption the gate refuses)."""
        data = self._backend.read(_name_of(version, "json"))
        try:
            man = json.loads(data.decode())
        except (ValueError, UnicodeDecodeError) as e:
            raise CorruptModelError(
                "truncated",
                f"manifest for v{version} is unreadable "
                f"({type(e).__name__}: {e})") from None
        if not isinstance(man, dict):
            raise CorruptModelError(
                "truncated", f"manifest for v{version} is not an object")
        return man

    # -- publish ----------------------------------------------------------

    def publish(self, model, parent: Optional[int] = None,
                source: str = "learner", labels_trained: int = 0,
                note: str = "") -> int:
        """Serialize and register a new version; returns it. The npz lands
        first and the manifest second: a crash in between leaves an
        unlisted orphan, never a manifest naming missing bytes."""
        data = dump_model_bytes(model)
        sha = hashlib.sha256(data).hexdigest()
        with self._alloc_lock:
            vs = self.versions()
            version = max((vs[-1] + 1) if vs else 1,
                          self._alloc_floor + 1)
            while (self._backend.exists(_name_of(version, "npz"))
                   or self._backend.exists(_name_of(version, "json"))):
                # an orphan npz (a publish mid-write, or a crash between
                # npz and manifest): never reuse its number
                version += 1
            self._alloc_floor = version
        self._backend.write(_name_of(version, "npz"), data)
        manifest = {
            "version": version,
            "kind": model.kind,
            "sha256": sha,
            "size": len(data),
            "created_unix": time.time(),
            "parent": parent,
            "source": source,
            "labels_trained": int(labels_trained),
            "note": note,
        }
        self._backend.write(
            _name_of(version, "json"),
            json.dumps(manifest, sort_keys=True,
                       separators=(",", ":")).encode())
        self._m_ops["publish"].inc()
        self._g_version["candidate"].set(version)
        rec = active_recorder()
        if rec is not None:
            rec.record_event("model_published", version=version,
                             kind=model.kind, parent=parent, source=source,
                             labels_trained=int(labels_trained))
        return version

    # -- verified get -----------------------------------------------------

    def _note_corrupt(self, version: int, err: CorruptModelError) -> None:
        self._m_corrupt[err.reason].inc()
        rec = active_recorder()
        if rec is not None:
            rec.record_event("model_artifact_corrupt", version=version,
                             reason=err.reason, detail=err.detail[:200])
        log.error("corrupt model artifact v%d (%s: %s) — quarantining",
                  version, err.reason, err.detail[:200])
        token = uuid.uuid4().hex[:8]
        for ext in ("npz", "json"):
            name = _name_of(version, ext)
            if self._backend.exists(name):
                self._backend.move(name, f"stale-{token}-{name}")

    @staticmethod
    def _verify_bytes(man: dict, data: bytes):
        """The one verification core: manifest size, manifest sha256,
        then the artifact's own content hash. Raises
        :class:`CorruptModelError`; returns the model on the host."""
        if man.get("size") is not None and len(data) != int(man["size"]):
            raise CorruptModelError(
                "truncated",
                f"artifact is {len(data)} bytes, manifest says "
                f"{man['size']}")
        if hashlib.sha256(data).hexdigest() != man.get("sha256"):
            raise CorruptModelError(
                "checksum", "artifact bytes do not match the "
                "manifest sha256")
        return load_model_bytes(data, device="cpu")

    def get(self, version: int):
        """Load a version as a ``TrainedModel`` on the host, verifying the
        manifest's sha256 and the artifact's content hash; on a mismatch
        the entry is quarantined and :class:`CorruptModelError` raises.
        ``KeyError`` for a version that does not exist."""
        try:
            man = self.meta(version)
        except CorruptModelError as e:
            self._note_corrupt(version, e)
            raise
        try:
            data = self._backend.read(_name_of(version, "npz"))
        except KeyError:
            err = CorruptModelError(
                "truncated", f"artifact bytes for v{version} are missing")
            self._note_corrupt(version, err)
            raise err from None
        try:
            model = self._verify_bytes(man, data)
        except CorruptModelError as e:
            self._note_corrupt(version, e)
            raise
        self._m_ops["get"].inc()
        return model

    # -- champion pointer -------------------------------------------------

    def _read_pointer(self) -> Optional[dict]:
        """The champion pointer, or None when none was ever written. A
        pointer whose bytes do not parse (a torn write) is quarantined,
        counted (``truncated``) and logged before the registry goes on
        pointerless: loud, never silent."""
        try:
            data = self._backend.read(CHAMPION_KEY)
        except KeyError:
            return None
        try:
            ptr = json.loads(data.decode())
            if not isinstance(ptr, dict) or "version" not in ptr:
                raise ValueError("not a pointer object")
            return ptr
        except (ValueError, UnicodeDecodeError) as e:
            self._m_corrupt["truncated"].inc()
            rec = active_recorder()
            if rec is not None:
                rec.record_event("model_pointer_corrupt",
                                 detail=str(e)[:200])
            token = uuid.uuid4().hex[:8]
            stale = f"stale-{token}-{CHAMPION_KEY}"
            try:
                self._backend.move(CHAMPION_KEY, stale)
            # best-effort forensics: the pointerless fallback below is the
            # handling and runs whatever the move raised
            except Exception:  # noqa: BLE001
                stale = "(could not quarantine)"
            log.error(
                "champion pointer is unreadable (%s: %s) — quarantined to "
                "%s; serving falls back to the bootstrap model and the "
                "promotion history is lost (recover it from the "
                "quarantined file)", type(e).__name__, e, stale)
            return None

    def _write_pointer(self, ptr: dict) -> None:
        self._backend.write(
            CHAMPION_KEY,
            json.dumps(ptr, sort_keys=True, separators=(",", ":")).encode())

    def champion_version(self) -> Optional[int]:
        ptr = self._read_pointer()
        return int(ptr["version"]) if ptr else None

    def champion(self):
        """The verified champion model (on the host), or None."""
        v = self.champion_version()
        return self.get(v) if v is not None else None

    def promote(self, version: int, by: str = "controller") -> dict:
        """Move the pointer to ``version`` (which must exist), pushing the
        previous champion on its history. Does NOT verify the bytes: the
        gate calls :meth:`get` first."""
        self.meta(version)  # existence: KeyError on a ghost
        with self._ptr_lock:
            ptr = self._read_pointer() or {"history": []}
            prev = ptr.get("version")
            hist = list(ptr.get("history", []))
            if prev is not None:
                hist.append(int(prev))
            ptr = {"version": int(version), "history": hist,
                   "promoted_unix": time.time(), "by": by}
            self._write_pointer(ptr)
        self._m_ops["promote"].inc()
        self._g_version["champion"].set(version)
        return ptr

    def rollback(self) -> Optional[int]:
        """Pop the pointer back to the previous champion; returns it, or
        None without history. The abandoned champion's artifact stays."""
        with self._ptr_lock:
            ptr = self._read_pointer()
            if not ptr or not ptr.get("history"):
                return None
            hist = list(ptr["history"])
            prev = int(hist.pop())
            self._write_pointer({"version": prev, "history": hist,
                                 "promoted_unix": time.time(),
                                 "by": "rollback"})
        self._m_ops["rollback"].inc()
        self._g_version["champion"].set(prev)
        return prev

    # -- verification -----------------------------------------------------

    def list_versions(self) -> List[dict]:
        """One row per live version (manifests only), champion flagged."""
        ch = self.champion_version()
        out = []
        for v in self.versions():
            try:
                man = self.meta(v)
            except (KeyError, CorruptModelError):
                man = {"version": v, "error": "manifest unreadable"}
            man["role"] = "champion" if v == ch else "candidate"
            out.append(man)
        return out

    def verify_all(self) -> List[dict]:
        """Re-hash every live artifact against its manifest, without
        quarantining or counting (the deploy preflight)."""
        out = []
        ch = self.champion_version()
        for v in self.versions():
            entry = {"version": v,
                     "role": "champion" if v == ch else "candidate"}
            try:
                man = self.meta(v)
                data = self._backend.read(_name_of(v, "npz"))
                self._verify_bytes(man, data)
                entry.update(kind=man.get("kind"), size=man.get("size"),
                             parent=man.get("parent"),
                             source=man.get("source"),
                             labels_trained=man.get("labels_trained"),
                             valid=True)
            except CorruptModelError as e:
                entry.update(valid=False, reason=e.reason,
                             detail=e.detail[:200])
            except KeyError:
                entry.update(valid=False, reason="truncated",
                             detail="artifact or manifest missing")
            out.append(entry)
        return out


def make_model_registry(path_or_url: str, op_timeout_s: float = 0.0,
                        op_attempts: int = 3) -> ModelRegistry:
    """A local directory → a directory-backed registry; ``s3://bucket/
    prefix`` or ``file://dir`` → the store-backed one (retries, per-op
    timeout)."""
    if "://" in path_or_url:
        from real_time_fraud_detection_system_tpu_torch.io.store import (
            make_store,
        )

        return ModelRegistry(
            _StoreBackend(make_store(path_or_url), prefix="",
                          op_timeout_s=op_timeout_s,
                          op_attempts=op_attempts))
    return ModelRegistry(_LocalBackend(path_or_url))
