"""Model artifacts — port of the JAX package's ``io/artifacts.py``: the
pickle-free ``.npz`` format v1, for the kinds the port serves.

An artifact is an ``.npz`` of plain arrays plus a JSON header
(``__meta__``). Format v1 stamps a content hash (sha256 over the kind
metadata and each array's key, shape, dtype and bytes, in sorted key
order); the loader recomputes it over what it read and raises
:class:`CorruptModelError` on a mismatch. The hash is computed exactly as
the JAX package computes it, so an artifact that its ``rtfds train``
writes loads here with the same ``content_sha256``, and one written here
loads there. v0 artifacts (no hash) load on the zip layer's own entry
CRCs.

Kinds: ``logreg`` (w, b), ``mlp`` (``w{i}``/``b{i}`` and ``n_layers``),
``tree`` and ``forest`` (the flat node tables), ``gbt`` (the node tables
and ``base_score``), ``autoencoder`` (the mlp's layout and
``err_scale``), ``sequence`` (the dims in ``meta["seq"]`` and the leaves
``seq{i}`` in the JAX flatten order: ``embed_w``, ``embed_b``, each
block's 12 fields in order, ``lnf_g``, ``lnf_b``, ``head_w``,
``head_b``). :meth:`TrainedModel.predict_proba` scores raw feature rows
on the params' device (tree kinds through the leaf-sum kernel where it
admits the ensemble) and :meth:`TrainedModel.predict_proba_np` on the
host in NumPy (``score --scorer cpu``). :func:`save_model` and
:func:`load_model` take a local path (written to a temporary name and
renamed into place) or an ``s3://bucket/key`` URL (``io/store.py``);
:func:`upload_model` and :func:`download_model` go through any store, the
download tolerating a missing key as the reference's scorer does. A load
that fails verification counts ``rtfds_model_artifact_corrupt_total
{reason}``. :func:`save_transactions` and :func:`load_transactions` read
and write the transactions tables of ``rtfds datagen``.
"""

from __future__ import annotations

import hashlib
import io as _io
import json
import os
import uuid
import zipfile
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.spec import (
    N_FEATURES,
)
from real_time_fraud_detection_system_tpu_torch.models.autoencoder import (
    AutoencoderParams,
    autoencoder_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    TreeEnsemble,
    for_device,
    resolve_z_mode,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    predict_proba as forest_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.gbt import (
    GBTModel,
    gbt_for_device,
    gbt_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
    logreg_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.mlp import (
    mlp_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    init_transformer,
)
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    leaf_sum_proba,
    leaf_sum_tables,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

ARTIFACT_FORMAT = 1

ARTIFACT_CORRUPT_REASONS = ("checksum", "truncated")

_KINDS = ("logreg", "mlp", "tree", "forest", "gbt", "autoencoder",
          "sequence")
_TREE_FIELDS = ("feat", "thresh", "left", "right", "prob")


class CorruptModelError(Exception):
    """A model artifact failed load-time verification.

    ``reason`` is ``checksum`` (bytes present but the content hash does
    not match what the writer stamped — bit-flip, tampering) or
    ``truncated`` (bytes missing/unreadable — torn write, partial PUT).
    """

    def __init__(self, reason: str, detail: str = ""):
        if reason not in ARTIFACT_CORRUPT_REASONS:
            raise ValueError(f"unknown corruption reason {reason!r}")
        self.reason = reason
        self.detail = detail
        super().__init__(f"{reason}: {detail}" if detail else reason)


@dataclass(frozen=True)
class TrainedModel:
    """Scaler + classifier params, ready for ``ScoringEngine``.
    ``content_sha256`` is the hash a loaded v1 artifact was verified
    against (None for v0 artifacts and unsaved models)."""

    kind: str
    scaler: Scaler
    # LogRegParams | MLPParams | TreeEnsemble | GBTModel |
    # AutoencoderParams | TransformerParams
    params: object
    content_sha256: Optional[str] = None

    def _device_route(self):
        """The tree kinds' device form, derived once and cached on the
        (frozen) instance: ``(params, tables)``, the params in the GEMM
        form where their depth allows it (``for_device``) and the
        leaf-sum kernel's tables where it admits them
        (``ops/forest_kernels.py::leaf_sum_tables``), else None."""
        cached = getattr(self, "_dev_cache", None)
        if cached is None:
            params = (gbt_for_device(self.params, N_FEATURES)
                      if self.kind == "gbt"
                      else for_device(self.params, N_FEATURES))
            dev = self.scaler.mean.device
            cached = (params, leaf_sum_tables(params,
                                              resolve_z_mode(None, dev)))
            object.__setattr__(self, "_dev_cache", cached)
        return cached

    @torch.no_grad()
    def predict_proba(self, features: np.ndarray) -> np.ndarray:
        """Fraud probabilities of RAW feature rows [B, 15], computed on the
        params' device: scaler, then the kind's predict. Tree kinds go
        through the leaf-sum kernel (``ops/forest_kernels.py::leaf_sum``;
        on CPU tensors its plain version) where it admits the ensemble,
        by the rule the engine and the shadow scorer use."""
        dev = self.scaler.mean.device
        x = transform(self.scaler, torch.as_tensor(
            np.asarray(features, dtype=np.float32), device=dev))
        if self.kind == "logreg":
            p = logreg_predict_proba(self.params, x)
        elif self.kind == "mlp":
            p = mlp_predict_proba(self.params, x)
        elif self.kind == "autoencoder":
            p = autoencoder_predict_proba(self.params, x)
        elif self.kind in ("tree", "forest", "gbt"):
            params, tables = self._device_route()
            base = params.base_score if self.kind == "gbt" else None
            if tables is not None:
                p = leaf_sum_proba(tables, x, base)
            elif self.kind == "gbt":
                p = gbt_predict_proba(params, x)
            else:
                p = forest_predict_proba(params, x)
        else:
            raise ValueError(
                f"model kind {self.kind!r} has no feature-row predict (the "
                "sequence kind reads raw event histories)")
        return p.cpu().numpy()

    def _np_params(self):
        """The params and the scaler as host NumPy arrays, converted once
        and cached on the (frozen) instance."""
        cached = getattr(self, "_np_cache", None)
        if cached is None:
            if self.kind == "logreg":
                cached = (_np(self.params.w), float(self.params.b))
            elif self.kind == "mlp":
                cached = [(_np(w), _np(b)) for w, b in self.params]
            elif self.kind == "autoencoder":
                cached = ([(_np(w), _np(b)) for w, b in self.params.layers],
                          float(self.params.err_scale))
            elif self.kind in ("tree", "forest", "gbt"):
                trees = self.params.trees if self.kind == "gbt" \
                    else self.params
                cached = {f: _np(getattr(trees, f)) for f in _TREE_FIELDS}
                cached["max_depth"] = int(trees.max_depth)
                cached["base"] = (float(self.params.base_score)
                                  if self.kind == "gbt" else 0.0)
            else:
                raise ValueError(
                    f"model kind {self.kind!r} has no host scorer (the "
                    "sequence kind reads raw event histories)")
            object.__setattr__(self, "_np_cache", cached)
        scaler = getattr(self, "_np_scaler", None)
        if scaler is None:
            scaler = (_np(self.scaler.mean), _np(self.scaler.scale))
            object.__setattr__(self, "_np_scaler", scaler)
        return cached, scaler

    def predict_proba_np(self, features: np.ndarray) -> np.ndarray:
        """Pure-NumPy host scoring of RAW feature rows — the
        ``--scorer cpu`` oracle (the reference's ``scaler.transform`` +
        ``predict_proba`` on the CPU). The JAX package's function, in its
        operation order, for every kind but the sequence kind."""
        params, (mean, scale) = self._np_params()
        x = ((features.astype(np.float32) - mean) / scale).astype(np.float32)
        if self.kind == "logreg":
            w, b = params
            z = x @ w + b
            return 1.0 / (1.0 + np.exp(-z))
        if self.kind == "mlp":
            h = x
            for w, b in params[:-1]:
                h = np.maximum(h @ w + b, 0.0)
            w, b = params[-1]
            z = (h @ w + b)[:, 0]
            return 1.0 / (1.0 + np.exp(-z))
        if self.kind == "autoencoder":
            layers, err_scale = params
            h = x
            for w, b in layers[:-1]:
                h = np.maximum(h @ w + b, 0.0)
            w, b = layers[-1]
            err = np.mean((h @ w + b - x) ** 2, axis=1)
            return 1.0 - np.exp(-err / max(err_scale, 1e-12))
        feat, thresh = params["feat"], params["thresh"]
        left, right, prob = params["left"], params["right"], params["prob"]
        t = feat.shape[0]
        b_ = x.shape[0]
        node = np.zeros((b_, t), dtype=np.int64)
        tree_idx = np.arange(t)[None, :]
        for _ in range(params["max_depth"]):
            f = feat[tree_idx, node]
            xv = np.take_along_axis(x, f.reshape(b_, -1),
                                    axis=1).reshape(b_, t)
            go_left = xv <= thresh[tree_idx, node]
            node = np.where(go_left, left[tree_idx, node],
                            right[tree_idx, node])
        leaves = prob[tree_idx, node]
        if self.kind == "gbt":
            z = params["base"] + leaves.sum(axis=1)
            return 1.0 / (1.0 + np.exp(-z))
        return leaves.mean(axis=1)


def _require_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise ValueError(f"unknown model kind {kind!r}")


def _corrupt_from_badzip(e: zipfile.BadZipFile) -> CorruptModelError:
    """An entry CRC mismatch is bit-rot (``checksum``); anything else —
    bad magic, short central directory — is missing bytes
    (``truncated``)."""
    reason = "checksum" if "CRC-32" in str(e) else "truncated"
    return CorruptModelError(reason, str(e))


def _content_sha256(meta: dict, arrays: dict) -> str:
    """Content hash over the kind metadata (minus the hash and format
    fields) and each array's key, shape, dtype and raw bytes, in sorted
    key order — byte for byte the JAX package's."""
    h = hashlib.sha256()
    clean = {k: v for k, v in sorted(meta.items())
             if k not in ("content_sha256", "format")}
    h.update(json.dumps(clean, sort_keys=True,
                        separators=(",", ":")).encode())
    for k in sorted(arrays):
        a = np.ascontiguousarray(arrays[k])
        h.update(k.encode())
        h.update(str(a.shape).encode())
        h.update(str(a.dtype).encode())
        h.update(memoryview(a).cast("B"))
    return h.hexdigest()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def dump_model_bytes(model: TrainedModel) -> bytes:
    """Serialize a model to npz bytes (format v1, pickle-free). Tree kinds
    are written from their node tables (:class:`TreeEnsemble`), as the
    JAX package writes them."""
    _require_kind(model.kind)
    arrays = {"scaler_mean": _np(model.scaler.mean),
              "scaler_scale": _np(model.scaler.scale)}
    meta = {"kind": model.kind}
    p = model.params
    if model.kind == "logreg":
        arrays["w"] = _np(p.w)
        arrays["b"] = _np(p.b)
    elif model.kind in ("mlp", "autoencoder"):
        layers = p if model.kind == "mlp" else p.layers
        meta["n_layers"] = len(layers)
        if model.kind == "autoencoder":
            arrays["err_scale"] = _np(p.err_scale)
        for i, (w, b) in enumerate(layers):
            arrays[f"w{i}"] = _np(w)
            arrays[f"b{i}"] = _np(b)
    elif model.kind == "sequence":
        blk = p.blocks[0]
        meta["seq"] = {
            "d_model": int(p.embed_w.shape[1]),
            "n_in": int(p.embed_w.shape[0]),
            "n_heads": int(blk.wq.shape[1]),
            "n_layers": len(p.blocks),
            "d_ff": int(blk.w1.shape[1]),
        }
        # the leaves in the JAX flatten order; the loader rebuilds the
        # structure from a skeleton of the same dims
        for i, leaf in enumerate(tree.leaves(p)):
            arrays[f"seq{i}"] = _np(leaf)
    else:
        trees = p.trees if model.kind == "gbt" else p
        if not isinstance(trees, TreeEnsemble):
            raise ValueError("tree kinds are written from their node tables "
                             f"(TreeEnsemble), got {type(trees).__name__}")
        meta["max_depth"] = int(trees.max_depth)
        if model.kind == "gbt":
            arrays["base_score"] = _np(p.base_score)
        for f in _TREE_FIELDS:
            arrays[f] = _np(getattr(trees, f))
    meta["format"] = ARTIFACT_FORMAT
    meta["content_sha256"] = _content_sha256(meta, arrays)
    buf = _io.BytesIO()
    np.savez(buf, __meta__=json.dumps(meta), **arrays)
    return buf.getvalue()


def _split_s3_url(path: str):
    """``s3://bucket/some/key`` → ``("s3://bucket/some", "key")``; a URL
    without a bucket or an object name raises ValueError."""
    bucket, _, key = path[len("s3://"):].partition("/")
    if not bucket or not key or key.endswith("/"):
        raise ValueError(
            f"object-store URL needs s3://<bucket>/<key>, got {path!r}")
    url, _, name = path.rpartition("/")
    return url, name


def save_model(path: str, model: TrainedModel) -> None:
    """Write ``model`` (format v1) to a local ``path`` — the bytes go to
    ``path + ".tmp"`` and are renamed into place, so a reader never sees
    a torn file — or to an ``s3://`` URL (one atomic PUT)."""
    if path.startswith("s3://"):
        from real_time_fraud_detection_system_tpu_torch.io.store import (
            make_store,
        )

        url, key = _split_s3_url(path)  # validate before serializing
        make_store(url).put(key, dump_model_bytes(model))
        return
    data = dump_model_bytes(model)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def load_model_bytes(data: bytes, device=None) -> TrainedModel:
    """Parse and verify artifact bytes into a model on ``device`` (None =
    CUDA). Raises :class:`CorruptModelError` (``truncated`` for unreadable
    bytes, ``checksum`` when the stamped content hash does not match what
    was read)."""
    device = resolve_device(device)
    try:
        with np.load(_io.BytesIO(data), allow_pickle=False) as z:
            return _load_model_npz(z, device)
    except zipfile.BadZipFile as e:
        raise _corrupt_from_badzip(e) from None


def _quarantine_artifact(path: str) -> str:
    """Rename a corrupt local artifact to ``stale-<id>-<name>`` beside it
    (never delete: the bytes are forensics); return the new path."""
    d, base = os.path.split(path)
    stale = os.path.join(d, f"stale-{uuid.uuid4().hex[:8]}-{base}")
    try:
        os.replace(path, stale)
    except OSError:
        return path  # best-effort: the raise that follows still stops serving
    return stale


def _count_corrupt(reason: str) -> None:
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        get_registry,
    )

    get_registry().counter(
        "rtfds_model_artifact_corrupt_total",
        "model artifacts that failed load-time verification",
        reason=reason).inc()


def load_model(path: str, device=None) -> TrainedModel:
    """Load a local artifact or an ``s3://`` one onto ``device`` (None =
    CUDA).

    A local artifact that fails its content hash is quarantined
    (``stale-…`` rename) before :class:`CorruptModelError` propagates; a
    ``truncated`` one is left in place (it may be a copy still being
    written). Either failure is counted by reason."""
    device = resolve_device(device)
    if path.startswith("s3://"):
        from real_time_fraud_detection_system_tpu_torch.io.store import (
            make_store,
        )

        url, key = _split_s3_url(path)
        try:
            return load_model_bytes(make_store(url).get(key), device=device)
        except CorruptModelError as e:
            _count_corrupt(e.reason)
            raise
    try:
        try:
            with np.load(path, allow_pickle=False) as z:
                return _load_model_npz(z, device)
        except zipfile.BadZipFile as e:
            raise _corrupt_from_badzip(e) from None
    except CorruptModelError as e:
        _count_corrupt(e.reason)
        if e.reason != "checksum":
            raise
        stale = _quarantine_artifact(path)
        raise CorruptModelError(
            e.reason, f"{e.detail} (quarantined to {stale})") from None


def upload_model(store, key: str, model: TrainedModel) -> None:
    """The reference's artifact upload (``load_initial_data.py:269-287``)."""
    store.put(key, dump_model_bytes(model))


def download_model(store, key: str, default=None, device=None):
    """Download and load ``key`` from ``store`` onto ``device``; a missing
    key returns ``default`` (the reference's scorer starts before the
    first model is published, ``fraud_detection.py:59-82``)."""
    try:
        data = store.get(key)
    except KeyError:
        return default
    try:
        return load_model_bytes(data, device=device)
    except CorruptModelError as e:
        _count_corrupt(e.reason)
        raise


def _load_model_npz(npz, device: torch.device) -> TrainedModel:
    # Read and verify everything before building any params: the zip
    # layer's entry CRCs fire here on bit-flips, and the v1 content hash
    # is recomputed over exactly what was read.
    try:
        meta = json.loads(str(npz["__meta__"]))
        z = {k: npz[k] for k in npz.files if k != "__meta__"}
    except zipfile.BadZipFile as e:
        raise _corrupt_from_badzip(e) from None
    except (KeyError, EOFError, OSError, ValueError) as e:
        raise CorruptModelError(
            "truncated", f"{type(e).__name__}: {e}") from None
    want = meta.get("content_sha256")
    if want is not None and _content_sha256(meta, z) != want:
        raise CorruptModelError(
            "checksum", "content hash does not match the stamped "
            f"sha256 {want[:12]}…")
    kind = meta["kind"]
    _require_kind(kind)

    def t(key: str) -> torch.Tensor:
        return torch.as_tensor(np.array(z[key], copy=True), device=device)

    scaler = Scaler(mean=t("scaler_mean"), scale=t("scaler_scale"))
    if kind == "logreg":
        params = LogRegParams(w=t("w"), b=t("b"))
    elif kind in ("mlp", "autoencoder"):
        params = [(t(f"w{i}"), t(f"b{i}")) for i in range(meta["n_layers"])]
        if kind == "autoencoder":
            params = AutoencoderParams(layers=params,
                                       err_scale=t("err_scale"))
    elif kind == "sequence":
        dims = meta["seq"]
        skeleton = init_transformer(
            d_model=dims["d_model"], n_heads=dims["n_heads"],
            n_layers=dims["n_layers"], d_ff=dims["d_ff"],
            n_in=dims["n_in"], device="meta")
        params = tree.unflatten(skeleton, [
            t(f"seq{i}") for i in range(len(tree.leaves(skeleton)))])
    else:
        params = TreeEnsemble(*(t(f) for f in _TREE_FIELDS),
                              max_depth=int(meta["max_depth"]))
        if kind == "gbt":
            params = GBTModel(trees=params, base_score=t("base_score"))
    return TrainedModel(kind=kind, scaler=scaler, params=params,
                        content_sha256=want)


_TX_FIELDS = (
    "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
    "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario",
)


def save_transactions(path: str, txs: Transactions) -> None:
    """Write a transactions table as the JAX package's ``rtfds datagen``
    does: a compressed ``.npz`` of the eight columns, renamed into place."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(f, **{k: getattr(txs, k) for k in _TX_FIELDS})
    os.replace(tmp, path)


def load_transactions(path: str) -> Transactions:
    """Read a table that :func:`save_transactions` or ``rtfds datagen``
    wrote."""
    with np.load(path, allow_pickle=False) as z:
        return Transactions(*[z[k] for k in _TX_FIELDS])
