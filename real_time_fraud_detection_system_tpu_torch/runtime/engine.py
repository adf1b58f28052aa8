"""Micro-batch scoring engine — port of the JAX package's
``runtime/engine.py`` for the forest serving path.

Per micro-batch: source poll → host dedup and pad → one packed int32
``[7, B]`` host-to-device copy → the device step → host result → sink.
The step mirrors the JAX engine's fused forest branch: unpack the batch,
scatter it into the window state (in place), gather both tables' rows,
run the fused featurize→forest kernel, and take
``probs = where(valid, leaf / n_trees, 0)``. The kernel serves whenever
its static admission predicate holds (``ops/forest_kernels.py::
admit_tables``); otherwise the step runs the unfused composition. On the
CPU the kernel's wrapper runs its plain version.

Not ported yet: the software pipeline, pinned async copies and the native
host-prep loader (ROADMAP A2); checkpoints and fault supervision (A3);
selective and bf16 emission, the nan-guard, CUDA-graph precompile (A4);
online SGD (A6); the model kinds other than tree and forest.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    bucket_size,
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import (
    FeatureState,
    init_feature_state,
    update_and_featurize,
    update_and_score_fused_forest,
)
from real_time_fraud_detection_system_tpu_torch.features.spec import N_FEATURES
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    GemmEnsemble,
    TreeEnsemble,
    for_device,
    predict_proba,
    resolve_z_mode,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    Scaler,
    transform,
)
from real_time_fraud_detection_system_tpu_torch.ops.dedup import (
    latest_wins_mask_np,
)
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    ForestTables,
    admit_tables,
    to_kernel_tables,
)

_KINDS = ("tree", "forest")


def _require_kind(kind: str) -> None:
    if kind not in _KINDS:
        raise NotImplementedError(
            f"model kind {kind!r} is not ported yet: the port serves "
            f"{_KINDS} (logreg waits for its fused kernel, ROADMAP B3; the "
            f"rest of the zoo for A8)")


def device_params_for(kind: str, params):
    """Engine-ready params: tree ensembles convert to the GEMM form once."""
    _require_kind(kind)
    if isinstance(params, TreeEnsemble):
        return for_device(params, N_FEATURES)
    return params


def predict_fn_for(kind: str, z_mode: Optional[str] = None) -> Callable:
    """Device predict for ``kind`` with a RESOLVED ``z_mode``."""
    _require_kind(kind)
    return lambda p, x: predict_proba(p, x, z_mode)


@dataclass
class EngineState:
    """Host-visible engine state (device tensors + offsets + counters)."""

    feature_state: FeatureState
    params: object
    scaler: Scaler
    offsets: List[int] = field(default_factory=list)
    batches_done: int = 0
    rows_done: int = 0


@dataclass
class BatchResult:
    tx_id: np.ndarray
    tx_datetime_us: np.ndarray
    customer_id: np.ndarray
    terminal_id: np.ndarray
    amount_cents: np.ndarray
    features: np.ndarray  # [n, 15]
    probs: np.ndarray  # [n]
    latency_s: float
    # Monotone engine batch counter: a replayed batch carries the SAME
    # index, so idempotent sinks can overwrite instead of duplicating.
    batch_index: int = -1


class PoisonRowError(ValueError):
    """A batch holds rows that decoded but carry impossible content (a
    negative amount). The fault supervisor that quarantines them is
    ported with ROADMAP A3."""


def validate_ingest_rows(cols: dict) -> None:
    """Refuse a batch with negative amounts — garbage must never scatter
    into the feature state."""
    amounts = np.asarray(cols["tx_amount_cents"])
    bad = amounts < 0
    if bad.any():
        ids = np.asarray(cols["tx_id"])[bad]
        raise PoisonRowError(
            f"corrupt row(s): negative amount_cents for "
            f"{int(bad.sum())} row(s), tx_id(s) {ids[:5].tolist()}")


class ScoringEngine:
    """Drives source → device step → sink for a tree ensemble.

    ``device=None`` means CUDA (raises without a card); ``device="cpu"``
    runs the plain PyTorch path. The feature state is updated in place.
    """

    def __init__(
        self,
        cfg: Config,
        kind: str,
        params,
        scaler: Scaler,
        feature_state: Optional[FeatureState] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kind = kind
        self.z_mode = resolve_z_mode(cfg.runtime.z_mode, self.device)
        params = device_params_for(kind, params.to(self.device))
        self.state = EngineState(
            feature_state=feature_state
            or init_feature_state(cfg.features, self.device),
            params=params,
            scaler=scaler.to(self.device),
        )
        self._predict = predict_fn_for(kind, self.z_mode)
        # The fused kernel's tables, or None when the admission predicate
        # refuses the params (descent form, or tables too large).
        self.tables: Optional[ForestTables] = (
            to_kernel_tables(params, self.z_mode)
            if isinstance(params, GemmEnsemble) and admit_tables(params).fits
            else None)

    def _step(self, packed: torch.Tensor):
        """One device step on a packed batch; returns (probs, features)."""
        batch = unpack_batch(packed)
        fcfg = self.cfg.features
        scaler = self.state.scaler
        tables = self.tables
        if tables is not None:
            fstate, leaf, feats = update_and_score_fused_forest(
                self.state.feature_state, batch, fcfg, scaler.mean,
                scaler.scale, tables)
            probs = leaf / tables.n_trees
        else:
            fstate, feats = update_and_featurize(
                self.state.feature_state, batch, fcfg)
            probs = self._predict(self.state.params, transform(scaler, feats))
        self.state.feature_state = fstate
        return torch.where(batch.valid, probs, torch.zeros_like(probs)), feats

    def _start_batch(self, cols: dict) -> dict:
        """Host prep (dedup, validate, pad, pack), the host-to-device copy
        and the device step. Does not wait for the device."""
        t0 = time.perf_counter()
        keep = latest_wins_mask_np(cols["tx_id"], cols["kafka_ts_ms"])
        cols = {k: v[keep] for k, v in cols.items()}
        validate_ingest_rows(cols)
        n = len(cols["tx_id"])
        pad = bucket_size(n, self.cfg.runtime.batch_buckets)
        packed = pack_batch(make_batch(
            customer_id=cols["customer_id"],
            terminal_id=cols["terminal_id"],
            tx_datetime_us=cols["tx_datetime_us"],
            amount_cents=cols["tx_amount_cents"],
            label=cols.get("label"),
            pad_to=pad,
        ))
        t1 = time.perf_counter()
        probs, feats = self._step(torch.from_numpy(packed).to(self.device))
        return {"cols": cols, "n": n, "probs": probs, "feats": feats,
                "t0": t0, "prep_s": t1 - t0,
                "dispatch_s": time.perf_counter() - t1}

    def _finish_batch(self, handle: dict) -> BatchResult:
        """Copy the results to the host (waits for the device)."""
        n = handle["n"]
        probs_np = handle["probs"][:n].cpu().numpy()
        if self.cfg.runtime.emit_features:
            feats_np = handle["feats"][:n].cpu().numpy()
        else:
            feats_np = np.zeros((n, N_FEATURES), np.float32)
        cols = handle["cols"]
        self.state.batches_done += 1
        self.state.rows_done += n
        return BatchResult(
            tx_id=cols["tx_id"],
            tx_datetime_us=cols["tx_datetime_us"],
            customer_id=cols["customer_id"],
            terminal_id=cols["terminal_id"],
            amount_cents=cols["tx_amount_cents"],
            features=feats_np,
            probs=probs_np,
            latency_s=time.perf_counter() - handle["t0"],
            batch_index=self.state.batches_done,
        )

    def process_batch(self, cols: dict) -> BatchResult:
        """One micro-batch: dedup → pad → device step → host result."""
        return self._finish_batch(self._start_batch(cols))

    def run(self, source, sink=None, max_batches: int = 0) -> dict:
        """Stream until the source is exhausted (or ``max_batches``).

        Returns this run's stats: rows, batches, wall seconds, rows/s, the
        per-batch latency p50/p99 (host prep through the results' arrival
        on the host), and the median milliseconds per batch of each loop
        stage (``stage_ms_p50``): source poll, host prep (dedup, pad,
        pack), dispatch (host-to-device copy and the step's launches),
        result wait (the device's remaining work and the copies back),
        sink write.
        """
        t_start = time.perf_counter()
        rows0 = self.state.rows_done
        batches0 = self.state.batches_done
        latencies = []
        stages = {k: [] for k in ("source_poll", "host_prep", "dispatch",
                                  "result_wait", "sink_write")}
        while not max_batches \
                or self.state.batches_done - batches0 < max_batches:
            t = time.perf_counter()
            cols = source.poll_batch()
            if cols is None:
                break
            stages["source_poll"].append(time.perf_counter() - t)
            handle = self._start_batch(cols)
            t = time.perf_counter()
            res = self._finish_batch(handle)
            stages["result_wait"].append(time.perf_counter() - t)
            stages["host_prep"].append(handle["prep_s"])
            stages["dispatch"].append(handle["dispatch_s"])
            self.state.offsets = list(source.offsets)
            latencies.append(res.latency_s)
            t = time.perf_counter()
            if sink is not None:
                sink.append(res)
            stages["sink_write"].append(time.perf_counter() - t)
        wall = time.perf_counter() - t_start
        rows = self.state.rows_done - rows0
        lat_ms = np.asarray(latencies) * 1e3
        return {
            "rows": rows,
            "batches": self.state.batches_done - batches0,
            "wall_s": wall,
            "rows_per_s": rows / wall if wall > 0 else 0.0,
            "latency_p50_ms": float(np.percentile(lat_ms, 50))
            if len(lat_ms) else 0.0,
            "latency_p99_ms": float(np.percentile(lat_ms, 99))
            if len(lat_ms) else 0.0,
            "stage_ms_p50": {k: float(np.median(v)) * 1e3 if v else 0.0
                             for k, v in stages.items()},
            "z_mode": self.z_mode,
        }
