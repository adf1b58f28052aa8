"""The sharded serving engine — port of the JAX package's
``runtime/sharded_engine.py`` for N shards in one process on one device.

The same source → dedup → step → sink → checkpoint stream contract as
:class:`~.engine.ScoringEngine` (whose run loop, feedback SGD, feature
cache, emission modes and precompile it inherits), but each batch is
partitioned by ``customer_id % n_dev`` on the host
(``parallel/step.py::partition_batch_spill``): chunk 0 holds the rows that
fit their shard's ``rows_per_shard``, and a hot key's overflow spills into
densely packed routed chunks instead of failing the stream. Each chunk is
one packed ``[7, n_dev · rows_per_shard]`` copy to the device and one call
of the sharded step (``make_sharded_step``: the terminal owner exchange,
per-shard state updates, the 15 features, the predict over the whole
chunk); the results are re-assembled in input order.

The shards share the engine's device (``parallel/mesh.py``): the state is
the JAX package's global arrays (owner-major window tables, a sketch per
shard), so checkpoints move between the packages at any width, and a
checkpoint of another width is converted on restore (``_ensure_layout``).

Scoring: tree, forest and gbt through the leaf-sum kernel
(``ops/forest_kernels.py::leaf_sum``), once per chunk; logreg, mlp and the
autoencoder through their plain predict. The fused featurize→score
kernels are not on this path: a sharded row's terminal aggregates arrive
through the exchange, not from the table by slot.

``key_mode="exact"`` (the tiered store) serves sharded too: ownership
stays ``key % n_dev``, and each shard has its own key directory over its
block of the tables, its own sketch replicas for the rows that miss
admission, its own recency compaction and cold-tier demotions and
promotions (``parallel/step.py::make_sharded_compact``,
``make_sharded_promote``, swapped in for the single engine's), and
``shard``-labelled tier, occupancy and reclaim series beside the
table-level ones (which get the shard sums). With each shard's hot tier
holding its keys it serves bit for bit as the single exact engine.

``precompile`` captures one CUDA graph per signature of
:meth:`ShardedScoringEngine.dispatch_inventory` — ``("sharded", False)``
(owner-local chunks) and ``("sharded", True)`` (the routed spill), with
the compact exchange bucket, and under ``key_mode="exact"``
``("compact",)`` and ``("promote",)``. The host picks each chunk's bucket
(``exchange_overflows``); a chunk that needs the full bucket (a hot key)
runs the same step eagerly, counted in the run's ``full_exchange_chunks``.

``topology`` (``runtime/distributed.py::ProcessTopology``) makes the
engine one process of the fleet, serving its residue block: it runs
unchanged (ingest affinity makes every polled key's residue local, so
``key % n_dev`` is the global layout's placement), but its per-shard
series carry global shard ids and a ``process`` label, strict ingest
refuses rows of another block, its checkpoints stamp the writer's
topology, and a single-process global state restored into it is re-sliced
to its block (``parallel/mesh.py::adopt_process_slice``). Several GPUs are
served as such a fleet, one process per GPU.

The sequence kind serves over the shards too: its history state is
stacked ``[n, cap_local + 1, ...]`` (``parallel/sequence_step.py``), chunk
0 runs the owner-local history step and a spill chunk the routed one, each
row carrying its original batch position as the same-second tie-breaker
(an eighth row of the chunk's one copy). It has no feature matrix, no
captured graphs (``precompile`` reports it skipped, as the JAX engine
does) and no compaction; a restore at another width converts the history
state exactly (``reshard_engine_state``).

Refused as the JAX engine refuses them: ``runtime.nan_guard``, the host
scorer, and for the sequence kind a fleet topology and the labeled
feedback.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import Config
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    bucket_size,
    fold_key,
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import (
    apply_feedback_at_slot,
    apply_feedback_sharded_exact,
    init_feature_state,
)
from real_time_fraud_detection_system_tpu_torch.features.spec import (
    N_FEATURES,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.ops.dedup import (
    latest_wins_mask_host,
)
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    Mesh,
    _check_colocated,
    make_mesh,
    reshard_engine_state,
    shard_feature_state,
)
from real_time_fraud_detection_system_tpu_torch.parallel.sequence_step \
    import (
        init_sharded_history_state,
        make_sharded_sequence_step,
        shard_history_state,
    )
from real_time_fraud_detection_system_tpu_torch.parallel.step import (
    exchange_overflows,
    make_sharded_compact,
    make_sharded_promote,
    make_sharded_step,
    partition_batch_spill,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    DispatchSignature,
    ScoringEngine,
    StepOut,
    check_sequence_serving,
    host_to_device,
    loss_fn_for,
    validate_ingest_rows,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    PoisonRowError,
)


class ShardedScoringEngine(ScoringEngine):
    """Streaming engine over ``n_devices`` shards co-located on
    ``device`` (default CUDA), or over ``mesh`` (``parallel/mesh.py``).

    ``rows_per_shard`` fixes the per-shard step width (default twice the
    balanced share of ``runtime.max_batch_rows``, at least 16); a batch is
    absorbed as one owner-local chunk plus ceil(overflow / chunk) routed
    ones. ``feature_state``: a pre-built state (host arrays or tensors);
    with ``feature_state_n_old`` (its shard count, 1 for a single-device
    state) the engine converts it to this width itself
    (``reshard_engine_state``), the safe path, since window layouts of
    different widths are shape-identical permutations. Without it the
    state must already be in this width's layout (a sketch or, under
    ``key_mode="exact"``, a directory stack of another width is
    refused)."""

    _FUSED_STEP = False
    # exact keys: labels looked up in the owner shard's directory (the
    # other key modes land them by the layout, apply_state_feedback)
    _state_feedback = staticmethod(apply_feedback_sharded_exact)

    def __init__(
        self,
        cfg: Config,
        kind: str,
        params,
        scaler: Scaler,
        mesh: Optional[Mesh] = None,
        n_devices: int = 0,
        rows_per_shard: int = 0,
        online_lr: float = 0.0,
        feature_cache=None,
        feature_state=None,
        feature_state_n_old: Optional[int] = None,
        metrics=None,
        dead_letter=None,
        topology=None,
        device=None,
    ):
        if topology is not None and kind == "sequence":
            raise ValueError(
                "multi-host serving is not wired for kind='sequence' "
                "(history-state process adoption does not exist yet); "
                "serve the sequence scorer single-process")
        if cfg.runtime.nan_guard:
            raise ValueError(
                "runtime.nan_guard is not wired for the sharded engine; "
                "serve single-chip with --nan-guard, or rely on the "
                "supervisor's crash-loop bisection (--dead-letter)")
        if cfg.runtime.scorer == "cpu":
            raise ValueError(
                "--scorer cpu is the single-host sklearn oracle; it does "
                "not compose with --devices > 1 or multi-host (the "
                "sharded engine always scores on-device)")
        if mesh is None:
            n = n_devices or (topology.local_devices if topology else 1)
            mesh = make_mesh(n, devices=[resolve_device(device)] * n)
        mesh = _check_colocated(mesh)
        n_dev = len(mesh)
        if topology is not None and n_dev != topology.local_devices:
            raise ValueError(
                f"mesh is {n_dev} device(s) wide but the topology says "
                f"this process serves {topology.local_devices} — the "
                "residue-block ownership is sized n_processes × "
                "local_devices, so the two must agree")
        # before the base constructor: its state series label per shard
        self.topology = topology
        seq = kind == "sequence"
        exact = cfg.features.key_mode == "exact" and not seq
        if exact:
            # each shard's directory masks slots to its local range:
            # validate the partition before any state is built
            for nm in ("customer_capacity", "terminal_capacity"):
                cap = getattr(cfg.features, nm)
                local = cap // n_dev if cap % n_dev == 0 else 0
                if local <= 0 or (local & (local - 1)):
                    raise ValueError(
                        f"key_mode='exact' on a {n_dev}-wide mesh needs "
                        f"{nm} / n_devices to be a power of two, got "
                        f"{cap} / {n_dev}")
        # the history state is keyed by customer alone
        for nm in ("customer_capacity",) + (() if seq
                                             else ("terminal_capacity",)):
            if getattr(cfg.features, nm) % n_dev:
                raise ValueError(f"{nm} must divide by n_devices")
        if exact and feature_state is not None \
                and feature_state_n_old is None:
            # the directory stack carries its width: a mislaid state is
            # refused with the fix named, never served as split histories
            kd = feature_state.terminal_dir
            lead = (int(kd.keys.shape[0])
                    if kd is not None and kd.keys.ndim == 2 else 1)
            if kd is None or lead != n_dev:
                raise ValueError(
                    f"provided exact feature_state is laid out for {lead} "
                    f"shard(s), mesh has {n_dev} — pass "
                    "feature_state_n_old to let the engine re-home the "
                    "directory entries (elastic reshard)")
        # the width before the base constructor: its budget check and
        # bytes gauges account a sketch per shard
        self.mesh = mesh
        self.n_dev = n_dev
        if feature_state is not None and feature_state_n_old is not None:
            feature_state = reshard_engine_state(
                kind, feature_state, cfg, feature_state_n_old, n_dev,
                stacked=True)
        if seq:
            # the stacked history state, built or placed before the base
            # constructor (a single-device state would double the bytes)
            if feature_state is None:
                pre_state = init_sharded_history_state(cfg, mesh)
            else:
                shape = tuple(np.shape(feature_state.events))
                if len(shape) != 4 or shape[0] != n_dev:
                    raise ValueError(
                        f"provided history state has leaves {shape}, not "
                        f"the {n_dev}-shard stack — pass "
                        "feature_state_n_old to let the engine re-shard "
                        "it")
                pre_state = shard_history_state(feature_state, mesh)
        else:
            if feature_state is None:
                feature_state = init_feature_state(cfg.features, mesh[0],
                                                   n_shards=n_dev)
            pre_state = shard_feature_state(feature_state, mesh)
        super().__init__(cfg, kind, params, scaler, feature_state=pre_state,
                         device=mesh[0], metrics=metrics,
                         online_lr=online_lr, feature_cache=feature_cache,
                         dead_letter=dead_letter)
        self.state.layout_devices = n_dev
        if topology is not None:
            # the writer's topology travels with the state: a fleet
            # process's checkpoint holds only its residue block
            self.state.process_count = topology.n_processes
            self.state.process_id = topology.process_id
        # the partitioned chunks are packed by NumPy (host prep's numpy
        # route); the native packer lays rows out densely
        self.host_prep = "numpy"
        self.rows_per_shard = rows_per_shard or max(
            2 * -(-cfg.runtime.max_batch_rows // n_dev), 16)
        # chunks stepped, and those whose exchange needed the full bucket
        self.chunks_done = 0
        self.full_exchange_chunks = 0
        self._m_shard_rows = [
            self.metrics.gauge(
                "rtfds_shard_rows",
                "rows routed to this shard in the last batch",
                **self._shard_labels(i))
            for i in range(n_dev)]
        if seq:
            # owner-local chunks and the routed spill, as for the window
            # state; the sequence kind has no compaction or cold tier
            self._steps = {routed: make_sharded_sequence_step(
                cfg, mesh, route=routed) for routed in (False, True)}
            return
        self._steps = {
            routed: make_sharded_step(
                cfg, lambda p, x: self._unfused_predict(x),
                loss_fn=loss_fn_for(kind), online_lr=online_lr, mesh=mesh,
                route_customers=routed, packed=True)
            for routed in (False, True)}
        # the tiered store's passes between steps run per shard
        self._compact_pass = make_sharded_compact(
            cfg, mesh, demote_slots=self._demote_slots)
        self._promote_pass = make_sharded_promote(cfg, mesh)

    # -- layout -------------------------------------------------------------

    def _state_shards(self) -> int:
        return self.n_dev

    def _shard_labels(self, local_shard: int) -> dict:
        """The labels of a per-shard series: ``shard=<local>`` in one
        process; in a fleet the GLOBAL shard id (``shard_offset + local``,
        the shard the single (P·L)-shard engine would use for the same
        keys) and ``process``, so the fleet's aggregated view reads as one
        engine's shard space."""
        topo = getattr(self, "topology", None)
        if topo is None or topo.n_processes <= 1:
            return {"shard": str(local_shard)}
        return {"shard": str(topo.shard_offset + local_shard),
                "process": str(topo.process_id)}

    def _ensure_layout(self) -> None:
        """The single engine's conversion of a restore at another width,
        and the fleet's: a single-process global state restored into a
        fleet process is re-sliced to its residue block
        (``adopt_process_slice``); a state of another fleet, or of this
        fleet at another width per process (keys would move between
        processes), raises naming the merge."""
        st = self.state
        topo = self.topology
        if topo is None:
            super()._ensure_layout()
            return
        n_old = int(st.layout_devices or 1)
        restored_pc = int(st.process_count or 1)
        my_pc = topo.n_processes
        if restored_pc == my_pc and my_pc > 1 and n_old != self.n_dev:
            raise ValueError(
                f"restored state was laid out at {n_old} device(s) per "
                f"process; this engine serves {self.n_dev} — in a "
                f"{my_pc}-process fleet that changes residue-block "
                "ownership (key % (P·L)): merge the fleet's "
                "checkpoints (parallel.mesh.merge_process_states) and "
                "re-slice at the new topology")
        if restored_pc == my_pc:
            super()._ensure_layout()
            return
        if restored_pc != 1:
            raise ValueError(
                f"restored state was written by a {restored_pc}"
                f"-process fleet; this engine serves a {my_pc}"
                "-process topology — merge the per-process "
                "checkpoints first (parallel.mesh.merge_process_states)")
        from real_time_fraud_detection_system_tpu_torch.parallel.mesh \
            import adopt_process_slice

        src = st.layout_pending
        if src is None:
            src = st.feature_state
        new = adopt_process_slice(src, self.cfg, n_old, topo)
        shard_feature_state(new, self.mesh, out=st.feature_state)
        st.layout_pending = None
        st.layout_devices = self.n_dev
        st.process_count = topo.n_processes
        st.process_id = topo.process_id

    # -- the tiered store per shard ----------------------------------------

    def _init_state_telemetry(self) -> None:
        """The single engine's series (the table-level view) and, under
        ``key_mode="exact"``, the same tier, occupancy and reclaim series
        per shard: skew is what the modulo ownership hides."""
        super()._init_state_telemetry()
        self._m_tier_shard = self._m_slots_occ_shard = None
        self._m_slots_rec_shard = None
        if not self._exact:
            return
        reg = self.metrics
        n = self._state_shards()
        tables = self._dir_tables()
        self._m_tier_shard = {
            (t, s): reg.counter(
                "rtfds_feature_tier_rows_total",
                "row x keyspace feature reads served per tier "
                "(dense = private hot-tier slot; cms = count-min "
                "sketch fallback after an admission miss)",
                tier=t, **self._shard_labels(s))
            for t in ("dense", "cms") for s in range(n)}
        self._m_slots_occ_shard = {
            (t, s): reg.gauge(
                "rtfds_feature_slots_occupied",
                "hot-tier slots currently owned by a key "
                "(updated at compaction cadence)",
                table=t, **self._shard_labels(s))
            for t in tables for s in range(n)}
        self._m_slots_rec_shard = {
            (t, s): reg.counter(
                "rtfds_feature_slots_reclaimed_total",
                "hot-tier slots reclaimed by recency compaction "
                "(the slot held only history older than "
                "delay + max(window))",
                table=t, **self._shard_labels(s))
            for t in tables for s in range(n)}

    def _meter_shards(self, reclaimed: np.ndarray,
                      occupied: dict) -> dict:
        """The per-shard series of one compaction (``reclaimed`` [n, 2],
        ``occupied`` table → [n]), and the flight event's
        ``occupied_per_shard``."""
        per_shard = np.zeros(self.n_dev, np.int64)
        for i, table in enumerate(("customer", "terminal")):
            if table not in occupied:
                continue
            for s in range(self.n_dev):
                self._m_slots_occ_shard[(table, s)].set(
                    int(occupied[table][s]))
                self._m_slots_rec_shard[(table, s)].inc(
                    int(reclaimed[s, i]))
            per_shard += occupied[table]
        return {"occupied_per_shard": per_shard.tolist()}

    # -- the precompiled step over the shards ------------------------------

    @property
    def _chunk_rows(self) -> int:
        return self.n_dev * self.rows_per_shard

    def dispatch_inventory(self) -> list:
        """The JAX engine's signatures: one shape (chunks are always
        ``[7, n_dev · rows_per_shard]``) × the owner-local step and the
        dense-spill routed step; then, as on the single engine,
        ``("compact",)`` with a compaction cadence and ``("promote",)``
        with a cold tier, over the shards. The sequence kind has none (as
        in the JAX engine): its chunks run eagerly."""
        if self.kind == "sequence":
            return []
        zmode_kinds = ("tree", "forest", "gbt")
        rt = self.cfg.runtime
        return [DispatchSignature(
            key=("sharded", routed),
            variant="sharded-routed" if routed else "sharded-local",
            kind=self.kind,
            z_mode=self.z_mode if self.kind in zmode_kinds else None,
            bucket=self._chunk_rows, selective=self._selective,
            emit_dtype=rt.emit_dtype)
            for routed in (False, True)] + [
            sg for sg in super().dispatch_inventory()
            if sg.variant != "step"]

    def precompile(self) -> dict:
        """The single engine's capture of :meth:`dispatch_inventory`; the
        sequence kind captures nothing and says so, as the JAX engine
        skips its warmup."""
        if self.kind == "sequence":
            return {"buckets": [], "variants": 0, "seconds": 0.0,
                    "skipped": "sequence"}
        return super().precompile()

    def _ensure_step(self, routed: bool):
        """The step of a variant (built with the engine: a PyTorch step
        needs no tracing)."""
        return self._steps[routed]

    def _chunk_step(self, packed: torch.Tensor, routed: bool,
                    full=(False, False)) -> StepOut:
        """One chunk through the sharded step on the engine's state (in
        place): what a captured graph records and an eager dispatch
        runs."""
        st = self.state
        out = self._ensure_step(routed)(
            st.feature_state, st.params, st.scaler, packed, full=full)
        probs, feats = out[2], out[3]
        tier = out[4] if len(out) > 4 else None
        if isinstance(feats, dict):
            return StepOut(probs, feats["full"], tier, feats["packed"])
        return StepOut(probs, feats, tier)

    def signature_step(self, sig: DispatchSignature):
        if not sig.variant.startswith("sharded"):
            return super().signature_step(sig)
        routed = sig.variant == "sharded-routed"
        return lambda packed: self._chunk_step(packed, routed)

    def _static_inputs(self, sig: DispatchSignature) -> list:
        if not sig.variant.startswith("sharded"):
            return super()._static_inputs(sig)
        # every row invalid: what the capture's warmup runs on
        return [torch.zeros((7, sig.bucket), dtype=torch.int32,
                            device=self.device)]

    # -- the sharded hot path ----------------------------------------------

    def _validate_sharded(self, cols: dict) -> None:
        """The single engine's ingest check, with the shard placements
        (``customer_id % n_dev``) of the corrupt rows named; in a fleet
        with ``strict_affinity``, every row's customer residue must be
        this process's (a breach would serve one key's history in two
        processes)."""
        try:
            validate_ingest_rows(cols)
        except PoisonRowError as e:
            bad = np.asarray(cols["tx_amount_cents"]) < 0
            shards = sorted(set((np.asarray(cols["customer_id"])[bad]
                                 % self.n_dev).astype(int).tolist()))
            raise PoisonRowError(
                f"{e}; shard placement(s) {shards[:8]}") from None
        topo = self.topology
        if (topo is not None and topo.strict_affinity
                and len(cols["tx_id"])):
            owner = topo.owner_process(cols["customer_id"])
            mine = owner == topo.process_id
            if not mine.all():
                others = sorted(set(owner[~mine].tolist()))
                raise ValueError(
                    f"partition-affinity breach: {int((~mine).sum())} "
                    f"polled row(s) belong to process(es) {others[:4]} "
                    f"but this is process {topo.process_id} — fix the "
                    "launcher's source slicing (PartitionAffineSource "
                    "residues / Kafka partition blocks), or pass "
                    "strict_affinity=False for a broker-partitioned "
                    "fleet whose keys are not residue-aligned")

    def _start_batch(self, cols: dict) -> dict:
        """Dedup → partition (spill) → per chunk one packed copy and one
        step (a graph replay, or eager for a full-bucket exchange) → the
        start of its result copies. Does not wait for the device."""
        t0 = time.perf_counter()
        n_dev, total = self.n_dev, self._chunk_rows
        with self.tracer.span("host_prep", nvtx=self._nvtx):
            keep = latest_wins_mask_host(cols["tx_id"], cols["kafka_ts_ms"])
            cols = {k: v[keep] for k, v in cols.items()}
            self._validate_sharded(cols)
            n = len(cols["tx_id"])
            if n:
                loads = np.bincount(
                    (cols["customer_id"] % n_dev).astype(np.int64),
                    minlength=n_dev)
                for g, rows in zip(self._m_shard_rows, loads):
                    g.set(int(rows))
            chunks = []
            seq = self.kind == "sequence"
            for part, rows, pos in (partition_batch_spill(
                    cols, n_dev, self.rows_per_shard) if n else []):
                valid = part["__valid__"]
                routed = part["__routed__"]
                label = part.get("label")
                packed = pack_batch(make_batch(
                    customer_id=part["customer_id"],
                    terminal_id=part["terminal_id"],
                    tx_datetime_us=part["tx_datetime_us"],
                    amount_cents=part["tx_amount_cents"],
                    label=None if label is None
                    else np.where(valid, label, -1),
                )._replace(valid=valid))
                if seq:
                    # the history step's same-second tie-breaker: each
                    # chunk slot's original batch row, an eighth row of
                    # the one copy
                    okey = np.zeros((1, total), np.int32)
                    okey[0, pos] = rows
                    chunks.append((np.concatenate([packed, okey]), routed,
                                   (False, False), rows, pos))
                    continue
                full = (routed and exchange_overflows(
                            part["customer_id"], valid, n_dev),
                        exchange_overflows(part["terminal_id"], valid,
                                           n_dev))
                chunks.append((packed, routed, full, rows, pos))
            t1 = time.perf_counter()
        with self.tracer.span("dispatch", rows=n, chunks=len(chunks),
                              nvtx=self._nvtx):
            self._note_params_swap()
            if self._recapture:
                self.precompile()
            parts = []
            for packed, routed, full, rows, pos in chunks:
                if seq:
                    out = self._sequence_chunk(packed, routed)
                    self.chunks_done += 1
                    parts.append((rows, pos, out, self._issue_host_fetch(
                        out, total, self._record_ready())))
                    continue
                key = ("sharded", routed)
                graph = None if any(full) else self._graphs.get(key)
                entry = (self._staging.acquire(total) if self._staging
                         else None)
                if entry is not None:
                    entry[0].numpy()[...] = packed
                    src = entry[0]
                else:
                    src = torch.from_numpy(packed)
                if graph is not None:
                    dst = graph.inputs[0]
                    dst.copy_(src, non_blocking=True)
                else:
                    dst = src.to(self.device, non_blocking=True)
                self._m_xfer["h2d"].inc(src.numel() * src.element_size())
                if entry is not None:
                    entry[1] = torch.cuda.Event()
                    entry[1].record()
                if any(full):
                    # the full exchange bucket: the same step, eagerly
                    self.full_exchange_chunks += 1
                    out = self._chunk_step(dst, routed, full)
                else:
                    out = self._dispatch_step(
                        key, lambda p, r=routed: self._chunk_step(p, r),
                        dst)
                self.chunks_done += 1
                parts.append((rows, pos, out, self._issue_host_fetch(
                    out, total, self._record_ready())))
            if self.online_lr > 0.0 and self._loss is not None and chunks:
                # the leaves no longer hold what the last restore wrote
                self.state.params_crcs = None
            self._note_batch_days(cols)
            self._note_cold_touches(cols)
            self._count_sequence_rows(n)
        return {"cols": cols, "n": n, "parts": parts, "t0": t0,
                "prep_s": t1 - t0, "dispatch_s": time.perf_counter() - t1}

    def _record_ready(self):
        """An event behind the step just enqueued (None on the CPU): what
        a checkpoint's save and the result copies wait for."""
        if self.device.type != "cuda":
            return None
        done = torch.cuda.Event()
        done.record()
        self.state.ready = done
        return done

    def _sequence_chunk(self, packed: np.ndarray, routed: bool) -> StepOut:
        """One chunk of the sequence kind: the packed rows and their
        original batch positions in one copy, then the history step (the
        routed one for a spill chunk) on the engine's state, in place."""
        dev = host_to_device(packed, self.device)
        self._m_xfer["h2d"].inc(packed.nbytes)
        st = self.state
        _, probs = self._steps[routed](
            st.feature_state, st.params, unpack_batch(dev[:7]), dev[7])
        return StepOut(probs)

    def _host_results(self, handle: dict):
        """Every chunk's copies, waited for and decoded by the single
        engine's reader, re-assembled in input order. Selective emission's
        overflow counts once per batch, however many chunks overflow.
        Under ``key_mode="exact"`` the chunks' per-shard tier counts are
        summed: the shard series take their rows here, the table-level
        ones (the single engine's) the shard sums."""
        n = handle["n"]
        total = self._chunk_rows
        probs = np.zeros(n, np.float32)
        feats = np.zeros((n, N_FEATURES), np.float32)
        emit = self._emit_features_now()
        overflows = self.selective_overflows
        tier = None
        for rows, pos, out, fetch in handle["parts"]:
            p, f, t = super()._host_results(
                {"n": total, "out": out, "fetch": fetch})
            probs[rows] = p[pos]
            if emit:
                feats[rows] = f[pos]
            if t is not None:
                tier = t.astype(np.float64) + (0.0 if tier is None
                                               else tier)
        self.selective_overflows = min(self.selective_overflows,
                                       overflows + 1)
        if tier is not None:
            for s in range(self.n_dev):
                self._m_tier_shard[("dense", s)].inc(float(tier[s, 0]))
                self._m_tier_shard[("cms", s)].inc(float(tier[s, 1]))
            tier = tier.sum(axis=0)
        return probs, feats, tier

    def run(self, *args, **kwargs) -> dict:
        """:meth:`ScoringEngine.run`, its stats with this run's ``chunks``
        (sharded steps) and ``full_exchange_chunks`` (those whose exchange
        needed the full bucket and ran eagerly)."""
        chunks0, full0 = self.chunks_done, self.full_exchange_chunks
        stats = super().run(*args, **kwargs)
        stats["chunks"] = self.chunks_done - chunks0
        stats["full_exchange_chunks"] = self.full_exchange_chunks - full0
        return stats

    # -- feedback into the owner-partitioned terminal table ----------------

    def apply_state_feedback(self, terminal_ids: np.ndarray,
                             days: np.ndarray, labels: np.ndarray) -> None:
        """Land delayed fraud labels in the sharded terminal risk windows:
        terminal key k lives at global row ``(k % n_dev) · cap_local +
        ((k // n_dev) & (cap_local - 1))`` (the step's owner layout), in
        chunks of at most the largest bucket padded to a bucket, in place
        on the serving stream (``features/online.py::
        apply_feedback_at_slot``). Under ``key_mode="exact"`` the slot is
        a lookup in the owner's directory, never an insert: hits land in
        its window rows, misses in its sketch's fraud column
        (``apply_feedback_sharded_exact``)."""
        self._ensure_layout()
        if self.kind == "sequence":
            check_sequence_serving(self.cfg, feedback=True)
        labels = np.asarray(labels)
        mask = labels >= 0
        if not mask.any():
            return
        if self._exact:
            super().apply_state_feedback(terminal_ids, days, labels)
            return
        n_dev = self.n_dev
        cap_local = self.cfg.features.terminal_capacity // n_dev
        key = fold_key(np.asarray(terminal_ids)[mask]).astype(np.int64)
        gslot = (key % n_dev) * cap_local + ((key // n_dev)
                                             & (cap_local - 1))
        d = np.asarray(days)[mask]
        y = labels[mask]
        buckets = self.cfg.runtime.batch_buckets
        biggest = max(buckets)
        for s in range(0, len(y), biggest):
            m = len(y[s:s + biggest])
            pad = bucket_size(m, buckets)
            # one int32 [4, pad] copy: global row, day, label, valid
            packed = np.zeros((4, pad), dtype=np.int32)
            packed[0, :m] = gslot[s:s + m]
            packed[1, :m] = d[s:s + m]
            packed[2, :m] = y[s:s + m]
            packed[3, :m] = 1
            dev = host_to_device(packed, self.device)
            apply_feedback_at_slot(self.state.feature_state, dev[0].long(),
                                   dev[1], dev[2], dev[3].bool())
