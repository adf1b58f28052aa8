"""Typed configuration for the PyTorch/CUDA serving path.

A copy of the parts of ``real_time_fraud_detection_system_tpu/config.py``
that the port reads: a subset of its fields, with the same names, defaults
and validation, so one set of values configures both packages. Canonical
feature definitions (night = ``hour <= 6``, weekend = ``weekday >= 5``
with Monday == 0) are the JAX package's; see its module docstring.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Sequence


@dataclass(frozen=True)
class DataConfig:
    """Synthetic data generator knobs (reference ``data_generator.ipynb · cell 34``)."""

    n_customers: int = 5000
    n_terminals: int = 10000
    n_days: int = 245
    radius: float = 5.0
    start_date: str = "2025-04-01"
    seed: int = 0
    # Fraud scenarios (reference ``data_generator.ipynb · cell 42``).
    scenario1_amount_threshold: float = 220.0
    scenario2_terminals_per_day: int = 2
    scenario2_compromise_days: int = 28
    scenario3_customers_per_day: int = 3
    scenario3_compromise_days: int = 14
    scenario3_amount_multiplier: float = 5.0
    scenario3_fraction: float = 1.0 / 3.0


@dataclass(frozen=True)
class FeatureConfig:
    """Stateful windowed feature computation.

    Customer {1,7,30}-day count+avg-amount; terminal {1,7,30}-day
    count+risk shifted back by ``delay_days`` (fraud labels arrive late).
    The port serves every ``key_mode`` ("direct", "hash", "exact") with
    ``customer_source`` "table" or "cms".
    """

    windows: Sequence[int] = (1, 7, 30)
    delay_days: int = 7
    # Day-bucket ring buffers must cover delay + max(window) days of history.
    n_day_buckets: int = 40
    # Dense per-key state capacity (power of 2).
    customer_capacity: int = 8192
    terminal_capacity: int = 16384
    # "direct" (key & (cap-1)) is collision-free for dense serial ids below
    # the capacity; "hash" mixes the key first (colliding keys share a
    # slot); "exact" routes through the key directory (ops/keydir.py): the
    # hot tier holds the active working set, admitted keys are
    # collision-exact, and rows that miss admission read the count-min
    # sketch tier.
    key_mode: str = "direct"
    # key_mode="exact" knobs: the directory's fixed probe depth (it is 2x
    # the slot capacity, load factor <= 0.5), and the recency-compaction
    # cadence in batches (0 = off): compaction reclaims slots whose newest
    # bucket is older than delay_days + max(windows).
    keydir_probes: int = 8
    compact_every: int = 0
    # Device-memory budget for the whole feature state, checked at engine
    # build against features/online.py::state_bytes (0 = unchecked).
    state_hbm_budget_mb: float = 0.0
    # Host cold tier (io/coldstore.py) for key_mode="exact": compaction
    # demotes up to cold_demote_slots of the oldest keys per table while
    # occupancy sits above cold_highwater * capacity, and a returning key
    # is promoted back between steps. "" = off (evictions discard).
    cold_store: str = ""
    # Bounded promoter request queue (a full queue drops the request; the
    # key re-enqueues on its next touch).
    cold_promote_queue: int = 64
    # MB of buffered demoted rows before a segment is written.
    cold_segment_mb: float = 4.0
    cold_demote_slots: int = 1024
    cold_highwater: float = 0.75
    # Count-min sketch for unbounded key cardinality (velocity features).
    cms_depth: int = 4
    cms_width: int = 1 << 15
    # Where customer velocity features come from: "table" = the dense
    # window state; "cms" = the count-min sketch (BASELINE config 3),
    # bounded memory with overestimate-only error. Terminal risk always
    # uses the table.
    customer_source: str = "table"
    # Per-customer event-history ring length for the sequence scorer
    # (features/history.py): the serving-side max_len of
    # models/sequence.build_sequences.
    history_len: int = 32
    # Attention form of the serving transformer over the history ring:
    # "naive" materializes [B, H, K, K] scores (short K), "blockwise" runs
    # the online-softmax recurrence ([B, H, K, block] scores, long K),
    # "auto" switches to blockwise once history_len exceeds
    # seq_attn_block.
    seq_attn: str = "auto"
    seq_attn_block: int = 128
    night_end_hour: int = 6
    weekend_start_weekday: int = 5  # Monday == 0

    def __post_init__(self):
        if self.customer_source not in ("table", "cms"):
            raise ValueError(
                f"customer_source must be 'table' or 'cms', "
                f"got {self.customer_source!r}")
        if self.key_mode not in ("direct", "hash", "exact"):
            raise ValueError(
                f"key_mode must be 'direct', 'hash' or 'exact', "
                f"got {self.key_mode!r}")
        for name in ("customer_capacity", "terminal_capacity"):
            cap = getattr(self, name)
            if cap < 1 or cap & (cap - 1):
                raise ValueError(
                    f"{name} must be a power of two (direct mode masks "
                    f"with capacity-1; non-pow2 silently aliases keys), "
                    f"got {cap}")
        if self.keydir_probes < 1:
            raise ValueError(
                f"keydir_probes must be >= 1, got {self.keydir_probes}")
        if self.compact_every < 0:
            raise ValueError(
                f"compact_every must be >= 0 (0 = off), "
                f"got {self.compact_every}")
        if self.state_hbm_budget_mb < 0:
            raise ValueError(
                f"state_hbm_budget_mb must be >= 0 (0 = unchecked), "
                f"got {self.state_hbm_budget_mb}")
        if self.cold_promote_queue < 1:
            raise ValueError(
                f"cold_promote_queue must be >= 1 (the promoter queue is "
                f"bounded), got {self.cold_promote_queue}")
        if self.cold_segment_mb <= 0:
            raise ValueError(
                f"cold_segment_mb must be > 0, got {self.cold_segment_mb}")
        if self.cold_demote_slots < 1:
            raise ValueError(
                f"cold_demote_slots must be >= 1, "
                f"got {self.cold_demote_slots}")
        if not 0 < self.cold_highwater <= 1:
            raise ValueError(
                f"cold_highwater must be in (0, 1], "
                f"got {self.cold_highwater}")
        if self.cold_store:
            if self.key_mode != "exact":
                raise ValueError(
                    "cold_store requires key_mode='exact' (only the "
                    "keyed hot tier has per-key rows to demote), got "
                    f"key_mode={self.key_mode!r}")
            if self.compact_every <= 0:
                raise ValueError(
                    "cold_store requires compact_every > 0 (demotion "
                    "rides the compaction cadence)")
        if self.seq_attn not in ("naive", "blockwise", "auto"):
            raise ValueError(
                f"seq_attn must be 'naive', 'blockwise' or 'auto', "
                f"got {self.seq_attn!r}"
            )


@dataclass(frozen=True)
class ModelConfig:
    """Classifier selection and the model zoo's shapes (the JAX package's
    fields, names and defaults): the kind, the mlp's and autoencoder's
    hidden widths (the autoencoder's last entry is the bottleneck), the
    forest's, the single tree's and the sequence transformer's dims
    (``models/sequence.py``)."""

    kind: str = "logreg"  # logreg | mlp | tree | forest | gbt | autoencoder
    n_features: int = 15
    mlp_hidden: Sequence[int] = (64, 32)
    autoencoder_hidden: Sequence[int] = (32, 8)
    forest_n_trees: int = 100
    forest_max_depth: int = 8
    tree_max_depth: int = 2
    seq_d_model: int = 32
    seq_n_heads: int = 2
    seq_n_layers: int = 2
    seq_d_ff: int = 64
    dtype: str = "float32"
    seed: int = 0


@dataclass(frozen=True)
class TrainConfig:
    """Offline training protocol (the reference's 153/30/30-day
    train/delay/test split and the minibatch optimizer's knobs), and the
    step size of the feedback SGD when the engine has no ``online_lr``."""

    delta_train_days: int = 153
    delta_delay_days: int = 30
    delta_test_days: int = 30
    learning_rate: float = 1e-2
    batch_size: int = 4096
    epochs: int = 5
    weight_decay: float = 0.0
    # Online SGD (BASELINE.json config 4).
    online_learning_rate: float = 1e-3


@dataclass(frozen=True)
class OverloadConfig:
    """Overload-survival ladder (``runtime/overload.py``): a hysteresis
    state machine over the registry's pressure signals (windowed batch
    latency against ``runtime.latency_slo_ms``, source lag, queue fill)
    that climbs a reversible ladder — rung 1 sheds optional work (shadow
    scoring, learner training) and samples the flight record, rung 2
    forces
    the largest batch bucket and alerts-only emission, rung 3 defers whole
    micro-batches to a durable spill and replays them in order once
    pressure subsides (``scored + deferred == polled``)."""

    enabled: bool = False
    # Durable spill for rung-3 deferral (the dead-letter machinery,
    # reason=shed, idempotent by tx_id): ``*.jsonl`` = JSONL file,
    # anything else = Parquet part directory; "" = memory only.
    spill_path: str = "overload_spill"
    # Hysteresis: climb one rung after ``climb_dwell_batches``
    # consecutive observations at pressure >= ``climb_pressure``, descend
    # after ``descend_dwell_batches`` at pressure <= ``descend_pressure``.
    climb_pressure: float = 1.0
    descend_pressure: float = 0.6
    climb_dwell_batches: int = 3
    descend_dwell_batches: int = 6
    # Source lag of this many rows == pressure 1.0 (0 = lag signal off).
    lag_high_rows: int = 0
    # Windowed p50 batch-latency signal (vs runtime.latency_slo_ms).
    latency_window_batches: int = 8
    # At most this many deferred micro-batches held at once; at the cap
    # the queue head replays through scoring to make room.
    max_deferred_batches: int = 512
    # Flight-record sampling while any rung is active (rung 1): record
    # every k-th batch.
    recorder_sample_every: int = 16

    def __post_init__(self):
        if not 0.0 <= self.descend_pressure < self.climb_pressure:
            raise ValueError(
                "overload hysteresis needs 0 <= descend_pressure < "
                f"climb_pressure, got {self.descend_pressure} / "
                f"{self.climb_pressure}")
        if self.climb_dwell_batches < 1 or self.descend_dwell_batches < 1:
            raise ValueError("overload dwell counts must be >= 1")
        if self.max_deferred_batches < 1:
            raise ValueError("overload.max_deferred_batches must be >= 1")
        if self.recorder_sample_every < 1:
            raise ValueError("overload.recorder_sample_every must be >= 1")


@dataclass(frozen=True)
class DistributedConfig:
    """The fleet's process topology (``runtime/distributed.py``): N OS
    processes, each owning a contiguous block of the global shard space.
    Process p of P, serving L local shards, owns the customer residues
    ``key % (P·L) ∈ [p·L, (p+1)·L)``; the per-process engine's own
    ``key % L`` placement then equals the global residue minus the block
    base, so it runs unchanged and the fleet's layout is a single
    (P·L)-shard engine's. Ingest is partition-affine, so no row crosses a
    process on the host."""

    # host:port of process 0's torch.distributed TCP store (gloo). "" =
    # uncoordinated fleet: the processes still split the shard space but
    # initialize no process group (per-worker restarts become safe).
    coordinator: str = ""
    # Total processes in the fleet; 1 = single process (everything off).
    num_processes: int = 1
    # This process's id in [0, num_processes); -1 = resolve from RANK (the
    # launcher always passes it).
    process_id: int = -1
    # Refuse polled rows whose customer residue this process does not own
    # (residue-sliced sources; a Kafka fleet partitions by broker
    # partition and the CLI turns the check off there).
    strict_affinity: bool = True
    # The process group's rendezvous and barrier timeout.
    init_timeout_s: float = 120.0

    def __post_init__(self):
        if self.num_processes < 1:
            raise ValueError(
                f"distributed.num_processes must be >= 1, "
                f"got {self.num_processes}")
        if self.num_processes > 1 and self.process_id >= self.num_processes:
            raise ValueError(
                f"distributed.process_id {self.process_id} out of range "
                f"for {self.num_processes} process(es)")
        if self.init_timeout_s <= 0:
            raise ValueError(
                f"distributed.init_timeout_s must be > 0, "
                f"got {self.init_timeout_s}")


@dataclass(frozen=True)
class RuntimeConfig:
    """Micro-batch engine knobs that the port reads.

    ``scorer``: ``"tpu"`` (the JAX package's name, kept so configs carry
    over) scores on the engine's device; ``"cpu"`` runs the same step on
    the device, then rescores the fetched features on the host with the
    model's pure-NumPy ``predict_proba_np`` (the oracle).

    The JAX package's ``use_pallas`` has no field here: the port serves
    the fused featurize→forest step whenever the kernel's admission
    predicate holds (on the CPU the wrapper runs its plain version).
    """

    scorer: str = "tpu"  # cpu | tpu
    # Dtype of the dense path table: "auto" = int8 on CUDA, f32 elsewhere.
    # On the forest kernels' paths it only chooses the dtype of the plain
    # version's table: the kernels descend node tables that do not depend
    # on it, and every mode gives bit-identical sums.
    z_mode: str = "auto"
    # False = alerts-only serving: BatchResult.features is zeros and the
    # [B, 15] matrix never leaves the device.
    emit_features: bool = True
    # Pad micro-batches to these row counts.
    batch_buckets: Sequence[int] = (256, 1024, 4096, 16384, 65536)
    max_batch_rows: int = 65536
    trigger_seconds: float = 0.0  # 0 => score as fast as batches arrive
    # Max micro-batches in flight at once (the engine's software
    # pipeline). 2 = double-buffering: batch N+1's host prep and H2D copy
    # overlap batch N's device step. Steps still chain through the
    # feature state on one stream, so depth buys host/device overlap,
    # not device concurrency.
    pipeline_depth: int = 2
    # Coalesce consecutive source polls into one device batch of up to
    # this many rows, never past the largest bucket (0 = off).
    coalesce_rows: int = 0
    # Capture the step of every batch bucket (and the compaction and
    # promotion passes) as one CUDA graph each before the first poll
    # (ScoringEngine.precompile); every batch then replays its bucket's
    # graph. On the CPU nothing is captured.
    precompile: bool = False
    # Adaptive micro-batch controller (runtime/autobatch.py): the coalesce
    # target moves between the batch_buckets from observed latency — hold
    # latency_slo_ms when set, else hill-climb for throughput. Overrides
    # coalesce_rows while active.
    autobatch: bool = False
    # p50 micro-batch latency target in ms (0 = no SLO).
    latency_slo_ms: float = 0.0
    # "bfloat16" halves the emitted feature matrix's device-to-host bytes;
    # the classifier reads the float32 features first (predictions are
    # unaffected). Refused where the host re-consumes the features.
    emit_dtype: str = "float32"  # "float32" | "bfloat16"
    # Selective emission (> 0 enables): probabilities for every row, the
    # 15 feature columns only for rows whose probability clears this
    # threshold, compacted on the device into one packed float32 transfer.
    emit_threshold: float = 0.0
    # The compaction's capacity as a fraction of the batch rows; a batch
    # that flags more falls back to fetching its full feature matrix.
    emit_cap_fraction: float = 1 / 16
    # Copy results to the host on a side stream as soon as the step is
    # enqueued, into pinned memory, so the copy overlaps later batches'
    # host work (on the CPU there is nothing to overlap).
    fetch_overlap: bool = True
    # Sink appends on a background writer thread behind a bounded queue
    # of sink_queue_batches results (io/sink.py::AsyncSink).
    async_sink: bool = False
    sink_queue_batches: int = 8
    # Ingest-decode worker threads for envelope batches (core/native.py):
    # 0 = auto (min(8, cores)); 1 = serial.
    decode_workers: int = 0
    # Background source prefetch (runtime/prefetch.py::PrefetchSource):
    # poll and decode run ahead of the loop on a producer thread into a
    # bounded queue of this many batches. Offsets commit on consumption,
    # and poison isolation serves unprefetched. 0 = off.
    prefetch_batches: int = 0
    # Checkpoints (io/checkpoint.py): where, and every how many finished
    # batches run() saves one.
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_batches: int = 50
    # A FULL checkpoint every K saves, deltas of the changed leaves in
    # between, chained to their base by checksum (1 = every save full).
    checkpoint_full_every: int = 1
    # Object-store checkpointers: per-op timeout in seconds (0 = wait)
    # and attempts per op (1 = no retry).
    checkpoint_op_timeout_s: float = 0.0
    checkpoint_op_attempts: int = 3
    # Base backoff between crash restarts (doubling, full jitter, capped;
    # 0 = restart at once). Stall restarts never back off.
    restart_backoff_ms: float = 0.0
    # Non-finite guard: rows whose score or emitted features reach the
    # host NaN/Inf go to the dead-letter sink (reason=nonfinite) and the
    # batch is re-scored from the pre-batch state without them. Needs a
    # dead-letter sink; snapshots what the step writes before every
    # batch and serves at depth 1 while on.
    nan_guard: bool = False
    # Broker partitions of the transaction topic: a Kafka fleet gives
    # each process a contiguous block of them.
    n_partitions: int = 8
    # The overload-survival ladder (see OverloadConfig).
    overload: OverloadConfig = field(default_factory=OverloadConfig)
    # The fleet's process topology (see DistributedConfig).
    distributed: DistributedConfig = field(
        default_factory=DistributedConfig)

    def __post_init__(self):
        if self.z_mode not in ("auto", "f32", "bf16", "int8"):
            raise ValueError(
                f"z_mode must be 'auto', 'f32', 'bf16' or 'int8', "
                f"got {self.z_mode!r}")


@dataclass(frozen=True)
class LearnConfig:
    """Continuous learning: streaming retrain → versioned registry →
    shadow scoring → gated canary promotion (``runtime/learner.py``,
    ``io/registry.py``). A candidate warm-starts from the champion, fits
    the labeled-feedback window off the loop thread, shadow-scores the
    same live batches, and is promoted (and rolled back) from live
    precision/recall."""

    # Registry location: a local directory ("" = no registry; s3://
    # waits for ROADMAP A9).
    registry_path: str = ""
    # Publish a candidate version after this many NEW labeled rows have
    # been trained since the last publish.
    publish_every_labels: int = 512
    # Bounded replay window of recent labeled rows the learner re-fits
    # per submission (host memory ≈ window_rows × 15 × 4 bytes).
    window_rows: int = 4096
    # Fit passes over the replay window per submitted label chunk.
    epochs: int = 2
    # Bounded learner queue (label chunks); a full queue DROPS (counted
    # in rtfds_learner_dropped_labels_total) — serving never waits.
    queue_chunks: int = 8
    # Learner SGD step size (0 = inherit train.online_learning_rate).
    learning_rate: float = 0.0
    # Shadow score cache rows (tx_id → champion/candidate probs kept
    # until the label arrives; direct-mapped like the FeatureCache).
    shadow_cache_rows: int = 1 << 16
    # Fraud decision threshold used for live precision/recall and for
    # divergence (decision-flip) counting.
    decision_threshold: float = 0.5
    # |p_candidate − p_champion| above this counts as divergence even
    # without a decision flip.
    divergence_threshold: float = 0.25
    # Promotion gate: BOTH models must have this many labeled rows in
    # the current comparison window, AND the candidate's live recall
    # must beat the champion's by promote_margin without giving up more
    # than precision_tolerance of live precision.
    promote_min_labels: int = 256
    promote_margin: float = 0.01
    precision_tolerance: float = 0.02
    # Post-promotion canary watch: after rollback_min_labels labeled
    # rows, the new champion must hold its pre-promotion recall baseline
    # within rollback_margin or the promotion is rolled back.
    rollback_min_labels: int = 256
    rollback_margin: float = 0.05
    # Without an in-stream learner (tree kinds), the loop polls the
    # registry for externally published candidates every this many
    # batches (one backend listing per poll). 0 disables.
    external_poll_batches: int = 64


@dataclass(frozen=True)
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    features: FeatureConfig = field(default_factory=FeatureConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)
    learn: LearnConfig = field(default_factory=LearnConfig)

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)
