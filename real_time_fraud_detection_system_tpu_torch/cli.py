"""Command line of the port: ``score``, the serving entry point, and the
offline side, ``train``, ``compare`` and ``select``:

    python -m real_time_fraud_detection_system_tpu_torch.cli score \\
        --data txs.npz --model-file model.npz --out analyzed/
    python -m real_time_fraud_detection_system_tpu_torch.cli train \\
        --data txs.npz --model logreg --out-model model.npz

``train`` replays the table through the online featurizer, splits it
train/delay/test (153/30/30 days by default), fits one kind of the zoo,
writes the artifact (the JAX package's ``.npz`` v1) and prints the test
metrics as one JSON line. ``compare`` fits several kinds on one split and
prints their metrics and fit/predict seconds; ``select`` runs the
prequential grid search (``--grid field=v1,v2`` over ``ModelConfig`` and
``TrainConfig`` fields) and prints the best parameters per metric. They
take the JAX commands' flags, defaults and choices, and their last line
has the JAX commands' JSON shape. The tree and forest kinds need sklearn
and ``--plots-dir`` needs matplotlib: without them these exit 2 naming
the package.

``score`` reads the artifacts that the JAX package's ``datagen`` and ``train``
commands write (a transactions ``.npz`` and a model ``.npz``), or the
port's own, replays the table through
:class:`~.runtime.engine.ScoringEngine` and prints the run's stats as one
JSON line at the end. The flags it shares with the JAX ``score`` take
their names, defaults and checks; ``--device`` (default ``cuda``, on
every subcommand) is the port's own. ``--checkpoint-dir`` checkpoints
the stream (``--resume`` continues from it); ``--max-restarts`` runs it
under the fault supervisor (``runtime/faults.py``) with the stall watchdog
(``--stall-timeout``) and poison isolation into ``--dead-letter``. The
checkpoints are the JAX package's format: either package resumes the
other's. ``--key-mode exact`` serves the tiered feature store, with
``--state-compact-every``, ``--state-hbm-budget-mb`` and the host cold
tier (``--cold-store``, ``--cold-promote-queue``, ``--cold-segment-mb``).
The learning loop: ``--online-lr`` (in-step SGD), ``--feedback-bootstrap``
and ``--feedback-topic`` (delayed labels from Kafka), ``--reload-model-every``
(hot reload of ``--model-file``, gated on its mtime), and ``--learn-registry``
with its promotion flags (the versioned registry, the streaming learner,
shadow scoring, promotion and rollback). Every kind of the model zoo is
served (logreg, mlp, tree, forest, gbt, autoencoder, sequence); the
sequence kind exits 2 on ``--online-lr``, ``--feedback-bootstrap``,
``--learn-registry`` and ``--key-mode exact``, as the JAX ``score``
refuses them.
The serving extras: ``--precompile`` (one CUDA graph per batch bucket),
``--autobatch`` and ``--latency-slo-ms``, ``--emit-threshold`` (selective
emission), ``--emit-bf16``, ``--nan-guard`` (with ``--dead-letter``) and
``--overload`` with its ``--overload-*`` thresholds, refused in the
combinations the JAX ``score`` refuses, with its exit code 2.
Ingest: ``--source replay`` (a generated ``.npz``), ``kafka``
(``--bootstrap``, ``--topic``, ``--idle-timeout``; needs
``confluent_kafka``) or ``raw-table`` (``--data`` a raw-transactions table
directory, ``--from-date``/``--to-date``); ``--prefetch-batches`` polls
and decodes ahead of the loop; ``--raw-table`` also lands the raw rows in
a day-partitioned Parquet table. ``--scorer cpu`` rescores on the host
with the model's NumPy ``predict_proba_np``. Observability:
``--metrics-port`` (``/metrics``, ``/metrics.json``, ``/healthz`` with
``--healthz-max-batch-age`` and ``--healthz-max-lag-rows``, ``/trace``),
``--metrics-dump``, ``--flight-record`` (``--flight-record-max-mb``),
``--trace-out`` (the spans as Chrome-trace JSON) and ``--trace-dir`` (a
``torch.profiler`` trace).
``--devices N`` serves N shards (``runtime/sharded_engine.py``), all on
the one device ``--device`` names; ``--max-batch-rows`` sizes the sharded
step, as in the JAX ``score``; with ``--key-mode exact`` each shard has
its own key directory, sketch replicas, compaction
(``--state-compact-every``) and cold-tier traffic (``--cold-store``).
The fleet: ``--num-processes P --process-id p`` makes this process one of
P, serving the customer residue block ``[p·devices, (p+1)·devices)`` of
the ``P·devices`` global shards (``runtime/distributed.py``), with its
checkpoints, sink parts, raw table and cold tier under ``proc-NN/`` of
the roots given; ``--coordinator host:port`` joins a gloo process group
first (its barrier is the fleet's rendezvous; no collective crosses
processes while serving). ``--cms-exchange DIR`` exchanges the terminal
sketch between processes at checkpoints; ``--drain-on-sigterm`` turns a
SIGTERM into a drain to a final checkpoint; ``--resume-merge
OLD:P:L:REASON`` (with ``--resume-merge-cold``) adopts a drained fleet's
checkpoints before serving. The port's launcher,
``tools/multihost_launcher.py`` in this package, spawns and watches the
workers and resizes an elastic fleet.
Not ported yet: object-store input and output (ROADMAP A9), the sequence
kind over shards (A7d), and the other JAX subcommands (``datagen``,
``registry``, ``import-model``, the operator tools: A9).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import logging
import math
import os
import sys
from typing import List, Optional

log = logging.getLogger("score")


def _json_line(obj) -> str:
    """Strict JSON: NaN and infinite floats become null."""

    def clean(v):
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if isinstance(v, float) and not math.isfinite(v):
            return None
        return v

    return json.dumps(clean(obj))


def _make_model_reloader(path: str, kind: str, every_batches: int, log,
                         seed_initial: bool = False, sig_state=None,
                         device=None):
    """Hot model reload: every ``every_batches`` batches re-read the
    artifact at ``path`` and return ``(params, scaler)`` for the engine to
    swap in between steps, or None. The file's mtime gates the read, so an
    unchanged artifact costs one stat per interval (the JAX reloader's
    ETag and digest gates are for object-store artifacts, ROADMAP A9).

    ``seed_initial=False``: the first due interval always reloads (a
    supervisor's fresh reloader must re-apply the newest artifact over a
    restored checkpoint). ``seed_initial=True`` (``--learn-registry``):
    the mtime at startup is the baseline and only a change reloads (the
    registry's champion, not the bootstrap file, is what serves);
    ``sig_state``, one dict shared across incarnations and seeded once,
    keeps that baseline. An artifact of another kind is refused."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        device_params_for,
    )

    # "n" (the cadence) is per incarnation; "sig" lives in sig_state
    state = sig_state if sig_state is not None else {}
    state.setdefault("sig", None)
    state["n"] = 0
    if seed_initial and state["sig"] is None:
        try:
            state["sig"] = os.stat(path).st_mtime_ns
        except OSError as e:
            log.warning("could not baseline %s for change-gated reload "
                        "(%s); the first interval will reload it", path, e)

    def poll():
        state["n"] += 1
        if state["n"] % every_batches:
            return None
        try:
            sig = os.stat(path).st_mtime_ns
            if state["sig"] is not None and sig == state["sig"]:
                return None
            m = load_model(path, device=device)
        # a failed poll keeps serving on the current weights
        except Exception as e:  # noqa: BLE001
            log.warning("model reload from %s failed (%s); serving "
                        "continues on the current weights", path, e)
            return None
        if m.kind != kind:
            log.warning("model reload skipped: artifact kind %r != "
                        "serving kind %r", m.kind, kind)
            return None
        state["sig"] = sig
        log.info("hot-swapped model weights from %s", path)
        return device_params_for(kind, m.params), m.scaler

    poll.sig_state = state
    return poll


def cmd_score(args) -> int:
    """``score``: the fleet's checks and bootstrap first (a fleet member
    joins its process group before anything else), then the run; the
    process group is destroyed on every way out (its store lives in
    process 0)."""
    if args.source != "kafka" and not args.data:
        log.error("--data is required unless --source kafka")
        return 2
    multihost = args.num_processes > 1 or bool(args.coordinator)
    if args.nan_guard and (args.devices > 1 or multihost):
        log.error("--nan-guard is not wired for the sharded engine "
                  "(--devices > 1 / multi-host); rely on the "
                  "supervisor's crash-loop bisection (--dead-letter + "
                  "--max-restarts) there")
        return 2
    if multihost and args.num_processes < 1:
        log.error("--num-processes must be >= 1, got %s",
                  args.num_processes)
        return 2
    topology = None
    if multihost:
        from real_time_fraud_detection_system_tpu_torch.config import (
            DistributedConfig,
        )
        from real_time_fraud_detection_system_tpu_torch.runtime \
            .distributed import bootstrap_distributed

        try:
            topology = bootstrap_distributed(
                DistributedConfig(
                    coordinator=args.coordinator,
                    num_processes=max(args.num_processes, 1),
                    process_id=args.process_id,
                    # a Kafka fleet slices by broker partition: residue
                    # membership is the producer's contract there
                    strict_affinity=args.source != "kafka"),
                local_devices=max(args.devices, 1))
        except (ValueError, RuntimeError) as e:
            log.error("multi-host bootstrap failed: %s", e)
            return 2
        if topology is not None:
            log.info(
                "multi-host: process %d/%d, %d local device(s), global "
                "shards [%d, %d) of %d, coordinator %s",
                topology.process_id, topology.n_processes,
                topology.local_devices, topology.owned_shards.start,
                topology.owned_shards.stop, topology.n_shards_total,
                args.coordinator or "(uncoordinated)")
    try:
        return _score(args, topology)
    finally:
        if topology is not None and topology.coordinated:
            from real_time_fraud_detection_system_tpu_torch.parallel \
                .distributed import shutdown_distributed

            shutdown_distributed()


def _score(args, topology) -> int:
    from real_time_fraud_detection_system_tpu_torch.config import Config
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )
    from real_time_fraud_detection_system_tpu_torch.io import sink as sinks
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model,
        load_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        make_checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
        batches_left,
        check_sequence_serving,
    )

    if args.decode_workers < 0 or args.prefetch_batches < 0:
        log.error("--decode-workers and --prefetch-batches must be >= 0, "
                  "got %s / %s", args.decode_workers, args.prefetch_batches)
        return 2
    if args.reload_model_every > 0 and args.scorer == "cpu":
        log.error("--reload-model-every does not compose with "
                  "--scorer cpu (the oracle model is fixed at startup)")
        return 2
    # any topology takes the sharded engine (one per fleet process)
    sharded = args.devices > 1 or topology is not None
    if args.max_batch_rows < 0:
        log.error("--max-batch-rows must be >= 0, got %s",
                  args.max_batch_rows)
        return 2
    if args.crash_loop_k < 1:
        log.error("--crash-loop-k must be >= 1, got %s", args.crash_loop_k)
        return 2
    if args.restart_backoff_ms < 0:
        log.error("--restart-backoff-ms must be >= 0, got %s",
                  args.restart_backoff_ms)
        return 2
    if args.checkpoint_full_every < 1:
        log.error("--checkpoint-full-every must be >= 1, got %s",
                  args.checkpoint_full_every)
        return 2
    if args.checkpoint_op_attempts < 1 or args.checkpoint_op_timeout < 0:
        log.error("--checkpoint-op-attempts must be >= 1 and "
                  "--checkpoint-op-timeout >= 0, got %s / %s",
                  args.checkpoint_op_attempts, args.checkpoint_op_timeout)
        return 2
    if args.max_restarts > 0 and not args.checkpoint_dir:
        log.error("--max-restarts requires --checkpoint-dir "
                  "(there is nothing to recover from without checkpoints)")
        return 2
    if args.stall_timeout > 0 and not (args.max_restarts > 0
                                       and args.checkpoint_dir):
        log.error("--stall-timeout requires supervised mode "
                  "(--max-restarts with --checkpoint-dir); without it the "
                  "watchdog has no restart path to escalate into")
        return 2
    if args.nan_guard and not args.dead_letter:
        log.error("--nan-guard needs --dead-letter: quarantined rows "
                  "must land somewhere an operator can triage them")
        return 2
    if args.alerts_only and (args.scorer == "cpu"
                             or args.feedback_bootstrap):
        log.error("--alerts-only keeps features on the device; it does not "
                  "compose with --scorer cpu or the feedback loop (both "
                  "consume host-side feature rows)")
        return 2
    if args.emit_bf16 and (args.scorer == "cpu" or args.feedback_bootstrap):
        log.error("--emit-bf16 rounds the emitted feature columns; "
                  "--scorer cpu and the feedback loop re-consume them "
                  "and would drift — keep float32 emission")
        return 2
    if not 0.0 <= args.emit_threshold <= 1.0:
        log.error("--emit-threshold must be a probability in [0, 1], "
                  "got %s", args.emit_threshold)
        return 2
    if args.emit_threshold > 0:
        bad = None
        if args.alerts_only:
            bad = ("--emit-threshold emits flagged rows' features; "
                   "--alerts-only emits none — pick one")
        elif args.emit_bf16:
            bad = ("--emit-threshold already cuts feature D2H ~100x at "
                   "alert-rate traffic; it does not compose with "
                   "--emit-bf16 (the packed transfer is f32)")
        elif args.scorer == "cpu" or args.feedback_bootstrap:
            bad = ("--emit-threshold keeps clean rows' features on the "
                   "device; --scorer cpu and the feedback loop consume "
                   "every row's features host-side")
        if bad:
            log.error(bad)
            return 2
        if args.out:
            log.info("selective emission: feature columns at %s are "
                     "populated only for rows with prob >= %.3g "
                     "(zeros elsewhere)", args.out, args.emit_threshold)
    if args.latency_slo_ms < 0:
        log.error("--latency-slo-ms must be >= 0, got %s",
                  args.latency_slo_ms)
        return 2
    cfg = Config()
    try:
        overload_cfg = dataclasses.replace(
            cfg.runtime.overload,
            enabled=args.overload,
            spill_path=args.overload_spill,
            lag_high_rows=args.overload_lag_high,
            climb_pressure=args.overload_climb_pressure,
            descend_pressure=args.overload_descend_pressure,
            climb_dwell_batches=args.overload_climb_dwell,
            descend_dwell_batches=args.overload_descend_dwell,
            max_deferred_batches=args.overload_max_deferred,
        )
    except ValueError as e:
        log.error("--overload thresholds: %s", e)
        return 2
    if args.overload:
        log.info(
            "overload ladder on: climb >= %.2f for %d, descend <= %.2f "
            "for %d, lag high %s rows, spill %r",
            overload_cfg.climb_pressure, overload_cfg.climb_dwell_batches,
            overload_cfg.descend_pressure,
            overload_cfg.descend_dwell_batches,
            overload_cfg.lag_high_rows or "off",
            overload_cfg.spill_path or "(memory only)")
    cfg = dataclasses.replace(
        cfg,
        runtime=dataclasses.replace(
            cfg.runtime,
            scorer=args.scorer,
            max_batch_rows=(args.max_batch_rows
                            or cfg.runtime.max_batch_rows),
            emit_features=not args.alerts_only,
            emit_dtype="bfloat16" if args.emit_bf16 else "float32",
            emit_threshold=args.emit_threshold,
            pipeline_depth=args.pipeline_depth,
            coalesce_rows=args.coalesce_rows,
            precompile=args.precompile,
            # an SLO implies the controller: the knob is the intent
            autobatch=args.autobatch or args.latency_slo_ms > 0,
            latency_slo_ms=args.latency_slo_ms,
            nan_guard=args.nan_guard,
            overload=overload_cfg,
            z_mode=args.z_mode,
            async_sink=args.async_sink,
            sink_queue_batches=args.sink_queue_batches,
            decode_workers=args.decode_workers,
            prefetch_batches=args.prefetch_batches,
            fetch_overlap=not args.no_fetch_overlap,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_full_every=args.checkpoint_full_every,
            checkpoint_op_timeout_s=args.checkpoint_op_timeout,
            checkpoint_op_attempts=args.checkpoint_op_attempts,
            restart_backoff_ms=args.restart_backoff_ms,
        ),
    )
    # the feature-plane knobs (the tiered feature store)
    if args.state_compact_every > 0 and args.key_mode != "exact":
        log.error("--state-compact-every only applies to --key-mode "
                  "exact (direct/hash tables have no slot allocator to "
                  "reclaim into)")
        return 2
    try:
        cfg = dataclasses.replace(cfg, features=dataclasses.replace(
            cfg.features,
            key_mode=args.key_mode,
            compact_every=args.state_compact_every,
            state_hbm_budget_mb=args.state_hbm_budget_mb,
            cold_store=args.cold_store,
            cold_promote_queue=args.cold_promote_queue,
            cold_segment_mb=args.cold_segment_mb,
        ))
    except ValueError as e:
        log.error("feature-plane config: %s", e)
        return 2
    if args.key_mode == "exact" or args.state_hbm_budget_mb > 0:
        from real_time_fraud_detection_system_tpu_torch.features.online \
            import state_bytes

        sb = state_bytes(cfg.features, n_shards=max(args.devices, 1))
        if 0 < args.state_hbm_budget_mb * 2 ** 20 < sb["total"]:
            log.error(
                "--state-hbm-budget-mb %g cannot hold the configured "
                "feature state (%.1f MB: run with a larger budget, or "
                "shrink customer/terminal capacity or cms_width)",
                args.state_hbm_budget_mb, sb["total"] / 2 ** 20)
            return 2
        if args.key_mode == "exact":
            log.info(
                "tiered feature store: hot tier %d+%d slots, compaction "
                "every %s batches, state %.1f MB (dense %.1f, directory "
                "%.1f, cms %.1f)", cfg.features.customer_capacity,
                cfg.features.terminal_capacity,
                args.state_compact_every or "off", sb["total"] / 2 ** 20,
                sb["dense"] / 2 ** 20, sb["directory"] / 2 ** 20,
                sb["cms"] / 2 ** 20)
    if args.alerts_only and args.out:
        log.warning("--alerts-only: the analyzed output at %s will carry "
                    "zero feature columns (predictions only)", args.out)
    cfg = dataclasses.replace(cfg, learn=dataclasses.replace(
        cfg.learn,
        registry_path=args.learn_registry,
        publish_every_labels=args.publish_every_labels,
        promote_min_labels=args.promote_min_labels,
        promote_margin=args.promote_margin,
        rollback_min_labels=args.rollback_min_labels,
        rollback_margin=args.rollback_margin,
    ))
    if args.learn_registry:
        bad = None
        if sharded:
            bad = ("--learn-registry is not wired for the sharded "
                   "engine (--devices > 1 / multi-host)")
        elif args.scorer == "cpu":
            bad = ("--learn-registry promotes by swapping on-device "
                   "params; --scorer cpu classifies host-side with a "
                   "model fixed at startup")
        elif args.alerts_only or args.emit_threshold > 0 or args.emit_bf16:
            bad = ("shadow scoring re-consumes every row's features "
                   "host-side; it does not compose with --alerts-only, "
                   "--emit-threshold or --emit-bf16")
        if bad:
            log.error(bad)
            return 2
        if not args.feedback_bootstrap:
            log.warning(
                "continuous learning without --feedback-bootstrap: no "
                "live labels arrive, so the shadow's live precision/"
                "recall windows stay empty and promotion never fires "
                "(the registry lineage still records reloads)")
    # replay reads a generated .npz; raw-table reads a table directory
    txs = (load_transactions(args.data) if args.source == "replay"
           else None)
    model = load_model(args.model_file, device=args.device)
    if sharded and args.scorer == "cpu":
        log.error("--scorer cpu is the single-host sklearn oracle; it does "
                  "not compose with --devices > 1 or multi-host (the "
                  "sharded engine always scores on-device)")
        return 2
    if sharded and model.kind == "sequence":
        log.error("the sequence kind over --devices > 1 shards is not "
                  "ported yet: ROADMAP A7d")
        return 2
    if model.kind == "sequence":
        # fail fast with the CLI convention: the engine's own refusals,
        # before any state is built
        try:
            check_sequence_serving(
                cfg, args.online_lr, feedback=bool(args.feedback_bootstrap),
                shadow=bool(args.learn_registry), scorer=args.scorer)
        except ValueError as e:
            log.error("%s", e)
            return 2
    # the oracle: the artifact's pure-NumPy predict on the host
    cpu_model = model if args.scorer == "cpu" else None
    # with --learn-registry the registry's champion, not the bootstrap
    # file, is what serves: the reloader swaps only on a CHANGE after
    # startup, against one baseline shared across incarnations
    reload_sig: dict = {}
    make_reloader = (
        (lambda: _make_model_reloader(
            args.model_file, model.kind, args.reload_model_every, log,
            seed_initial=bool(args.learn_registry),
            sig_state=reload_sig if args.learn_registry else None,
            device=args.device))
        if args.reload_model_every > 0 else None)
    feature_cache = None
    make_feedback = None
    if args.feedback_bootstrap:
        from real_time_fraud_detection_system_tpu_torch.runtime.feedback \
            import FeatureCache, FeedbackLoop, KafkaFeedbackSource

        feature_cache = FeatureCache()

        def make_feedback(engine):
            # a fresh consumer session per incarnation; non-blocking polls
            # (the loop polls between batches, the topic is usually quiet)
            return FeedbackLoop(
                engine,
                KafkaFeedbackSource(args.feedback_bootstrap,
                                    topic=args.feedback_topic,
                                    poll_timeout_s=0.0))

    learning = None
    if args.learn_registry:
        learning, model = _make_learning(args, cfg, model)
        if learning is None:
            return 2

    dead_letter = None
    if args.dead_letter:
        dead_letter = sinks.make_dead_letter_sink(args.dead_letter)
        log.info("dead-letter queue: %s (%d row(s) already quarantined)",
                 args.dead_letter, len(dead_letter))

    out_path, raw_path = args.out, args.raw_table
    ckpt_dir = cfg.runtime.checkpoint_dir
    if topology is not None:
        # each process owns its residue block's lineage under proc-NN/ of
        # the shared roots (the same path across restarts, so --resume
        # finds its block; a topology change is refused at restore, the
        # merge named); sink parts and the cold tier split the same way
        sub = f"proc-{topology.process_id:02d}"
        ckpt_dir = os.path.join(ckpt_dir, sub) if ckpt_dir else ckpt_dir
        out_path = os.path.join(out_path, sub) if out_path else out_path
        raw_path = os.path.join(raw_path, sub) if raw_path else raw_path
        if cfg.features.cold_store:
            cfg = dataclasses.replace(cfg, features=dataclasses.replace(
                cfg.features,
                cold_store=os.path.join(cfg.features.cold_store, sub)))

    def make_engine():
        if sharded:
            from real_time_fraud_detection_system_tpu_torch.runtime \
                .sharded_engine import ShardedScoringEngine

            eng = ShardedScoringEngine(
                cfg, model.kind, model.params, model.scaler,
                n_devices=args.devices, device=args.device,
                online_lr=args.online_lr, feature_cache=feature_cache,
                dead_letter=dead_letter, topology=topology)
        else:
            eng = ScoringEngine(
                cfg, model.kind, model.params, model.scaler,
                device=args.device, online_lr=args.online_lr,
                feature_cache=feature_cache, dead_letter=dead_letter,
                scorer=args.scorer, cpu_model=cpu_model)
        eng.stop_event = drain_ev
        eng.cms_exchange = cms_exchange
        return eng

    rt = cfg.runtime
    ckpt = make_checkpointer(
        ckpt_dir,
        full_every=rt.checkpoint_full_every,
        op_timeout_s=rt.checkpoint_op_timeout_s,
        op_attempts=rt.checkpoint_op_attempts,
    ) if ckpt_dir else None
    # the elastic fleet's seams (the launcher's --autoscale)
    drain_ev = None
    if args.drain_on_sigterm:
        import signal
        import threading

        drain_ev = threading.Event()
        # repeated SIGTERMs keep one drain in flight; the engine stops at
        # the next batch boundary, its offsets behind durable output
        signal.signal(signal.SIGTERM, lambda _sig, _frm: drain_ev.set())
        log.info("drain-on-sigterm armed: SIGTERM = coordinated drain "
                 "to a final checkpoint, not a kill")
    cms_exchange = None
    if args.cms_exchange and topology is None:
        # not an error: an elastic fleet passes uniform worker args and
        # may shrink to one process, whose aggregates are already global
        log.info("--cms-exchange idle: single-process terminal "
                 "aggregates are already global")
    elif args.cms_exchange:
        from real_time_fraud_detection_system_tpu_torch.runtime \
            .cms_exchange import SketchExchange

        cms_exchange = SketchExchange(
            args.cms_exchange, topology.process_id, topology.n_processes)
        log.info("terminal-sketch exchange: %s (fleet-wide merge at "
                 "checkpoint boundaries, locals-only partials in "
                 "checkpoints)", args.cms_exchange)
    floors = None
    merge_old = (0, 0)
    if args.resume_merge:
        try:
            src_root, p_s, l_s, reason = args.resume_merge.rsplit(":", 3)
            merge_old = (int(p_s), int(l_s))
            if not src_root or min(merge_old) < 1:
                raise ValueError(args.resume_merge)
        except ValueError:
            log.error("--resume-merge wants OLD_CKPT_ROOT:P:L:REASON, "
                      "got %r", args.resume_merge)
            return 2
        bad = None
        if ckpt is None:
            bad = "--resume-merge requires --checkpoint-dir"
        elif not args.resume:
            bad = ("--resume-merge requires --resume (the merged "
                   "checkpoint is what this worker resumes from)")
        elif args.source == "kafka":
            bad = ("--resume-merge does not apply to --source kafka "
                   "(broker fleets carry per-partition offsets through "
                   "a resize; no single-cursor merge is needed)")
        elif args.resume_merge_cold and not cfg.features.cold_store:
            bad = "--resume-merge-cold requires --cold-store"
        if bad:
            log.error(bad)
            return 2
        floors = _resume_merge_adopt(
            make_engine, ckpt, cfg, topology,
            (src_root, merge_old[0], merge_old[1], reason),
            [d for d in args.resume_merge_cold.split(",") if d])
        if floors is None:
            return 2

    try:
        source, source_factory = _make_source(
            args, cfg, txs, topology=topology, floors=floors,
            old_topology=merge_old)
    except (FileNotFoundError, ValueError) as e:
        log.error("%s", e)
        return 2
    sink = sinks.make_parquet_sink(out_path) if out_path else None
    raw_table = None
    if args.raw_table:
        from real_time_fraud_detection_system_tpu_torch.io.tables import (
            RawTransactionsTable,
        )

        raw_table = RawTransactionsTable(raw_path, flush_every_batches=64)
        sink = sinks.FanoutSink(sink, raw_table)
    if cfg.runtime.async_sink and sink is not None:
        # outside the fanout: one writer serves every destination in order
        sink = sinks.AsyncSink(sink,
                               max_queue=cfg.runtime.sink_queue_batches)
    obs = _Observability(args, cfg, model.kind)
    fb = None
    try:
        with obs.profile():
            if ckpt is not None and args.max_restarts > 0:
                from real_time_fraud_detection_system_tpu_torch.runtime \
                    .faults import RetryPolicy, run_with_recovery

                backoff = None
                if rt.restart_backoff_ms > 0:
                    # doubling, full jitter, capped at 30 s
                    backoff = RetryPolicy(
                        base_delay_s=rt.restart_backoff_ms / 1000.0,
                        multiplier=2.0, max_delay_s=30.0, jitter=1.0)
                stats = run_with_recovery(
                    make_engine, source, ckpt, sink=sink,
                    max_restarts=args.max_restarts,
                    max_batches=args.max_batches, resume=args.resume,
                    stall_timeout_s=args.stall_timeout,
                    make_source=source_factory,
                    crash_loop_k=args.crash_loop_k, dead_letter=dead_letter,
                    restart_backoff=backoff, make_feedback=make_feedback,
                    make_model_reload=make_reloader, learning=learning)
            else:
                engine = make_engine()
                if ckpt is not None and args.resume:
                    if ckpt.restore(engine.state) is not None:
                        source.seek(engine.state.offsets)
                        log.info("resumed from batch %d",
                                 engine.state.batches_done)
                    truncate = getattr(sink, "truncate_after", None)
                    if truncate is not None:
                        truncate(engine.state.batches_done)
                fb = make_feedback(engine) if make_feedback else None
                # --max-batches counts the engine's lifetime batches,
                # restored ones included, as the JAX score does
                stats = engine.run(
                    source, sink=sink, checkpointer=ckpt,
                    max_batches=batches_left(engine.state, args.max_batches),
                    feedback=fb,
                    model_reload=make_reloader() if make_reloader else None,
                    learning=learning)
                if drain_ev is not None and ckpt is not None:
                    # a drain-armed worker: run() ended (a SIGTERM or the
                    # stream's end) at a batch boundary, the sink drained
                    # and the cold lineage fresh — the FINAL checkpoint
                    # lands at exactly that frontier, so a resize merge
                    # resumes without gaps or duplicates
                    ckpt.save(engine.checkpoint_state())
                    if drain_ev.is_set():
                        stats["drained_at_batch"] = \
                            engine.state.batches_done
                        log.info("coordinated drain complete: final "
                                 "checkpoint at batch %d",
                                 engine.state.batches_done)
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()
        if isinstance(sink, sinks.AsyncSink):
            sink.close()
        if fb is not None:
            fb.close()
        if learning is not None:
            learning.close()
        obs.close()
    if raw_table is not None:
        raw_table.flush()
        stats["raw_tx_rows"] = len(raw_table)
    if dead_letter is not None:
        stats["dead_letter_rows"] = len(dead_letter)
        dead_letter.close()
    if topology is not None:
        stats.update(
            num_processes=topology.n_processes,
            process_id=topology.process_id,
            owned_shards=[topology.owned_shards.start,
                          topology.owned_shards.stop])
    print(_json_line({"device": str(resolve_device(args.device)),
                      "kind": model.kind, "scorer": args.scorer, **stats}))
    return 0


def _resume_merge_adopt(make_engine, ckpt, cfg, topology, spec,
                        cold_srcs):
    """Adopt a drained old fleet's final checkpoints into THIS worker's
    own (empty) lineage: the retopologize leg of a fleet resize.

    ``spec`` is ``--resume-merge`` parsed, ``(src_root, old_p, old_l,
    reason)``. Every old process's final checkpoint restores into a
    template state, the feature states merge
    (``parallel/mesh.py::merge_process_states``; the checkpointed
    terminal sketches are locals-only partials, so same-day sums stay
    exact), the old cold stores consolidate into this worker's, and ONE
    single-process global checkpoint lands in this worker's lineage with
    the cursor at the fleet's minimum floor. The per-old-owner floors
    ride in a ``resize_epochs`` record, so rows another old process
    already sank are dropped at ingest (``OwnershipFloorSource``).
    Idempotent: a worker relaunched after its merge landed reads the
    floors back from its newest checkpoint.

    Returns the floors (empty: no filtering needed) or None on failure,
    and the caller exits 2: serving without the merged state would break
    exactly-once."""
    import copy
    import time

    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        make_checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        merge_process_states,
    )

    t0 = time.perf_counter()
    src_root, old_p, old_l, reason = spec
    latest = ckpt.latest()
    if latest is not None:
        # a crash AFTER the merge committed: this lineage already starts
        # from the merged state; the floors are in its resize epoch
        try:
            meta = (ckpt.manifest(latest) or {}).get("meta") or {}
        except (OSError, ValueError, KeyError):
            meta = {}
        epochs = meta.get("resize_epochs") or []
        if epochs:
            rec = epochs[-1]
            log.info("resume-merge: lineage already merged (epoch %s, "
                     "%s->%s); resuming from it", len(epochs),
                     rec.get("from_processes"), rec.get("to_processes"))
            return [int(f) for f in rec.get("floors", [])]
        log.warning("resume-merge: %s already has ordinary checkpoints; "
                    "skipping the merge and resuming from them", latest)
        return []
    tmpl = make_engine()
    eng_l = int(getattr(tmpl.state, "layout_devices", 1) or 1)
    if old_l != eng_l:
        log.error("--resume-merge: old fleet served %d device(s) per "
                  "process but this worker serves %d — resize the "
                  "process count at fixed width, then change width "
                  "separately (the per-process reshard path)",
                  old_l, eng_l)
        return None
    states, floors, rows_done = [], [], 0
    prior_epochs: list = []
    model_version = None
    for pid in range(old_p):
        src_dir = (os.path.join(src_root, f"proc-{pid:02d}")
                   if old_p > 1 else src_root)
        try:
            src = make_checkpointer(
                src_dir,
                op_timeout_s=cfg.runtime.checkpoint_op_timeout_s,
                op_attempts=cfg.runtime.checkpoint_op_attempts)
        except (OSError, ValueError) as e:
            log.error("resume-merge: cannot open old checkpoints at "
                      "%s: %s", src_dir, e)
            return None
        st = copy.copy(tmpl.state)
        st.process_count, st.process_id = old_p, pid
        st.layout_devices = old_l
        restored = src.restore(st)
        if restored is None:
            log.error("resume-merge: old process %d has no restorable "
                      "checkpoint under %s — a resize must drain to a "
                      "final checkpoint first", pid, src_dir)
            return None
        if len(restored.offsets) > 1:
            log.error("resume-merge: old process %d carries %d stream "
                      "cursors; only single-cursor sources resize "
                      "(broker fleets keep per-partition offsets)",
                      pid, len(restored.offsets))
            return None
        # no cursor: the process drained before its first poll
        floors.append(int(restored.offsets[0]) if restored.offsets
                      else 0)
        rows_done += int(restored.rows_done)
        if model_version is None:
            model_version = restored.model_version
        if not prior_epochs:
            prior_epochs = list(restored.resize_epochs or [])
        fs = (restored.layout_pending if restored.layout_pending
              is not None else restored.feature_state)
        # a host copy: the next restore writes the template's tensors
        states.append(_host_tree(fs))
    try:
        merged_fs = merge_process_states(states, cfg, [old_l] * old_p)
    except ValueError as e:
        log.error("resume-merge: %s", e)
        return None
    out = copy.copy(tmpl.state)
    out.feature_state = merged_fs
    out.layout_pending = None
    out.ready = None
    out.offsets = [min(floors)]
    out.batches_done = 0  # a fresh per-generation sink lineage
    out.rows_done = rows_done
    out.layout_devices = 1
    out.process_count = 1  # a global state; restore re-slices per process
    out.process_id = 0
    out.model_version = model_version
    new_p = topology.n_processes if topology is not None else 1
    out.resize_epochs = prior_epochs + [{
        "epoch": len(prior_epochs) + 1,
        "from_processes": old_p,
        "to_processes": new_p,
        "old_local_devices": old_l,
        "reason": reason,
        "floors": floors,
        "min_offset": min(floors),
    }]
    if cold_srcs:
        from real_time_fraud_detection_system_tpu_torch.io.coldstore import (
            ColdStoreCorruptError,
            consolidate_cold_stores,
        )

        try:
            dest = consolidate_cold_stores(
                cold_srcs, cfg.features.cold_store,
                segment_mb=cfg.features.cold_segment_mb)
        except (OSError, ValueError, ColdStoreCorruptError) as e:
            log.error("resume-merge: cold-store consolidation failed: "
                      "%s", e)
            return None
        out.cold_lineage = dest.lineage()
        log.info("resume-merge: consolidated %d cold generation(s) "
                 "into %s (%d keys)", len(cold_srcs),
                 cfg.features.cold_store,
                 int(out.cold_lineage.get("total_keys", 0)))
    saved = ckpt.save(out)
    log.info("resume-merge: adopted %d-process generation at %s -> %s "
             "(floors %s, min offset %d, reason %r) in %.1f ms",
             old_p, src_root, saved, floors, min(floors), reason,
             (time.perf_counter() - t0) * 1e3)
    return floors


def _host_tree(state):
    """A state tree's tensors copied to host arrays."""
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    def host(leaf):
        detach = getattr(leaf, "detach", None)
        if detach is not None:
            return detach().cpu().numpy().copy()
        return leaf

    return tree.map(host, state)


def _make_source(args, cfg, txs, topology=None, floors=None,
                 old_topology=(0, 0)):
    """``--source``: the replay of a generated table, a Kafka consumer,
    or a raw-table backfill; wrapped in a :class:`~.runtime.prefetch.
    PrefetchSource` with ``--prefetch-batches``. Returns ``(source,
    factory)``: the factory (Kafka only) builds a fresh consumer, and
    prefetcher, for each supervised incarnation, else None.

    In a fleet (``topology``) a Kafka consumer is assigned this process's
    block of partitions; any other source is wrapped in
    :class:`~.runtime.sources.PartitionAffineSource` (its residue slice),
    inside the prefetcher. ``floors`` (after a shrink merge whose old
    processes stopped at different positions; ``old_topology`` = their
    count and width) drop re-polled rows an old owner already sank
    (:class:`~.runtime.sources.OwnershipFloorSource`), inside the
    residue slice."""
    from real_time_fraud_detection_system_tpu_torch.runtime import sources
    from real_time_fraud_detection_system_tpu_torch.utils.timing import (
        date_to_epoch_s,
    )

    factory = None
    if args.source == "kafka":
        kafka_kw = {}
        if topology is not None:
            # partition-affine ingest: this process consumes ONLY its
            # block of partitions (manual assignment)
            kafka_kw = dict(
                partitions=topology.kafka_partitions(
                    cfg.runtime.n_partitions),
                n_partitions=cfg.runtime.n_partitions,
                group_id=f"rtfds-scorer-p{topology.process_id}")
            log.info("kafka partition affinity: consuming partitions %s "
                     "of %d", kafka_kw["partitions"],
                     cfg.runtime.n_partitions)

        def factory():
            # a fresh consumer per incarnation: the broker's group
            # generation fences a zombie's session
            return sources.make_kafka_source(
                args.bootstrap, topic=args.topic,
                batch_rows=args.batch_rows,
                idle_timeout_s=args.idle_timeout or None,
                decode_workers=cfg.runtime.decode_workers, **kafka_kw)

        source = factory()
    elif args.source == "raw-table":
        source = sources.RawTableSource(
            args.data, batch_rows=args.batch_rows,
            from_day=args.from_date or None, to_day=args.to_date or None)
        log.info("raw-table backfill: %d rows", source.n)
    else:
        # the in-step SGD learns from the table's labels, in band
        source = sources.ReplaySource(
            txs, date_to_epoch_s(args.start_date),
            batch_rows=args.batch_rows, mode=args.mode,
            decode_workers=cfg.runtime.decode_workers,
            with_labels=args.online_lr > 0)
    if floors and len(set(floors)) > 1:
        source = sources.OwnershipFloorSource(source, floors,
                                              *old_topology)
        log.info("per-owner resume floors active: %s (pure passthrough "
                 "past position %d)", floors, max(floors))
    if topology is not None and args.source != "kafka":
        source = sources.PartitionAffineSource(source, topology)
        log.info("partition-affine ingest: serving residues [%d, %d) "
                 "of %d", topology.owned_shards.start,
                 topology.owned_shards.stop, topology.n_shards_total)
    depth = cfg.runtime.prefetch_batches
    if depth > 0:
        from real_time_fraud_detection_system_tpu_torch.runtime.prefetch \
            import PrefetchSource

        if factory is not None:
            inner_factory = factory

            def factory():
                return PrefetchSource(inner_factory(), max_batches=depth)

        source = PrefetchSource(source, max_batches=depth)
        log.info("source prefetch on (queue depth %d)", depth)
    return source, factory


class _Observability:
    """What ``score`` observes a run with, each from its flag: the span
    tracer (``--trace-out``, and ``--metrics-port`` so ``/trace`` serves a
    live timeline), the metrics server, the flight record, the profiler
    (``--trace-dir``), and at :meth:`close` the registry dump and the
    trace export — after a failed run too."""

    def __init__(self, args, cfg, kind: str):
        from real_time_fraud_detection_system_tpu_torch.device import (
            resolve_device,
        )
        from real_time_fraud_detection_system_tpu_torch.utils import metrics
        from real_time_fraud_detection_system_tpu_torch.utils.trace import (
            get_tracer,
        )

        self.args = args
        self.tracer = self.server = self.recorder = None
        if args.trace_dir and args.source == "kafka" and not args.max_batches:
            log.warning("--trace-dir on an unbounded Kafka stream profiles "
                        "the whole run in host memory; bound it with "
                        "--max-batches")
        if args.trace_out or args.metrics_port:
            self.tracer = get_tracer().configure(enabled=True)
            log.info("span tracing on: %s", args.trace_out
                     or "GET /trace serves the live span ring")
        if args.metrics_port:
            # 0.0.0.0: a scrape sidecar or a probe reaches it in-container
            self.server = metrics.MetricsServer(
                port=args.metrics_port, host="0.0.0.0",
                max_batch_age_s=args.healthz_max_batch_age,
                max_source_lag_rows=args.healthz_max_lag_rows or None)
            self.server.start()
            log.info("telemetry: /metrics /metrics.json /healthz /trace on "
                     "port %d", self.server.port)
        if args.flight_record:
            self.recorder = metrics.FlightRecorder(
                args.flight_record,
                manifest=metrics.run_manifest(
                    cfg=cfg, model_kind=kind, scorer=args.scorer,
                    source=args.source,
                    backend=resolve_device(args.device).type),
                max_bytes=int(args.flight_record_max_mb * 2 ** 20)
                if args.flight_record_max_mb > 0 else None)
            # process-wide: the engine, the checkpointer, the supervisor
            # and the fault injectors all append to this run's record
            metrics.set_active_recorder(self.recorder)
            log.info("flight record: %s", args.flight_record)

    def profile(self):
        from real_time_fraud_detection_system_tpu_torch.utils.tracing import (
            profile_to,
        )

        return profile_to(self.args.trace_dir or None)

    def close(self) -> None:
        from real_time_fraud_detection_system_tpu_torch.utils import metrics

        args = self.args
        if self.recorder is not None:
            metrics.set_active_recorder(None)
            self.recorder.close()
        if self.server is not None:
            self.server.stop()
        if args.metrics_dump:
            try:
                with open(args.metrics_dump, "w", encoding="utf-8") as f:
                    json.dump(metrics.get_registry().snapshot(), f)
            except OSError as e:
                log.warning("metrics dump to %s failed: %s",
                            args.metrics_dump, e)
        if self.tracer is not None and args.trace_out:
            try:
                man = self.tracer.export(args.trace_out)
                log.info("span trace: %s (%d events)", man["trace"],
                         man["events"])
            except OSError as e:
                log.warning("span trace export to %s failed: %s",
                            args.trace_out, e)


def _make_learning(args, cfg, model):
    """``--learn-registry``: the registry (a champion there supersedes
    ``--model-file``), the streaming learner for kinds with a gradient
    path, and the learning loop. Returns ``(loop, serving model)``, or
    ``(None, model)`` when the champion is of another kind (exit 2)."""
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        loss_fn_for,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
        LearningLoop,
        StreamingLearner,
    )

    registry = make_model_registry(
        args.learn_registry,
        op_timeout_s=cfg.runtime.checkpoint_op_timeout_s,
        op_attempts=cfg.runtime.checkpoint_op_attempts)
    champ_v = registry.champion_version()
    # False when a champion exists but could not be adopted: the engines
    # then serve --model-file params and the stamp must not claim otherwise
    model_is_champion = True
    if champ_v is not None:
        model_is_champion = False
        try:
            champ = registry.champion()
        # a corrupt or missing champion falls back to --model-file
        except Exception as e:  # noqa: BLE001
            log.warning(
                "registry champion v%s failed verification (%s: %s); "
                "serving the --model-file params instead",
                champ_v, type(e).__name__, e)
        else:
            if champ.kind != model.kind:
                log.error(
                    "registry champion v%s is kind=%r but --model-file is "
                    "kind=%r; point --learn-registry at this model's "
                    "registry or retrain", champ_v, champ.kind, model.kind)
                return None, model
            log.info("serving registry champion v%s (supersedes "
                     "--model-file)", champ_v)
            model = champ
            model_is_champion = True
    learner = None
    if loss_fn_for(model.kind) is not None:
        learner = StreamingLearner(
            model.kind, model.params, model.scaler, cfg, registry,
            publish_every_labels=cfg.learn.publish_every_labels,
            window_rows=cfg.learn.window_rows, epochs=cfg.learn.epochs,
            max_queue=cfg.learn.queue_chunks,
            learning_rate=cfg.learn.learning_rate or None,
            device=args.device)
    else:
        log.info("model kind %r has no gradient path: the registry records "
                 "lineage and shadow-scores externally published "
                 "candidates, but no streaming learner runs", model.kind)
    learning = LearningLoop(registry, cfg, model.kind, model=model,
                            learner=learner,
                            model_is_champion=model_is_champion,
                            device=args.device)
    log.info("continuous learning on: registry %s (champion v%s)",
             args.learn_registry, learning.champion_version)
    return learning, model


_KINDS = ["logreg", "mlp", "tree", "forest", "gbt", "autoencoder",
          "sequence"]


def _missing(log_, packages: dict) -> bool:
    """Log and report the first missing package of ``{package: what needs
    it}`` (the caller exits 2); nothing is substituted for it."""
    for pkg, what in packages.items():
        if importlib.util.find_spec(pkg) is None:
            log_.error("%s needs %s, which is not installed", what, pkg)
            return True
    return False


def _sklearn_kinds(kinds) -> dict:
    """``{"sklearn": ...}`` when any of ``kinds`` is fitted by sklearn."""
    tree_kinds = [k for k in kinds if k in ("tree", "forest")]
    return ({"sklearn": f"--model {'/'.join(tree_kinds)}"}
            if tree_kinds else {})


def _offline_config(args):
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        TrainConfig,
    )

    return Config(train=TrainConfig(
        delta_train_days=args.delta_train,
        delta_delay_days=args.delta_delay,
        delta_test_days=args.delta_test,
        epochs=args.epochs))


def cmd_train(args) -> int:
    """Offline training of one kind on a generated table: the artifact to
    ``--out-model``, the test metrics as the last line."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_transactions,
        save_model,
    )
    from real_time_fraud_detection_system_tpu_torch.models.train import (
        train_model,
    )

    tlog = logging.getLogger("train")
    if _missing(tlog, _sklearn_kinds([args.model])):
        return 2
    txs = load_transactions(args.data)
    model, metrics = train_model(txs, _offline_config(args), kind=args.model,
                                 device=args.device)
    save_model(args.out_model, model)
    tlog.info("model=%s metrics=%s -> %s", args.model,
              {k: round(v, 4) for k, v in metrics.items()}, args.out_model)
    print(_json_line({"model": args.model, **metrics}))
    return 0


def cmd_compare(args) -> int:
    """Fit every requested kind on one shared split; metrics and fit and
    predict seconds per kind (the reference's classifier comparison,
    ``model_training.ipynb · cells 50-56``), and optionally a PNG report
    per kind."""
    from real_time_fraud_detection_system_tpu_torch.features.offline import (
        compute_features_replay,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.models.train import (
        fit_and_assess,
        fit_and_assess_sequence,
        scale_split_to_txs,
        train_delay_test_split,
    )

    clog = logging.getLogger("compare")
    need = _sklearn_kinds(args.models)
    if args.plots_dir:
        need["matplotlib"] = "--plots-dir"
    if _missing(clog, need):
        return 2
    txs = load_transactions(args.data)
    cfg = _offline_config(args)
    # the sequence family scores from event histories: no replay unless a
    # feature-matrix kind was asked for
    features = (compute_features_replay(txs, cfg.features,
                                        start_date=cfg.data.start_date,
                                        device=args.device)
                if any(k != "sequence" for k in args.models) else None)
    dtr, dde, dte = scale_split_to_txs(
        txs, cfg.train.delta_train_days, cfg.train.delta_delay_days,
        cfg.train.delta_test_days)
    train_mask, test_mask = train_delay_test_split(
        txs, delta_train=dtr, delta_delay=dde, delta_test=dte)
    if args.plots_dir:
        from real_time_fraud_detection_system_tpu_torch.models.plots import (
            save_plots,
        )

        os.makedirs(args.plots_dir, exist_ok=True)
    rows = []
    for kind in args.models:
        if kind == "sequence":
            _, metrics, fit_s, pred_s, probs = fit_and_assess_sequence(
                txs, cfg, train_mask, test_mask, device=args.device)
        else:
            _, metrics, fit_s, pred_s, probs = fit_and_assess(
                txs, features, cfg, kind, train_mask, test_mask,
                device=args.device)
        row = {"model": kind,
               **{k: round(float(v), 4) for k, v in metrics.items()},
               "fit_seconds": round(fit_s, 3),
               "predict_seconds": round(pred_s, 3)}
        rows.append(row)
        clog.info("%s", row)
        if args.plots_dir:
            save_plots(os.path.join(args.plots_dir, f"{kind}.png"),
                       txs.tx_fraud[test_mask], probs, label=kind)
    print(_json_line({"split_days": [dtr, dde, dte], "models": rows}))
    return 0


def _parse_grid(specs, slog) -> Optional[dict]:
    """``field=v1,v2,...`` specs → ``{field: [values]}`` (ints, floats,
    else strings), the fields checked against ``ModelConfig`` and
    ``TrainConfig``; None (logged) on a bad spec."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        ModelConfig,
        TrainConfig,
    )

    known = {f.name for f in dataclasses.fields(ModelConfig)} | {
        f.name for f in dataclasses.fields(TrainConfig)}
    grid = {}
    for spec in specs:
        field, _, vals = spec.partition("=")
        if not vals:
            slog.error("--grid expects field=v1,v2,... (got %r)", spec)
            return None
        if field not in known:
            slog.error("--grid field %r is not a ModelConfig/TrainConfig "
                       "field (known: %s)", field, ", ".join(sorted(known)))
            return None
        parsed = []
        for v in vals.split(","):
            try:
                parsed.append(int(v))
            except ValueError:
                try:
                    parsed.append(float(v))
                except ValueError:
                    parsed.append(v)
        grid[field] = parsed
    return grid


def cmd_select(args) -> int:
    """Prequential hyper-parameter selection: the validation and test
    sweeps of the reference's ``model_selection_wrapper``
    (``shared_functions.py:774-872``); the best parameters per metric and
    the candidates' mean fit and predict seconds as the last line."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        TrainConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.features.offline import (
        compute_features_replay,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.models.selection import (
        execution_times,
        model_selection_wrapper,
        summarize_performances,
    )

    slog = logging.getLogger("select")
    # validate the grid before the data load and the feature replay
    grid = _parse_grid(args.grid, slog)
    if grid is None or _missing(slog, _sklearn_kinds([args.model])):
        return 2
    txs = load_transactions(args.data)
    cfg = Config(train=TrainConfig(epochs=args.epochs))
    features = compute_features_replay(txs, cfg.features,
                                       start_date=cfg.data.start_date,
                                       device=args.device)
    rows = model_selection_wrapper(
        txs, features, cfg, args.model, grid,
        start_day_training_for_valid=args.start_valid,
        start_day_training_for_test=args.start_test,
        n_folds=args.folds, device=args.device)
    summaries = summarize_performances(rows)
    out = {
        "model": args.model,
        "grid": grid,
        "metrics": {
            m: {"best_params": s.best_params,
                "validation": [round(s.validation_mean, 4),
                               round(s.validation_std, 4)],
                "test": [round(s.test_mean, 4), round(s.test_std, 4)]}
            for m, s in summaries.items()
        },
        "execution_times": execution_times(rows),
    }
    slog.info("best by auc_roc: %s", summaries["auc_roc"].best_params)
    print(_json_line(out))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m real_time_fraud_detection_system_tpu_torch.cli",
        description="PyTorch/CUDA port of the real-time fraud detection "
                    "serving path")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("score", help="stream-score a table through the "
                                     "engine")
    p.add_argument("--data", default="",
                   help="transactions .npz (as the JAX datagen writes), or "
                        "with --source raw-table a raw-transactions table "
                        "directory; required unless --source kafka")
    p.add_argument("--model-file", required=True)
    p.add_argument("--scorer", default="tpu", choices=["cpu", "tpu"],
                   help="tpu: score on --device; cpu: the same step on "
                        "--device, then the model's NumPy predict rescores "
                        "the features on the host (the oracle)")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu; "
                        "the port never falls back to the CPU unasked)")
    p.add_argument("--mode", default="columnar",
                   choices=["columnar", "envelope"])
    p.add_argument("--source", default="replay",
                   choices=["replay", "kafka", "raw-table"],
                   help="replay a generated table (.npz), consume the "
                        "Debezium transaction topic of a Kafka cluster, or "
                        "backfill from a raw-transactions table directory "
                        "(--data <dir>)")
    p.add_argument("--from-date", default="",
                   help="raw-table backfill start day (YYYY-MM-DD, incl.)")
    p.add_argument("--to-date", default="",
                   help="raw-table backfill end day (YYYY-MM-DD, incl.)")
    p.add_argument("--bootstrap", default="localhost:9092",
                   help="Kafka bootstrap servers (--source kafka)")
    p.add_argument("--topic", default="debezium.payment.transactions")
    p.add_argument("--idle-timeout", type=float, default=0.0,
                   help="stop when the Kafka topic is idle this long "
                        "(0 = serve forever)")
    p.add_argument("--out", default="",
                   help="analyzed output: a local directory of Parquet "
                        "parts")
    p.add_argument("--raw-table", default="",
                   help="also land raw transactions in a day-partitioned "
                        "Parquet table at this directory")
    p.add_argument("--batch-rows", type=int, default=4096)
    p.add_argument("--max-batches", type=int, default=0)
    p.add_argument("--key-mode", default="direct",
                   choices=["direct", "hash", "exact"],
                   help="feature-state key→slot placement: direct (dense "
                        "serial ids), hash (bounded memory, colliding "
                        "keys merge windows), exact (the tiered store: a "
                        "key directory, a hot tier sized to the working "
                        "set, admission misses read the count-min sketch)")
    p.add_argument("--state-compact-every", type=int, default=0,
                   help="recency compaction cadence for --key-mode exact: "
                        "every N batches reclaim the hot-tier slots whose "
                        "newest day is older than delay + max(window). "
                        "0 = off")
    p.add_argument("--state-hbm-budget-mb", type=float, default=0.0,
                   help="device-memory budget for the whole feature state, "
                        "checked at engine build. 0 = unchecked")
    p.add_argument("--cold-store", default="",
                   help="host cold tier for --key-mode exact: a directory "
                        "where compaction demotes evicted keys' window "
                        "rows; returning keys promote back between steps. "
                        "Requires --state-compact-every. Empty = off")
    p.add_argument("--cold-promote-queue", type=int, default=64,
                   help="bounded depth of the promoter's request queue")
    p.add_argument("--cold-segment-mb", type=float, default=4.0,
                   help="buffered demotions become one segment past this "
                        "many MB")
    p.add_argument("--alerts-only", action="store_true",
                   help="serve predictions only: the feature matrix never "
                        "leaves the device")
    p.add_argument("--pipeline-depth", type=int, default=2,
                   help="micro-batches in flight (2 = double-buffering)")
    p.add_argument("--coalesce-rows", type=int, default=0,
                   help="merge consecutive source polls into one device "
                        "batch up to this many rows (0 = off)")
    p.add_argument("--precompile", action="store_true",
                   help="capture the step of every batch bucket (and the "
                        "compaction and promotion passes) as one CUDA "
                        "graph each before the first poll; every batch "
                        "then replays its bucket's graph (nothing is "
                        "captured on the CPU)")
    p.add_argument("--autobatch", action="store_true",
                   help="adaptive micro-batching: move the coalesce "
                        "target between the batch buckets from observed "
                        "latency (maximize throughput, or hold "
                        "--latency-slo-ms when set)")
    p.add_argument("--latency-slo-ms", type=float, default=0.0,
                   help="p50 micro-batch latency target for the "
                        "adaptive batch controller (implies --autobatch;"
                        " 0 = no SLO, maximize throughput)")
    p.add_argument("--emit-threshold", type=float, default=0.0,
                   help="selective emission: transfer and persist the 15 "
                        "feature columns only for rows whose fraud "
                        "probability clears this threshold (probs land "
                        "for every row; flagged rows' features are "
                        "bit-identical to full emission, clean rows "
                        "carry zeros; 0 = every row's features)")
    p.add_argument("--emit-bf16", action="store_true",
                   help="emit the analyzed feature columns in bfloat16 "
                        "(half the device->host bytes; predictions stay "
                        "float32-exact; incompatible with the feedback "
                        "loop)")
    p.add_argument("--nan-guard", action="store_true",
                   help="data-plane guard: rows producing NaN/Inf "
                        "features or scores are quarantined to "
                        "--dead-letter (reason=nonfinite) and the batch "
                        "is re-scored without them before the running "
                        "feature state is contaminated (serves at depth "
                        "1 while on)")
    p.add_argument("--overload", action="store_true",
                   help="overload-survival ladder: under sustained "
                        "pressure (batch p50 vs --latency-slo-ms, source "
                        "lag, queue fill) shed optional work, then force "
                        "the largest bucket and alerts-only emission, "
                        "then defer whole micro-batches to a durable "
                        "spill and replay them in order on recovery")
    p.add_argument("--overload-spill", default="overload_spill",
                   help="durable spill for rung-3 deferred batches "
                        "(*.jsonl = JSONL, else a Parquet directory; "
                        "idempotent by tx_id, reason=shed)")
    p.add_argument("--overload-lag-high", type=int, default=0,
                   help="source-lag normalization: this many backlogged "
                        "rows == pressure 1.0 (0 = lag signal off)")
    p.add_argument("--overload-climb-pressure", type=float, default=1.0,
                   help="climb one rung after --overload-climb-dwell "
                        "consecutive observations at or above this "
                        "normalized pressure")
    p.add_argument("--overload-descend-pressure", type=float,
                   default=0.6,
                   help="descend one rung after --overload-descend-dwell "
                        "consecutive observations at or below this "
                        "pressure (must be < climb: the gap is the "
                        "anti-flap band)")
    p.add_argument("--overload-climb-dwell", type=int, default=3,
                   help="consecutive high-pressure observations before "
                        "each climb")
    p.add_argument("--overload-descend-dwell", type=int, default=6,
                   help="consecutive low-pressure observations before "
                        "each descent")
    p.add_argument("--overload-max-deferred", type=int, default=512,
                   help="memory bound on deferred micro-batches; at the "
                        "cap the queue head replays through scoring to "
                        "make room")
    p.add_argument("--async-sink", action="store_true",
                   help="offload sink appends to a background writer "
                        "thread behind a bounded queue")
    p.add_argument("--sink-queue-batches", type=int, default=8,
                   help="bounded queue depth (batch results) for "
                        "--async-sink")
    p.add_argument("--decode-workers", type=int, default=0,
                   help="envelope decode threads (0 = auto, min(8, "
                        "cores); 1 = serial)")
    p.add_argument("--prefetch-batches", type=int, default=0,
                   help="background source prefetch: poll and decode run "
                        "ahead of the loop into a bounded queue of this "
                        "many batches (offsets commit on consumption; "
                        "poison isolation runs unprefetched). 0 = off")
    p.add_argument("--no-fetch-overlap", action="store_true",
                   help="fetch results with blocking copies instead of "
                        "the side-stream copies into pinned memory")
    p.add_argument("--z-mode", default="auto",
                   choices=["auto", "f32", "bf16", "int8"],
                   help="dtype of the tree ensembles' dense path table "
                        "(auto = int8 on CUDA, f32 elsewhere); every mode "
                        "gives the same sums")
    p.add_argument("--start-date", default="2025-04-01")
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint the stream here (a local directory, or "
                        "file://dir for the object-store plane); the JAX "
                        "package's format, so either package resumes it")
    p.add_argument("--checkpoint-full-every", type=int, default=1,
                   help="write a FULL checkpoint every K saves and deltas "
                        "(changed leaves only, checksum-chained to their "
                        "base) in between (1 = every save full)")
    p.add_argument("--checkpoint-op-timeout", type=float, default=0.0,
                   help="per-op timeout in seconds for object-store "
                        "checkpoint ops (0 = wait)")
    p.add_argument("--checkpoint-op-attempts", type=int, default=3,
                   help="retry attempts per object-store checkpoint op "
                        "(1 = no retry)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the newest valid checkpoint in "
                        "--checkpoint-dir")
    p.add_argument("--drain-on-sigterm", action="store_true",
                   help="SIGTERM stops the stream at the next batch "
                        "boundary instead of killing the process: "
                        "in-flight batches finish, the sink drains, "
                        "and a final checkpoint lands at that exact "
                        "frontier — the coordinated-drain leg of an "
                        "elastic fleet resize (deferred/shed rows stay "
                        "behind the committed offsets for the next "
                        "topology to re-poll)")
    p.add_argument("--resume-merge", default="",
                   help="OLD_CKPT_ROOT:P:L:REASON — adopt a drained "
                        "P-process fleet's final checkpoints (under "
                        "proc-NN/ of the root, or the root itself when "
                        "P=1, each written at L devices/process) into "
                        "this worker's --checkpoint-dir before "
                        "serving: states merge to one global "
                        "checkpoint, the stream cursor rewinds to the "
                        "fleet-wide minimum with per-old-owner resume "
                        "floors (no row lost, none double-scored), and "
                        "a resize epoch is stamped into the lineage. "
                        "Idempotent: skipped when this worker's "
                        "lineage already has a checkpoint. Requires "
                        "--resume; not for --source kafka")
    p.add_argument("--resume-merge-cold", default="",
                   help="comma-separated old-generation cold-store "
                        "directories to consolidate into --cold-store "
                        "during --resume-merge (restore then re-homes "
                        "ownership to the new topology)")
    p.add_argument("--cms-exchange", default="",
                   help="shared directory for cross-process terminal-"
                        "sketch exchange at checkpoint boundaries: "
                        "terminal risk aggregates (NOT co-partitioned "
                        "by the customer-residue ingest split) merge "
                        "fleet-wide under the newest-day rule, while "
                        "checkpoints keep locals-only partials so "
                        "resize merges stay exact (multi-host only)")
    p.add_argument("--devices", type=int, default=1,
                   help="serve N shards (the sharded engine: customer-"
                        "partitioned rows, the terminal owner exchange), "
                        "all on the one device --device names; 1 = the "
                        "single engine")
    p.add_argument("--max-batch-rows", type=int, default=0,
                   help="cap assembled micro-batches at this many rows "
                        "(0 = config default 65536). The sharded "
                        "engine's per-chunk step width derives from it "
                        "(2x the balanced per-device load)")
    p.add_argument("--coordinator", default="",
                   help="host:port of process 0's torch.distributed "
                        "store (gloo) — fleets (the port's "
                        "tools/multihost_launcher.py passes it); \"\" "
                        "with --num-processes > 1 = uncoordinated "
                        "fleet (no process group)")
    p.add_argument("--num-processes", type=int, default=1,
                   help="total processes in the fleet; this process "
                        "serves the customer residue block "
                        "[pid*devices, (pid+1)*devices) of the "
                        "num-processes*devices global shard space")
    p.add_argument("--process-id", type=int, default=-1,
                   help="this process's id in [0, num-processes); -1 = "
                        "resolve from RANK")
    p.add_argument("--max-restarts", type=int, default=0,
                   help="supervised mode: restart on failure with "
                        "checkpoint replay (requires --checkpoint-dir)")
    p.add_argument("--stall-timeout", type=float, default=0.0,
                   help="watchdog: restart the engine if it makes no "
                        "progress for this many seconds (supervised mode "
                        "only; 0 = off)")
    p.add_argument("--dead-letter", default="",
                   help="dead-letter queue for poison rows (*.jsonl = a "
                        "JSONL file, else a Parquet directory): the "
                        "supervisor bisects a crash-looping batch down to "
                        "its failing rows and quarantines them here")
    p.add_argument("--crash-loop-k", type=int, default=2,
                   help="consecutive supervised crashes at the same "
                        "progress point before the failure counts as "
                        "poison")
    p.add_argument("--restart-backoff-ms", type=float, default=0.0,
                   help="base backoff between crash restarts (doubles per "
                        "restart, full jitter, 30 s cap; 0 = restart at "
                        "once)")
    p.add_argument("--online-lr", type=float, default=0.0,
                   help="in-step online SGD from in-band labels at this "
                        "step size (kinds with a gradient path; 0 = off)")
    p.add_argument("--feedback-bootstrap", default="",
                   help="consume delayed fraud labels from this Kafka "
                        "cluster's feedback topic between micro-batches")
    p.add_argument("--feedback-topic", default="payment.feedback")
    p.add_argument("--reload-model-every", type=int, default=0,
                   help="hot model reload: every N batches re-read "
                        "--model-file (mtime-gated) and swap the weights "
                        "into the live loop (0 = off)")
    p.add_argument("--learn-registry", default="",
                   help="continuous learning: versioned model registry at "
                        "this directory. The serving model bootstraps as "
                        "v1; a streaming learner trains a candidate on "
                        "labeled feedback, shadow-scores it beside the "
                        "champion, and promotes or rolls back on live "
                        "precision-recall")
    p.add_argument("--publish-every-labels", type=int, default=512,
                   help="publish a candidate version after this many new "
                        "labeled rows trained since the last publish")
    p.add_argument("--promote-min-labels", type=int, default=256,
                   help="labeled rows BOTH models need in the live "
                        "comparison window before promotion can fire")
    p.add_argument("--promote-margin", type=float, default=0.01,
                   help="live recall improvement the candidate must show "
                        "over the champion to be promoted")
    p.add_argument("--rollback-min-labels", type=int, default=256,
                   help="labeled rows after a promotion before the canary "
                        "verdict (hold baseline or roll back)")
    p.add_argument("--rollback-margin", type=float, default=0.05,
                   help="live recall drop below the promotion baseline "
                        "that triggers automatic rollback")
    p.add_argument("--metrics-dump", default="",
                   help="write the final registry snapshot (/metrics.json "
                        "content) to this path at run end, success or "
                        "failure")
    p.add_argument("--trace-dir", default="",
                   help="capture a torch.profiler trace of the serving run "
                        "into this directory (Chrome-trace JSON)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve /metrics (Prometheus text), /metrics.json, "
                        "/healthz and /trace on this port while scoring "
                        "(0 = off)")
    p.add_argument("--healthz-max-batch-age", type=float, default=300.0,
                   help="/healthz goes 503 when the last finished batch "
                        "is older than this many seconds")
    p.add_argument("--healthz-max-lag-rows", type=float, default=0.0,
                   help="/healthz goes 503 when the source backlog "
                        "exceeds this many rows (0 = lag check off)")
    p.add_argument("--flight-record", default="",
                   help="append one JSONL record per micro-batch (phase "
                        "timings, queue depth, trace id) plus checkpoint, "
                        "feedback and fault events to this file")
    p.add_argument("--flight-record-max-mb", type=float, default=256.0,
                   help="rotate the flight record past this many MB (the "
                        "previous generation kept at <path>.1; 0 = "
                        "unbounded)")
    p.add_argument("--trace-out", default="",
                   help="export the per-batch span waterfalls as "
                        "Chrome-trace JSON to this file at run end (a "
                        "bounded ring buffer, safe on unbounded streams)")
    p.set_defaults(fn=cmd_score)

    p = sub.add_parser("train", help="offline training on a generated table")
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="forest", choices=_KINDS)
    p.add_argument("--out-model", required=True)
    _add_split_flags(p)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser(
        "compare",
        help="fit several model kinds on one split; metrics + timings")
    p.add_argument("--data", required=True)
    p.add_argument("--models", nargs="+",
                   default=["logreg", "tree", "forest", "gbt", "mlp"],
                   choices=_KINDS)
    _add_split_flags(p)
    p.add_argument("--plots-dir", default="",
                   help="write <kind>.png ROC/PR/threshold reports here")
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser(
        "select",
        help="prequential hyper-parameter selection (validation+test "
             "sweeps)")
    p.add_argument("--data", required=True)
    p.add_argument("--model", default="tree",
                   choices=["logreg", "mlp", "tree", "forest", "gbt"])
    p.add_argument("--grid", nargs="+", required=True,
                   metavar="FIELD=V1,V2",
                   help="e.g. tree_max_depth=2,4,8 epochs=3,5")
    p.add_argument("--start-valid", type=int, required=True,
                   help="training-start day for the validation sweep")
    p.add_argument("--start-test", type=int, required=True,
                   help="training-start day for the test sweep (later; "
                        "windows stay disjoint per the wrapper contract)")
    p.add_argument("--folds", type=int, default=4)
    p.add_argument("--epochs", type=int, default=3)
    _add_device_flag(p)
    p.set_defaults(fn=cmd_select)
    return ap


def _add_device_flag(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="torch device to fit and predict on (the CPU only "
                        "when named)")


def _add_split_flags(p) -> None:
    """The train/delay/test spans, ``--epochs`` and ``--device`` of
    ``train`` and ``compare``."""
    p.add_argument("--delta-train", type=int, default=153)
    p.add_argument("--delta-delay", type=int, default=30)
    p.add_argument("--delta-test", type=int, default=30)
    p.add_argument("--epochs", type=int, default=5)
    _add_device_flag(p)


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
