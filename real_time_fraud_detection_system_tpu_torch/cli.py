"""Command line of the port — ``score``, the serving entry point:

    python -m real_time_fraud_detection_system_tpu_torch.cli score \\
        --data txs.npz --model-file model.npz --out analyzed/

It reads the artifacts that the JAX package's ``datagen`` and ``train``
commands write (a transactions ``.npz`` and a model ``.npz``), replays the
table through :class:`~.runtime.engine.ScoringEngine` and prints the run's
stats as one JSON line at the end. The flags it shares with the JAX
``score`` take their names, defaults and checks; ``--device`` (default
``cuda``) is the port's own. ``--checkpoint-dir`` checkpoints the stream
(``--resume`` continues from it); ``--max-restarts`` runs it under the
fault supervisor (``runtime/faults.py``) with the stall watchdog
(``--stall-timeout``) and poison isolation into ``--dead-letter``. The
checkpoints are the JAX package's format: either package resumes the
other's. ``--key-mode exact`` serves the tiered feature store, with
``--state-compact-every``, ``--state-hbm-budget-mb`` and the host cold
tier (``--cold-store``, ``--cold-promote-queue``, ``--cold-segment-mb``).
Not ported yet: the Kafka and raw-table sources and object-store output
(ROADMAP A2, A9), ``--resume-merge`` and ``--resume-merge-cold`` (A7), the
CPU oracle and the serving extras (A4, A6).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import math
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


def cmd_score(args) -> int:
    from real_time_fraud_detection_system_tpu_torch.config import Config
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model,
        load_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        make_checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        AsyncSink,
        make_dead_letter_sink,
        make_parquet_sink,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
        batches_left,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.timing import (
        date_to_epoch_s,
    )

    if not args.data:
        log.error("--data is required (the port replays a generated "
                  "table; --source kafka is not ported yet)")
        return 2
    if args.decode_workers < 0:
        log.error("--decode-workers must be >= 0, got %s",
                  args.decode_workers)
        return 2
    if args.resume_merge or args.resume_merge_cold:
        log.error("--resume-merge and --resume-merge-cold (adopting a "
                  "drained fleet's checkpoints) are not ported yet: "
                  "ROADMAP A7")
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
    cfg = Config()
    cfg = dataclasses.replace(
        cfg,
        runtime=dataclasses.replace(
            cfg.runtime,
            emit_features=not args.alerts_only,
            pipeline_depth=args.pipeline_depth,
            coalesce_rows=args.coalesce_rows,
            z_mode=args.z_mode,
            async_sink=args.async_sink,
            sink_queue_batches=args.sink_queue_batches,
            decode_workers=args.decode_workers,
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

        sb = state_bytes(cfg.features)
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
    txs = load_transactions(args.data)
    model = load_model(args.model_file, device=args.device)

    def make_engine():
        return ScoringEngine(cfg, model.kind, model.params, model.scaler,
                             device=args.device)

    source = ReplaySource(txs, date_to_epoch_s(args.start_date),
                          batch_rows=args.batch_rows, mode=args.mode,
                          decode_workers=cfg.runtime.decode_workers)
    sink = make_parquet_sink(args.out) if args.out else None
    if cfg.runtime.async_sink and sink is not None:
        sink = AsyncSink(sink, max_queue=cfg.runtime.sink_queue_batches)
    rt = cfg.runtime
    ckpt = make_checkpointer(
        rt.checkpoint_dir,
        full_every=rt.checkpoint_full_every,
        op_timeout_s=rt.checkpoint_op_timeout_s,
        op_attempts=rt.checkpoint_op_attempts,
    ) if rt.checkpoint_dir else None
    dead_letter = None
    if args.dead_letter:
        dead_letter = make_dead_letter_sink(args.dead_letter)
        log.info("dead-letter queue: %s (%d row(s) already quarantined)",
                 args.dead_letter, len(dead_letter))
    try:
        if ckpt is not None and args.max_restarts > 0:
            from real_time_fraud_detection_system_tpu_torch.runtime.faults \
                import RetryPolicy, run_with_recovery

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
                crash_loop_k=args.crash_loop_k, dead_letter=dead_letter,
                restart_backoff=backoff)
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
            # --max-batches counts the engine's lifetime batches, restored
            # ones included, as the JAX score does
            stats = engine.run(
                source, sink=sink, checkpointer=ckpt,
                max_batches=batches_left(engine.state, args.max_batches))
    finally:
        if isinstance(sink, AsyncSink):
            sink.close()
    if dead_letter is not None:
        stats["dead_letter_rows"] = len(dead_letter)
        dead_letter.close()
    print(_json_line({"device": str(resolve_device(args.device)),
                      "kind": model.kind, **stats}))
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
                   help="transactions .npz (as the JAX datagen writes)")
    p.add_argument("--model-file", required=True)
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (cuda, cuda:N or cpu; "
                        "the port never falls back to the CPU unasked)")
    p.add_argument("--mode", default="columnar",
                   choices=["columnar", "envelope"])
    p.add_argument("--source", default="replay", choices=["replay"],
                   help="replay a generated table (.npz); the Kafka and "
                        "raw-table sources are not ported yet")
    p.add_argument("--out", default="",
                   help="analyzed output: a local directory of Parquet "
                        "parts")
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
    p.add_argument("--async-sink", action="store_true",
                   help="offload sink appends to a background writer "
                        "thread behind a bounded queue")
    p.add_argument("--sink-queue-batches", type=int, default=8,
                   help="bounded queue depth (batch results) for "
                        "--async-sink")
    p.add_argument("--decode-workers", type=int, default=0,
                   help="envelope decode threads (0 = auto, min(8, "
                        "cores); 1 = serial)")
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
    p.add_argument("--resume-merge", default="",
                   help="not ported yet (ROADMAP A7): exits 2")
    p.add_argument("--resume-merge-cold", default="",
                   help="not ported yet (ROADMAP A7): exits 2")
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
    p.set_defaults(fn=cmd_score)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
