"""The port's operator subcommands (``cli.py`` registers them): ``datagen``,
``warmup``, ``dlq``, ``ckpt``, ``registry``, ``demo``, ``query``, ``sql``,
``import-model``, ``connectors``, ``dashboard``, ``trace`` and
``verify-device``.

Each takes the JAX command's flags, defaults, choices and exit codes, and
its last stdout line has the JAX command's JSON shape; the commands that
touch the card (``demo``, ``warmup``, ``dlq --replay``, ``verify-device``)
also take ``--device`` (default ``cuda``). Two are analogs, since their
JAX forms are about XLA: ``warmup`` builds the three kernel libraries into
``_build/`` and captures one CUDA graph per dispatch signature (the built
libraries carry over to later processes, the graphs do not), and
``verify-device`` proves that every signature of template engines of each
served kind captures. Where a package a command needs is missing
(sklearn, pyarrow, psycopg2), the command exits 2 naming it.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time

import numpy as np

from real_time_fraud_detection_system_tpu_torch.cli import (
    _KINDS,
    _json_line,
    _missing,
)


# -- datagen ------------------------------------------------------------


def cmd_datagen(args) -> int:
    """Generate the transactions table (the JAX ``datagen``'s table for the
    same flags) and optionally seed a live Postgres through ``PgLive``."""
    from real_time_fraud_detection_system_tpu_torch.config import DataConfig
    from real_time_fraud_detection_system_tpu_torch.data import (
        generate_dataset,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.timing import (
        date_to_epoch_s,
    )

    log = logging.getLogger("datagen")
    cfg = DataConfig(n_customers=args.customers, n_terminals=args.terminals,
                     n_days=args.days, radius=args.radius, seed=args.seed,
                     start_date=args.start_date)
    customers, terminals, txs = generate_dataset(cfg)
    save_transactions(args.out, txs)
    log.info("generated %d txs (%d customers, %d terminals, %d days) "
             "fraud_rate=%.4f -> %s", txs.n, cfg.n_customers,
             cfg.n_terminals, cfg.n_days, txs.tx_fraud.mean(), args.out)
    if args.pg_dsn:
        from real_time_fraud_detection_system_tpu_torch.io.pg import PgLive

        pg = PgLive(args.pg_dsn)
        pg.ensure_schema()
        pg.upsert_dimension("customers", "customer_id",
                            customers.customer_id, customers.x, customers.y)
        pg.upsert_dimension("terminals", "terminal_id",
                            terminals.terminal_id, terminals.x, terminals.y)
        n = pg.upsert_transactions(
            {"tx_id": txs.tx_id,
             "tx_datetime_us": txs.epoch_us(date_to_epoch_s(cfg.start_date)),
             "customer_id": txs.customer_id,
             "terminal_id": txs.terminal_id,
             "tx_amount_cents": txs.amount_cents},
            rate_per_s=args.pg_rate)
        log.info("seeded live postgres with %d transactions", n)
    return 0


# -- warmup and verify-device (the precompiled step) ---------------------


def build_kernel_libraries(device) -> list:
    """Build the three kernel libraries into ``_build/`` in parallel (one
    nvcc each, all started together); nothing on the CPU. Returns the
    libraries' paths."""
    if device.type != "cuda":
        return []
    from concurrent.futures import ThreadPoolExecutor

    from real_time_fraud_detection_system_tpu_torch.ops import (
        cuda_lib,
        forest_kernels,
        score_kernels,
    )

    sources = (forest_kernels.SOURCE, forest_kernels.LEAF_SUM_SOURCE,
               score_kernels.SOURCE)
    with ThreadPoolExecutor(len(sources)) as pool:
        return [str(path) for path, _ in
                pool.map(cuda_lib.build_library, sources)]


def cmd_warmup(args) -> int:
    """``warmup``: build the kernel libraries, then capture one CUDA graph
    per dispatch signature of an engine with the serving flags given,
    and print the JAX command's manifest."""
    import dataclasses

    from real_time_fraud_detection_system_tpu_torch.config import Config
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model,
    )

    log = logging.getLogger("warmup")
    device = resolve_device(args.device)
    t0 = time.perf_counter()
    libs = build_kernel_libraries(device)
    model = load_model(args.model_file, device=device)
    cfg = Config()
    cfg = cfg.replace(runtime=dataclasses.replace(
        cfg.runtime,
        emit_features=not args.alerts_only,
        emit_threshold=args.emit_threshold,
        emit_dtype="bfloat16" if args.emit_bf16 else "float32",
        z_mode=args.z_mode,
        precompile=True))
    engine = _engine(cfg, model.kind, model.params, model.scaler,
                     args.devices, device, online_lr=args.online_lr)
    man = engine.precompile()
    out = {"kind": model.kind, "devices": args.devices,
           "buckets": man["buckets"], "variants": man["variants"],
           "compile_seconds": man["seconds"],
           "total_seconds": round(time.perf_counter() - t0, 3)}
    log.info("warmup done: %s (libraries %s, %d graphs)", out, libs,
             man["graphs"])
    print(_json_line(out))
    return 0


def _engine(cfg, kind, params, scaler, n_devices: int, device, **kw):
    if n_devices > 1:
        from real_time_fraud_detection_system_tpu_torch.runtime \
            .sharded_engine import ShardedScoringEngine

        return ShardedScoringEngine(cfg, kind=kind, params=params,
                                    scaler=scaler, n_devices=n_devices,
                                    device=device, **kw)
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )

    return ScoringEngine(cfg, kind=kind, params=params, scaler=scaler,
                         device=device, **kw)


# The template matrix of ``verify-device``: the JAX verifier's default
# targets (tools/rtfdsverify/targets.py) less its Pallas gate, which the
# port has no flag for. (name, kind, sharded, runtime fields, feature
# fields)
VERIFY_TARGETS = (
    ("forest/f32", "forest", False, {"z_mode": "f32"}, {}),
    ("forest/bf16", "forest", False, {"z_mode": "bf16"}, {}),
    ("forest/int8", "forest", False, {"z_mode": "int8"}, {}),
    ("gbt/int8", "gbt", False, {"z_mode": "int8"}, {}),
    ("logreg", "logreg", False, {}, {}),
    ("forest/int8/selective", "forest", False,
     {"z_mode": "int8", "emit_threshold": 0.9}, {}),
    ("forest/int8/exact", "forest", False, {"z_mode": "int8"},
     {"key_mode": "exact", "compact_every": 8}),
    ("sharded/forest/int8", "forest", True, {"z_mode": "int8"}, {}),
    ("sharded/forest/int8/exact", "forest", True, {"z_mode": "int8"},
     {"key_mode": "exact", "compact_every": 8}),
)
VERIFY_CHECKS = {
    "capture": "every dispatch_inventory() signature of the template "
               "engine warms up and captures into a CUDA graph (on the "
               "CPU: every signature is listed)",
}


def _template_engine(kind, sharded, runtime_kw, features_kw, device):
    """A weightless template engine: synthetic, shape-faithful params (4
    trees of depth 3), an identity scaler, small capacities and the
    buckets (64, 256), as the JAX verifier builds its targets."""
    import dataclasses

    import torch

    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        FeatureConfig,
        RuntimeConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )

    cfg = Config(
        features=dataclasses.replace(
            FeatureConfig(customer_capacity=128, terminal_capacity=256,
                          cms_width=1 << 10), **features_kw),
        runtime=dataclasses.replace(
            RuntimeConfig(batch_buckets=(64, 256), max_batch_rows=256),
            **runtime_kw))
    if kind == "forest":
        from real_time_fraud_detection_system_tpu_torch.models.forest \
            import synthetic_ensemble

        params = synthetic_ensemble(4, 3, 15, device=device)
    elif kind == "gbt":
        from real_time_fraud_detection_system_tpu_torch.models.gbt import (
            synthetic_gbt,
        )

        params = synthetic_gbt(4, 3, 15, device=device)
    else:
        from real_time_fraud_detection_system_tpu_torch.models.logreg \
            import init_logreg

        params = init_logreg(15, device=device)
    scaler = Scaler(torch.zeros(15, device=device),
                    torch.ones(15, device=device))
    if sharded:
        return _engine(cfg, kind, params, scaler, 2, device,
                       rows_per_shard=32)
    return _engine(cfg, kind, params, scaler, 1, device)


def verify_capture(device) -> dict:
    """Build every template engine and precompile it; one record per
    target: its signatures, how many were captured, and the failure."""
    out = []
    for name, kind, sharded, runtime_kw, features_kw in VERIFY_TARGETS:
        rec = {"target": name, "signatures": [], "captured": 0}
        try:
            eng = _template_engine(kind, sharded, runtime_kw, features_kw,
                                   device)
            rec["signatures"] = [list(sg.key)
                                 for sg in eng.dispatch_inventory()]
            man = eng.precompile()
            rec["buckets"] = man["buckets"]
            rec["captured"] = man["graphs"]
            want = len(rec["signatures"]) if device.type == "cuda" else 0
            if rec["captured"] < want:
                rec["error"] = (f"{rec['captured']} of {want} signatures "
                                "captured")
        # verify-device's contract: a target that fails to build or
        # capture is a finding (rc 1) with its cause, never a traceback
        except Exception as e:  # noqa: BLE001
            rec["error"] = f"{type(e).__name__}: {e}"[:300]
        out.append(rec)
    return out


def cmd_verify_device(args) -> int:
    """``verify-device``: every dispatch signature of the template engines
    captures. rc 0 when all do, 1 on a failure, 2 on a usage error."""
    if args.list_checks:
        for name, doc in VERIFY_CHECKS.items():
            print(f"{name:24s} {doc}")
        return 0
    unknown = [c for c in args.check or () if c not in VERIFY_CHECKS]
    if unknown:
        print(f"verify-device: unknown check(s) {unknown} (known: "
              f"{sorted(VERIFY_CHECKS)})", file=sys.stderr)
        return 2
    if args.update_baseline:
        print("verify-device: the capture check keeps no baseline (a "
              "signature that does not capture is always a failure)",
              file=sys.stderr)
        return 2
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"verify-device: {e}", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    build_kernel_libraries(device)
    records = verify_capture(device)
    findings = [{"check": "capture", "severity": "P0",
                 "target": r["target"], "message": r["error"]}
                for r in records if "error" in r]
    result = {
        "version": 1,
        "device": str(device),
        "targets": [r["target"] for r in records],
        "signatures_verified": sum(len(r["signatures"]) for r in records),
        "strict": bool(args.strict),
        "findings": findings,
        "baselined": [],
        "stale_baseline_entries": [],
        "checks": {"capture": {"targets": len(records),
                               "captured": sum(r["captured"]
                                               for r in records)}},
        "summary": {"active": len(findings),
                    "gate_failures": len(findings), "baselined": 0},
        "seconds": round(time.perf_counter() - t0, 3),
    }
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        for r in records:
            if "error" in r:
                print(f"P0 capture {r['target']}: {r['error']}")
            elif args.verbose:
                print(f"ok {r['target']}: {len(r['signatures'])} "
                      f"signature(s), {r['captured']} captured")
        print(f"verify-device: {len(records)} target(s), "
              f"{result['signatures_verified']} signature(s) on {device}, "
              f"{len(findings)} failure(s)")
    return 1 if findings else 0


# -- dlq, ckpt, registry ------------------------------------------------


def cmd_dlq(args) -> int:
    """``dlq``: summarize a dead-letter queue, or re-score its rows through
    a fresh engine (``--replay``) on ``--device``."""
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        read_dead_letter,
    )

    log = logging.getLogger("dlq")
    try:
        rows = read_dead_letter(args.path)
    except FileNotFoundError as e:
        print(_json_line({"error": str(e)}))
        return 2
    by_reason: dict = {}
    by_error: dict = {}
    for r in rows:
        reason = r.get("reason", "?")
        by_reason[reason] = by_reason.get(reason, 0) + 1
        etype = str(r.get("error", ""))[:60].split(":")[0] or "?"
        by_error[etype] = by_error.get(etype, 0) + 1
    summary = {
        "path": args.path,
        "rows": len(rows),
        "by_reason": by_reason,
        "by_error_type": by_error,
        "batches": sorted({int(r.get("batch_index", -1)) for r in rows}),
    }
    if not args.replay:
        print(_json_line(summary))
        for r in rows[: max(args.limit, 0)]:
            print(_json_line(r))
        if args.limit and len(rows) > args.limit:
            print(_json_line({"truncated": True, "limit": args.limit}))
        return 0
    if not args.model_file:
        log.error("--replay needs --model-file")
        return 2
    if not rows:
        print(_json_line({**summary, "replayed": 0}))
        return 0
    from real_time_fraud_detection_system_tpu_torch.config import Config
    from real_time_fraud_detection_system_tpu_torch.device import (
        resolve_device,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        load_model,
    )

    device = resolve_device(args.device)
    model = load_model(args.model_file, device=device)
    need = ("tx_id", "tx_datetime_us", "customer_id", "terminal_id",
            "tx_amount_cents", "kafka_ts_ms")

    def row_cols(recs):
        return {k: np.asarray([int(r["columns"].get(k, 0)) for r in recs],
                              dtype=np.int64) for k in need}

    def fresh_engine():
        return _engine(Config(), model.kind, model.params, model.scaler, 1,
                       device)

    out = []
    try:
        res = fresh_engine().process_batch(row_cols(rows))
        probs = {int(t): float(p) for t, p in zip(res.tx_id, res.probs)}
        for r in rows:
            out.append({"tx_id": r["tx_id"], "reason": r.get("reason"),
                        "prediction": probs.get(int(r["tx_id"]))})
    # triage: the batch probe catches whatever the poison rows raise, then
    # probes row by row so clean rows still score
    except Exception:  # noqa: BLE001
        for r in rows:
            try:
                res = fresh_engine().process_batch(row_cols([r]))
                out.append({
                    "tx_id": r["tx_id"], "reason": r.get("reason"),
                    "prediction": float(res.probs[0]) if len(res.probs)
                    else None})
            # a still-poison row reports its error in the verdict
            except Exception as e:  # noqa: BLE001
                out.append({"tx_id": r["tx_id"], "reason": r.get("reason"),
                            "error": f"{type(e).__name__}: {e}"[:200],
                            "still_poison": True})
    print(_json_line({**summary, "replayed": len(out)}))
    for o in out:
        print(_json_line(o))
    return 0


def cmd_ckpt(args) -> int:
    """``ckpt``: list the checkpoint lineage, ``--verify`` every live
    checkpoint and its delta chain (rc 1 on corruption), or ``--inspect``
    one manifest with its feature-state, topology and resize blocks."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        feature_state_report,
        make_checkpointer,
    )

    log = logging.getLogger("ckpt")
    try:
        ck = make_checkpointer(args.path)
    # a bad URL, missing boto3 or store error is a usage error (rc 2)
    except Exception as e:  # noqa: BLE001
        log.error("cannot open checkpoint lineage at %s: %s", args.path, e)
        return 2
    if args.inspect:
        try:
            man = ck.manifest(args.inspect)
        except KeyError:
            log.error("no checkpoint named %s under %s", args.inspect,
                      args.path)
            return 2
        # a corrupt manifest is the finding this preflight reports
        except Exception as e:  # noqa: BLE001
            print(_json_line({"path": args.inspect, "valid": False,
                              "error": f"{type(e).__name__}: {e}"[:300]}))
            return 1
        fs = feature_state_report(man)
        if fs is not None:
            man = {**man, "feature_state": fs}
        meta = man.get("meta") or {}
        pc = int(meta.get("process_count", 1) or 1)
        ld = int(meta.get("layout_devices", 1) or 1)
        man = {**man, "topology": {
            "process_count": pc,
            "process_id": int(meta.get("process_id", 0) or 0),
            "layout_devices": ld,
            "fleet_shards_total": pc * ld,
        }}
        if meta.get("resize_epochs"):
            man = {**man, "resize_epochs": meta["resize_epochs"]}
        print(_json_line({"path": args.inspect, **man}))
        return 0
    report = ck.verify_all(deep=bool(args.verify))
    n_bad = sum(1 for e in report if not e.get("valid"))
    print(_json_line({"path": args.path, "checkpoints": len(report),
                      "corrupt": n_bad, "latest": ck.latest()}))
    for e in report:
        if not args.verify:
            e = {k: v for k, v in e.items() if k != "detail"}
        print(_json_line(e))
    if args.verify and n_bad:
        log.error("%d corrupt checkpoint(s) in the lineage — restore "
                  "would fall back past them; quarantine or rebuild "
                  "before deploying", n_bad)
        return 1
    return 0


def cmd_registry(args) -> int:
    """``registry``: list the versions, or ``--publish`` an artifact,
    ``--promote`` (after verifying) or ``--rollback`` the champion,
    ``--inspect`` one manifest, ``--verify`` every artifact (rc 1 on
    corruption)."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        CorruptModelError,
        load_model,
    )
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )

    log = logging.getLogger("registry")
    try:
        reg = make_model_registry(args.path)
    # a bad URL, missing boto3 or store error is a usage error (rc 2)
    except Exception as e:  # noqa: BLE001
        log.error("cannot open model registry at %s: %s", args.path, e)
        return 2
    if args.publish:
        try:
            m = load_model(args.publish, device="cpu")
        except CorruptModelError as e:
            log.error("refusing to publish %s: artifact failed "
                      "verification (%s)", args.publish, e.reason)
            return 1
        # a missing file or bad npz means the artifact cannot be published
        except Exception as e:  # noqa: BLE001
            log.error("cannot load model artifact %s: %s", args.publish, e)
            return 2
        v = reg.publish(m, parent=reg.champion_version(), source="cli",
                        note=args.publish)
        print(_json_line({"published": v, "kind": m.kind,
                          "parent": reg.champion_version()}))
        return 0
    if args.rollback:
        prev = reg.rollback()
        if prev is None:
            log.error("no promotion history to roll back to")
            return 1
        print(_json_line({"champion": prev, "by": "rollback"}))
        return 0
    if args.promote:
        try:
            reg.get(args.promote)  # verify at the gate
        except KeyError:
            log.error("no version %d in the registry", args.promote)
            return 2
        except CorruptModelError as e:
            log.error("version %d failed verification (%s) and was "
                      "quarantined — it can never be promoted",
                      args.promote, e.reason)
            return 1
        print(_json_line(reg.promote(args.promote, by="cli")))
        return 0
    if args.inspect:
        try:
            man = reg.meta(args.inspect)
        except KeyError:
            log.error("no version %d in the registry", args.inspect)
            return 2
        except CorruptModelError as e:
            log.error("manifest for version %d is corrupt (%s)",
                      args.inspect, e.reason)
            return 1
        print(_json_line(man))
        return 0
    if args.verify:
        report = reg.verify_all()
        n_bad = sum(1 for e in report if not e.get("valid"))
        print(_json_line({"path": args.path, "versions": len(report),
                          "corrupt": n_bad,
                          "champion": reg.champion_version()}))
        for e in report:
            print(_json_line(e))
        if n_bad:
            log.error("%d corrupt artifact(s) still listed in the "
                      "registry — republish or roll back before "
                      "deploying", n_bad)
            return 1
        return 0
    print(_json_line({"path": args.path,
                      "champion": reg.champion_version()}))
    for row in reg.list_versions():
        print(_json_line(row))
    return 0


# -- demo, query, sql, dashboard, trace ----------------------------------


def _pow2_capacity_for(n: int) -> int:
    """Smallest power of two >= 2n: direct-mode slot capacity with 2×
    headroom over the live key count."""
    p = 1
    while p < 2 * n:
        p *= 2
    return p


def demo_config(args):
    """The demo's Config from the ``demo`` flags: direct-mode capacities
    with 2× headroom over the profile counts."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        DataConfig,
        FeatureConfig,
        TrainConfig,
    )

    return Config(
        data=DataConfig(n_customers=args.customers,
                        n_terminals=args.terminals, n_days=args.days,
                        seed=args.seed),
        features=FeatureConfig(
            customer_capacity=_pow2_capacity_for(args.customers),
            terminal_capacity=_pow2_capacity_for(args.terminals)),
        train=TrainConfig(delta_train_days=args.delta_train,
                          delta_delay_days=args.delta_delay,
                          delta_test_days=args.delta_test))


def cmd_demo(args) -> int:
    """``demo``: generate → CDC envelopes → dimension MERGE → warm-up →
    the envelope stream through the engine on ``--device``; the summary
    as one JSON line, and ``dashboard.html`` beside ``--out``."""
    log = logging.getLogger("demo")
    if args.out.startswith("s3://"):
        log.error("rtfds demo writes a local output directory (analyzed "
                  "parts + raw table + dashboard); for s3:// output use "
                  "rtfds score --out s3://...")
        return 2
    needs = {}
    if not args.model_file and args.model in ("tree", "forest"):
        needs["sklearn"] = f"demo --model {args.model} (training)"
    if args.out:
        needs["pyarrow"] = "demo --out"
    if _missing(log, needs):
        return 2
    from real_time_fraud_detection_system_tpu_torch.runtime.pipeline import (
        run_demo,
    )

    cfg = demo_config(args)
    model = None
    if args.model_file:
        from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
            load_model,
        )

        model = load_model(args.model_file, device=args.device)
        log.info("loaded model %s from %s", model.kind, args.model_file)
    summary = run_demo(cfg, model=model, model_kind=args.model,
                       out_dir=args.out or None, batch_rows=args.batch_rows,
                       n_devices=args.devices, device=args.device)
    if args.out:
        from real_time_fraud_detection_system_tpu_torch.io.dashboard import (
            write_dashboard,
        )

        try:
            dash = write_dashboard(
                args.out, os.path.join(args.out, "dashboard.html"))
            summary["dashboard"] = dash["dashboard"]
        except OSError as e:
            log.warning("dashboard render failed: %s", e)
            summary["dashboard_error"] = str(e)
    print(_json_line(summary))
    return 0


def cmd_query(args) -> int:
    """``query``: a canned dashboard report over analyzed output (or the
    raw table's per-day report)."""
    if _missing(logging.getLogger("query"), {"pyarrow": "query"}):
        return 2
    from real_time_fraud_detection_system_tpu_torch.io.query import (
        load_analyzed,
        raw_transactions_report,
        report,
    )

    if args.report == "transactions":
        try:
            print(_json_line(raw_transactions_report(args.data)))
        except FileNotFoundError as e:
            print(_json_line({"error": str(e)}))
            return 2
        return 0
    cols = load_analyzed(args.data)
    print(_json_line(report(cols, kind=args.report,
                            threshold=args.threshold, k=args.top_k,
                            bucket=args.bucket)))
    return 0


def cmd_sql(args) -> int:
    """``sql``: ad-hoc SQL over the analyzed output, one JSON object per
    row; every failure (a missing package too) is a JSON error, rc 2."""
    from real_time_fraud_detection_system_tpu_torch.io.sqlquery import (
        AnalyzedSql,
    )

    limit = max(0, args.limit)  # <= 0 means unlimited
    try:
        db = AnalyzedSql(args.data)
    # the JSON error contract holds for every open failure
    except Exception as e:  # noqa: BLE001
        print(_json_line({"error": f"{type(e).__name__}: {e}"}))
        return 2
    try:
        # one row past the limit: bounded memory, and truncation shows
        names, rows = db.query(args.query,
                               max_rows=limit + 1 if limit else 0)
    # sqlite, duckdb and pyarrow each raise their own types
    except Exception as e:  # noqa: BLE001
        print(_json_line({"error": f"{type(e).__name__}: {e}"}))
        return 2
    finally:
        db.close()
    shown = rows[:limit] if limit else rows
    for r in shown:
        print(_json_line(dict(zip(names, r))))
    if limit and len(rows) > limit:
        print(_json_line({"truncated": True, "limit": limit}))
    return 0


def cmd_dashboard(args) -> int:
    """``dashboard``: the static HTML of the analyzed view (``--data``) or
    of the ops view over a flight record (``--flight-record``)."""
    from real_time_fraud_detection_system_tpu_torch.io.dashboard import (
        write_dashboard,
        write_ops_dashboard,
    )

    if bool(args.data) == bool(args.flight_record):
        print(_json_line(
            {"error": "pass exactly one of --data (analyzed view) or "
                      "--flight-record (ops-health view); render them "
                      "to separate --out files"}))
        return 2
    if args.data and _missing(logging.getLogger("dashboard"),
                              {"pyarrow": "dashboard --data"}):
        return 2
    try:
        if args.flight_record:
            manifest = write_ops_dashboard(args.flight_record, args.out,
                                           title=args.title)
        else:
            manifest = write_dashboard(args.data, args.out,
                                       threshold=args.threshold,
                                       top_k=args.top_k, bucket=args.bucket,
                                       title=args.title)
    except FileNotFoundError as e:
        print(_json_line({"error": str(e)}))
        return 2
    print(_json_line(manifest))
    return 0


def cmd_trace(args) -> int:
    """``trace``: digest a Chrome-trace JSON (``score --trace-out``): the
    per-batch critical path, the slowest spans, compile events and an
    ASCII waterfall, or the summary as one JSON line (``--json``)."""
    from real_time_fraud_detection_system_tpu_torch.io.dashboard import (
        render_trace_waterfall,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        summarize_chrome,
    )

    try:
        with open(args.trace, encoding="utf-8") as f:
            trace = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(_json_line({"error": f"{type(e).__name__}: {e}"}))
        return 2
    summary = summarize_chrome(trace, top_k=args.top_k)
    if args.json:
        print(_json_line(summary))
        return 0
    batches = summary["batches"]
    print(f"{summary['n_events']} span events, {len(batches)} batches, "
          f"{len(summary['compile_events'])} XLA compile events")
    if batches:
        worst = sorted(batches, key=lambda b: -b["total_ms"])[:args.top_k]
        print(f"\nslowest batches (top {len(worst)}), critical phase "
              "per batch:")
        for b in worst:
            phases = " ".join(f"{k}={v:.2f}" for k, v in
                              b["phases_ms"].items())
            print(f"  {b['trace_id']}  total {b['total_ms']:9.3f} ms  "
                  f"critical {b['critical_phase']} "
                  f"({b['critical_ms']:.3f} ms)  [{phases}]")
    if summary["slowest_spans"]:
        print(f"\nslowest spans (top {len(summary['slowest_spans'])}):")
        for s in summary["slowest_spans"]:
            print(f"  {s['dur_ms']:9.3f} ms  {s['name']:<16} "
                  f"{s['trace_id'] or '-'}")
    if summary["compile_events"]:
        print("\nXLA compile/recompile events:")
        for c in summary["compile_events"]:
            extra = (" " + ", ".join(f"{k}={v}" for k, v in
                                     c["args"].items())
                     if c.get("args") else "")
            print(f"  {c['name']:<14} {c['dur_ms']:9.3f} ms  "
                  f"{c['trace_id'] or '-'}{extra}")
    print()
    print(render_trace_waterfall(trace, trace_id=args.batch or None))
    return 0


# -- import-model, connectors -------------------------------------------


def cmd_import_model(args) -> int:
    """``import-model``: the reference's pickled classifier (RandomForest,
    ExtraTrees, DecisionTree, XGBClassifier, LogisticRegression) and its
    joblib scaler → the ``.npz`` v1 artifact (the JAX import's content
    hash). Unpickling executes code: trusted artifacts only."""
    import pickle

    import torch

    from real_time_fraud_detection_system_tpu_torch.features.spec import (
        FEATURE_NAMES,
    )
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
        save_model,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )

    log = logging.getLogger("import-model")
    n_features = len(FEATURE_NAMES)
    try:
        if args.model_pkl.startswith("s3://"):
            import io as _io

            from real_time_fraud_detection_system_tpu_torch.io.artifacts \
                import _split_s3_url
            from real_time_fraud_detection_system_tpu_torch.io.store import (
                make_store,
            )

            try:
                url, key = _split_s3_url(args.model_pkl)
            except ValueError as e:
                log.error("%s", e)
                return 2
            clf = pickle.load(_io.BytesIO(make_store(url).get(key)))
        else:
            with open(args.model_pkl, "rb") as f:
                clf = pickle.load(f)
    except ModuleNotFoundError as e:
        log.error("import-model needs %s to unpickle %s, which is not "
                  "installed", e.name, args.model_pkl)
        return 2

    # a 20-feature, multiclass or reordered model would import cleanly and
    # serve wrong probabilities: refuse it
    n_in = getattr(clf, "n_features_in_", None)
    if n_in is not None and int(n_in) != n_features:
        log.error("model was fitted on %d features; the serving feature "
                  "vector has %d (features/spec.py)", int(n_in), n_features)
        return 2
    classes = getattr(clf, "classes_", None)
    if classes is not None and len(classes) != 2:
        log.error("binary classifiers only: model has %d classes",
                  len(classes))
        return 2
    names = getattr(clf, "feature_names_in_", None)
    if names is not None:
        got = [str(x) for x in names]
        if got != list(FEATURE_NAMES):
            log.error(
                "model was fitted on feature names/order %s; the serving "
                "vector is %s (features/spec.py) — re-export the model "
                "with the serving column order", got, list(FEATURE_NAMES))
            return 2

    if args.scaler_pkl:
        if _missing(log, {"joblib": "import-model --scaler-pkl"}):
            return 2
        import joblib

        sk_scaler = joblib.load(args.scaler_pkl)
        if len(np.asarray(sk_scaler.mean_)) != n_features:
            log.error("scaler was fitted on %d features; expected %d",
                      len(np.asarray(sk_scaler.mean_)), n_features)
            return 2
        scaler = Scaler(
            mean=torch.as_tensor(np.asarray(sk_scaler.mean_, np.float32)),
            scale=torch.as_tensor(np.asarray(sk_scaler.scale_, np.float32)))
    else:
        scaler = Scaler(mean=torch.zeros(n_features),
                        scale=torch.ones(n_features))

    name = type(clf).__name__
    if name in ("RandomForestClassifier", "ExtraTreesClassifier",
                "DecisionTreeClassifier"):
        from real_time_fraud_detection_system_tpu_torch.models.forest import (
            ensemble_from_sklearn,
        )

        kind = "tree" if name == "DecisionTreeClassifier" else "forest"
        params = ensemble_from_sklearn(clf, n_features, device="cpu")
    elif name == "XGBClassifier":
        from real_time_fraud_detection_system_tpu_torch.models.gbt import (
            gbt_from_xgboost,
        )

        kind = "gbt"
        params = gbt_from_xgboost(clf, n_features, device="cpu")
    elif name == "LogisticRegression":
        from real_time_fraud_detection_system_tpu_torch.models.logreg import (
            LogRegParams,
        )

        kind = "logreg"
        params = LogRegParams(
            w=torch.as_tensor(np.asarray(clf.coef_[0], np.float32)),
            b=torch.as_tensor(np.float32(clf.intercept_[0])))
    else:
        log.error("unsupported classifier type %s (supported: "
                  "RandomForest/ExtraTrees/DecisionTree/XGB/"
                  "LogisticRegression)", name)
        return 2

    save_model(args.out_model, TrainedModel(kind=kind, scaler=scaler,
                                            params=params))
    log.info("imported %s (%s) -> %s", args.model_pkl, kind, args.out_model)
    print(_json_line({"kind": kind, "out_model": args.out_model,
                      "n_features": n_features}))
    return 0


def cmd_connectors(args) -> int:
    """``connectors``: POST the Debezium Postgres source connector to the
    Kafka Connect REST API (stdlib only); 409 (already registered) is
    success, and the echoed password is redacted."""
    import urllib.error
    import urllib.request

    log = logging.getLogger("connectors")
    body = {
        "name": args.name,
        "config": {
            "connector.class":
                "io.debezium.connector.postgresql.PostgresConnector",
            "tasks.max": "1",
            "database.hostname": args.db_host,
            "database.port": str(args.db_port),
            "database.user": args.db_user,
            "database.password": args.db_password,
            "database.dbname": args.db_name,
            "database.include.list": args.db_name,
            "schema.include.list": args.schema,
            "topic.prefix": args.topic_prefix,
        },
    }
    url = args.connect_url.rstrip("/") + "/connectors/"
    req = urllib.request.Request(
        url, data=json.dumps(body).encode(),
        headers={"Accept": "application/json",
                 "Content-Type": "application/json"},
        method="POST")
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            raw = resp.read() or b"{}"
            try:
                payload = json.loads(raw)
            except json.JSONDecodeError:
                log.error("non-JSON response from %s (is this really the "
                          "Connect REST API?): %r", url, raw[:120])
                return 1
            if isinstance(payload, dict):
                cfg_echo = payload.get("config")
                if (isinstance(cfg_echo, dict)
                        and "database.password" in cfg_echo):
                    cfg_echo["database.password"] = "***"
            out = {"status": resp.status, "connector": args.name,
                   "response": payload}
    except urllib.error.HTTPError as e:
        if e.code == 409:
            out = {"status": 409, "connector": args.name,
                   "already_registered": True}
        else:
            log.error("connect REST error %s: %s", e.code,
                      e.read()[:200].decode(errors="replace"))
            return 1
    except (urllib.error.URLError, OSError) as e:
        log.error("cannot reach Kafka Connect at %s: %s", url, e)
        return 1
    print(_json_line(out))
    return 0


# -- the parsers -------------------------------------------------------


def _device_flag(p, what: str) -> None:
    p.add_argument("--device", default="cuda",
                   help=f"torch device {what} (the CPU only when named)")


def add_operator_parsers(sub) -> None:
    """Register the operator subcommands on ``sub`` (the JAX CLI's flags,
    defaults and choices, plus ``--device`` where the card is used)."""
    p = sub.add_parser("datagen",
                       help="generate a synthetic transaction table")
    p.add_argument("--out", required=True)
    p.add_argument("--customers", type=int, default=5000)
    p.add_argument("--terminals", type=int, default=10000)
    p.add_argument("--days", type=int, default=245)
    p.add_argument("--radius", type=float, default=5.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start-date", default="2025-04-01")
    p.add_argument("--pg-dsn", default=None,
                   help="also seed a live Postgres (psycopg2 DSN) — the "
                        "reference datagen container's role")
    p.add_argument("--pg-rate", type=float, default=0.0,
                   help="paced rows/s for --pg-dsn (0 = bulk)")
    p.set_defaults(fn=cmd_datagen)

    p = sub.add_parser(
        "warmup",
        help="build the kernel libraries into _build/ (they carry over to "
             "later processes), then capture one CUDA graph per batch "
             "bucket of an engine with these serving flags (graphs live "
             "in this process only)")
    p.add_argument("--model-file", required=True)
    p.add_argument("--devices", type=int, default=1,
                   help="warm the N-shard sharded step instead of the "
                        "single one")
    p.add_argument("--online-lr", type=float, default=0.0,
                   help="match the serving flag: online SGD changes the "
                        "captured step")
    p.add_argument("--alerts-only", action="store_true",
                   help="match the serving flag (emit_features=False "
                        "captures a different step tail)")
    p.add_argument("--emit-threshold", type=float, default=0.0,
                   help="match the serving flag (selective emission "
                        "captures a different step tail)")
    p.add_argument("--emit-bf16", action="store_true",
                   help="match the serving flag")
    p.add_argument("--use-pallas", action="store_true",
                   help="accepted for the JAX flag set; the port serves "
                        "its fused kernels whenever they admit the model")
    p.add_argument("--z-mode", default="auto",
                   choices=["auto", "f32", "bf16", "int8"],
                   help="match the serving flag")
    _device_flag(p, "to build and capture on")
    p.set_defaults(fn=cmd_warmup)

    p = sub.add_parser(
        "dlq",
        help="inspect / replay dead-letter-queue rows (poison quarantine)")
    p.add_argument("--path", required=True,
                   help="DLQ written by --dead-letter (JSONL file or "
                        "parquet directory)")
    p.add_argument("--limit", type=int, default=20,
                   help="max row records printed when inspecting "
                        "(0 = summary only)")
    p.add_argument("--replay", action="store_true",
                   help="re-score the quarantined rows through a fresh "
                        "engine (post-fix triage; rows that still crash "
                        "report their error and stay quarantined)")
    p.add_argument("--model-file", default="",
                   help="model artifact for --replay")
    _device_flag(p, "of the --replay engine")
    p.set_defaults(fn=cmd_dlq)

    p = sub.add_parser(
        "ckpt", help="inspect / verify the checkpoint lineage (durable "
                     "state)")
    p.add_argument("--path", required=True,
                   help="checkpoint directory or s3:// prefix "
                        "(the --checkpoint-dir of the serving run)")
    p.add_argument("--verify", action="store_true",
                   help="re-checksum every live checkpoint + delta "
                        "chain; exit 1 on any corruption (deploy "
                        "preflight)")
    p.add_argument("--inspect", default="",
                   help="dump one checkpoint's manifest (name or full "
                        "path, e.g. ckpt-0000000004.npz)")
    p.set_defaults(fn=cmd_ckpt)

    p = sub.add_parser(
        "registry",
        help="inspect / verify / promote / roll back the versioned "
             "model registry (continuous learning)")
    p.add_argument("--path", required=True,
                   help="registry directory or s3:// prefix (the "
                        "--learn-registry of the serving run)")
    p.add_argument("--verify", action="store_true",
                   help="re-hash every artifact against its manifest + "
                        "internal content hash; exit 1 on any corruption "
                        "(deploy preflight)")
    p.add_argument("--inspect", type=int, default=0,
                   help="dump one version's manifest (versions start "
                        "at 1)")
    p.add_argument("--promote", type=int, default=0,
                   help="verify, then move the champion pointer to this "
                        "version (manual canary override)")
    p.add_argument("--rollback", action="store_true",
                   help="pop the champion pointer back to the previous "
                        "champion (one pointer move; no artifact bytes "
                        "change)")
    p.add_argument("--publish", default="",
                   help="register a model artifact (.npz) as a new "
                        "candidate version")
    p.set_defaults(fn=cmd_registry)

    p = sub.add_parser("demo",
                       help="full E2E demo: datagen → CDC → sinks → scorer")
    p.add_argument("--customers", type=int, default=500)
    p.add_argument("--terminals", type=int, default=1000)
    p.add_argument("--days", type=int, default=90)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--model", default="forest", choices=_KINDS)
    p.add_argument("--model-file", default="")
    p.add_argument("--delta-train", type=int, default=45)
    p.add_argument("--delta-delay", type=int, default=10)
    p.add_argument("--delta-test", type=int, default=20)
    p.add_argument("--batch-rows", type=int, default=4096)
    p.add_argument("--out", default="")
    p.add_argument("--devices", type=int, default=1,
                   help="serve the scoring leg on N shards")
    _device_flag(p, "to train and serve on")
    p.set_defaults(fn=cmd_demo)

    p = sub.add_parser("query",
                       help="dashboard reports over analyzed parquet output")
    p.add_argument("--data", required=True,
                   help="analyzed output directory (ParquetSink); for "
                        "--report transactions, the raw day-partitioned "
                        "table directory (tx_date=*/ layout)")
    p.add_argument("--report", default="summary",
                   choices=["summary", "timeseries", "terminals",
                            "customers", "alerts", "drift",
                            "transactions"])
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--bucket", default="day", choices=["hour", "day"])
    p.set_defaults(fn=cmd_query)

    p = sub.add_parser(
        "sql",
        help="ad-hoc SQL over analyzed parquet output (Trino's role, "
             "in-process; table name: analyzed)")
    p.add_argument("--data", required=True,
                   help="analyzed output directory (ParquetSink)")
    p.add_argument("query", help="SQL, e.g. \"SELECT COUNT(*) FROM "
                                 "analyzed WHERE prediction >= 0.5\"")
    p.add_argument("--limit", type=int, default=1000,
                   help="max rows printed (default 1000; 0 = unlimited)")
    p.set_defaults(fn=cmd_sql)

    p = sub.add_parser(
        "import-model",
        help="convert the reference's pickled artifacts "
             "(trained_model.pkl [+ scaler.pkl]) into the npz model "
             "format")
    p.add_argument("--model-pkl", required=True,
                   help="pickled sklearn/xgboost classifier "
                        "(the reference's trained_model.pkl; unpickling "
                        "executes code — trusted artifacts only)")
    p.add_argument("--scaler-pkl", default="",
                   help="joblib StandardScaler (the reference's "
                        "scaler.pkl); omit for identity scaling")
    p.add_argument("--out-model", required=True)
    p.set_defaults(fn=cmd_import_model)

    p = sub.add_parser(
        "connectors",
        help="register the Debezium Postgres source connector "
             "(the reference's make connectors)")
    p.add_argument("--connect-url", default="http://localhost:8083")
    p.add_argument("--name", default="pg-src-connector")
    p.add_argument("--db-host", default="postgres")
    p.add_argument("--db-port", type=int, default=5432)
    p.add_argument("--db-user", default="postgres")
    p.add_argument("--db-password", default="postgres")
    p.add_argument("--db-name", default="postgres")
    p.add_argument("--schema", default="payment")
    p.add_argument("--topic-prefix", default="debezium")
    p.add_argument("--timeout", type=float, default=10.0)
    p.set_defaults(fn=cmd_connectors)

    p = sub.add_parser(
        "dashboard",
        help="render the static-HTML ops dashboard (the Superset role)")
    p.add_argument("--data", default="",
                   help="analyzed output directory (ParquetSink)")
    p.add_argument("--flight-record", default="",
                   help="render the ops-health view from a flight-record "
                        "JSONL (per-phase latency series + event strip) "
                        "instead of the analyzed-output view")
    p.add_argument("--out", default="dashboard.html")
    p.add_argument("--threshold", type=float, default=0.5)
    p.add_argument("--top-k", type=int, default=10)
    p.add_argument("--bucket", default="day", choices=["hour", "day"])
    p.add_argument("--title", default=None,
                   help="page title (default set in io.dashboard)")
    p.set_defaults(fn=cmd_dashboard)

    p = sub.add_parser(
        "trace",
        help="summarize an exported span trace (critical path, top-K "
             "slowest spans, recompiles, ASCII waterfall)")
    p.add_argument("--trace", required=True,
                   help="Chrome-trace JSON from `score --trace-out` or "
                        "GET /trace")
    p.add_argument("--top-k", type=int, default=10,
                   help="slowest batches/spans to list")
    p.add_argument("--batch", default="",
                   help="trace id (e.g. b00000042) to render the "
                        "waterfall for (default: the slowest batch)")
    p.add_argument("--json", action="store_true",
                   help="print the machine-readable summary as one "
                        "JSON line instead of the text report")
    p.set_defaults(fn=cmd_trace)

    p = sub.add_parser(
        "verify-device",
        help="prove that every dispatch signature of template engines "
             "(synthetic weights) of each served kind captures into a "
             "CUDA graph on --device (on the CPU the signatures are "
             "listed); the JAX command's jaxpr verifier has no PyTorch "
             "counterpart")
    p.add_argument("--json", action="store_true",
                   help="machine-readable report")
    p.add_argument("--strict", action="store_true",
                   help="P2 findings also fail the gate (the capture "
                        "check has only P0 findings)")
    p.add_argument("--verbose", action="store_true",
                   help="also list the targets that passed")
    p.add_argument("--no-baseline", action="store_true",
                   help="accepted; the capture check keeps no baseline")
    p.add_argument("--update-baseline", action="store_true",
                   help="refused (exit 2): the capture check keeps no "
                        "baseline")
    p.add_argument("--reason", default="",
                   help="accepted; the capture check keeps no baseline")
    p.add_argument("--baseline", default="",
                   help="accepted; the capture check keeps no baseline")
    p.add_argument("--check", action="append",
                   help="run only this check (repeatable)")
    p.add_argument("--list-checks", action="store_true",
                   help="print the check catalog and exit")
    _device_flag(p, "to capture on")
    p.set_defaults(fn=cmd_verify_device)

