#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. ``device`` — the card's name and count, and nvidia-smi's name and power
   limit (also printed as nvidia-smi gives them).
2. ``build`` — build every kernel of the path from ``csrc/`` (nvcc for
   sm_90a) and print the compiler's register and shared-memory report.
3. ``kernel`` — each kernel against its plain PyTorch version on the card,
   at the flagship forest (T=100, depth 8) and B = 65,536 and a ragged
   B = 300, in every z mode, with its time, the plain version's time and
   the bound.
4. ``main_path`` — the default dataset (``DataConfig()``, seed 0) served
   through ``ScoringEngine.run`` at 65,536-row batches into a
   ``MemorySink``, with rows/s, latency and the median time of each loop
   stage; every launch counter is set to 0 just before the run and read
   just after, and the first two batches are held against a CPU-device
   engine on the same batches.
5. ``profile`` — a few batches of the same path under ``torch.profiler``:
   device time by kernel and the device's idle share.
6. ``kernels`` — one line per the measurement contract.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises and
exits non-zero without that line. Without CUDA, or outside a checkout of
the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
# H100 SXM float32 rate outside the tensor cores, taken for the kernel's
# 32-bit integer and compare operations too (their own rate is lower, so
# the bound errs short)
INT32_OPS_PER_S = 67e12
START_EPOCH_S = 1_743_465_600  # 2025-04-01, DataConfig.start_date
ATOL_LEAF = 1e-5  # leaf sums (both sides add trees in order: expect 0)
RTOL_FEATURE = 1e-6  # float32 window sums in another order
KERNEL_ROWS = (300, 65536)  # a ragged batch, then the serving bucket
BATCH_ROWS = 65536  # the main path's batch bucket
PROFILE_BATCHES = 4


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    name, power = (s.strip() for s in smi.split(",", 1))
    dev = {"kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count(),
           "smi_name": name, "power_limit": power}
    emit({"phase": "device", **dev})
    return dev


def phase_build() -> None:
    from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels

    t0 = time.perf_counter()
    path, report = forest_kernels.build_library()
    forest_kernels._library()
    emit({"phase": "build", "kernel": "fused_forest",
          "seconds": time.perf_counter() - t0,
          "library": str(path.relative_to(ROOT)),
          "ptxas": [ln.strip() for ln in report.splitlines()
                    if "registers" in ln or "spill" in ln]})


def _gathered_rows(rng, b: int, nb: int, dev):
    """Gathered window rows like the serving path's: stamps within the
    last ~45 days (some empty), small counts, cent amounts, fraud ≤ count."""
    day = np.full(b, 20200, np.int32)
    bd = (20200 - rng.integers(-1, 46, (b, nb))).astype(np.int32)
    bd[rng.random((b, nb)) < 0.3] = -1
    c_cnt = rng.integers(0, 4, (b, nb)).astype(np.float32)
    c_amt = (c_cnt * rng.integers(100, 20000, (b, nb)) / 100.0
             ).astype(np.float32)
    t_cnt = rng.integers(0, 30, (b, nb)).astype(np.float32)
    t_frd = np.minimum(rng.integers(0, 3, (b, nb)), t_cnt).astype(np.float32)
    as_t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return dict(
        c_rows=(as_t(bd), as_t(c_cnt), as_t(c_amt)),
        t_rows=(as_t(bd.copy()), as_t(t_cnt), as_t(t_frd)),
        day=as_t(day),
        tod_s=as_t(rng.integers(0, 86400, b).astype(np.int32)),
        amount=as_t((rng.integers(100, 30000, b) / 100.0).astype(np.float32)),
    )


def _bound_ms(args, tables, feats, n_real_trees: int) -> dict:
    """Least time for the function on this card: the larger of the bytes
    (each input read once, each output written once) over the memory rate
    and the operations these inputs need over the 32-bit rate.

    Needed operations: per row the feature assembly (per table and bucket
    an age, two liveness compares and, per window, a compare and two adds;
    the ratios, the flags and the standardization), and per tree one
    compare per level of the path the row takes plus the add of its leaf.
    The levels are counted on this run's data: the dense form with each
    leaf's value replaced by its depth sums, per row, the depth of the
    leaf it reaches in every tree. ``algorithm_ops`` is what the kernel's
    compact algorithm does instead (a compare per real node, an add per
    path entry, a compare per real leaf): reported, not the bound."""
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        gemm_leaf_sum,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
        transform,
    )

    b, nb = args["c_rows"][0].shape
    n_feat = feats.shape[1]
    n_win = (n_feat - 3) // 4
    tensors = [*args["c_rows"], *args["t_rows"], args["day"], args["tod_s"],
               args["amount"], args["scaler_mean"], args["scaler_scale"],
               tables.node_feat, tables.gemm.thresh, tables.leaf_entries,
               tables.leaf_target, tables.gemm.leaf_val]
    nbytes = sum(t.numel() * t.element_size() for t in tensors) \
        + b * 4 + b * n_feat * 4

    x = transform(Scaler(args["scaler_mean"], args["scaler_scale"]), feats)
    x = torch.nn.functional.pad(x, (0, tables.gemm.sel.shape[1] - n_feat))
    real_leaf = (tables.leaf_target < 10 ** 9).to(torch.float32)
    depth = (tables.leaf_entries >= 0).sum(dim=2).to(torch.float32)
    reached = gemm_leaf_sum(tables.gemm._replace(leaf_val=real_leaf), x,
                            tables.z_mode)
    check(bool((reached == n_real_trees).all()),
          "a row does not reach exactly one leaf per tree")
    levels = int(gemm_leaf_sum(tables.gemm._replace(leaf_val=depth), x,
                               tables.z_mode).sum())
    feature_ops = b * (2 * nb * (3 + 3 * n_win) + 2 * n_win + 4 + 2 * n_feat)
    needed_ops = feature_ops + levels + b * n_real_trees

    real = slice(0, n_real_trees)
    algorithm_ops = b * int((tables.node_feat[real] >= 0).sum()
                            + (tables.leaf_entries[real] >= 0).sum()
                            + real_leaf[real].sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = needed_ops / INT32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "needed_ops": needed_ops,
            "mean_levels_per_tree": levels / (b * n_real_trees),
            "algorithm_ops": algorithm_ops}


def phase_kernel(dev) -> dict:
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
        to_gemm,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        fit_scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels
    from real_time_fraud_detection_system_tpu_torch.ops.features_fused import (
        assemble_features,
    )

    g = to_gemm(synthetic_ensemble(100, 8, 15, seed=0, device=dev), 15)
    check(forest_kernels.admit_tables(g).fits, "flagship forest not admitted")
    tables = {z: forest_kernels.to_kernel_tables(g, z)
              for z in ("f32", "bf16", "int8")}
    rng = np.random.default_rng(0)
    out = {"max_abs_err": 0.0}
    for b in KERNEL_ROWS:
        args = _gathered_rows(rng, b, 40, dev)
        feats = assemble_features(args["c_rows"], args["t_rows"], args["day"],
                                  args["tod_s"], args["amount"],
                                  windows=(1, 7, 30), delay=7,
                                  weekend_start=5, night_end=6)
        scaler = fit_scaler(feats.cpu().numpy(), device=dev)
        args.update(scaler_mean=scaler.mean, scaler_scale=scaler.scale)
        leaves, plains = {}, {}
        for z, tab in tables.items():
            leaf, kfeats = forest_kernels.fused_forest_leaf_sum(tab, **args)
            torch.cuda.synchronize()
            pleaf, pfeats = forest_kernels.fused_forest_leaf_sum_plain(
                tab, **args)
            err_leaf = float((leaf - pleaf).abs().max())
            check(err_leaf <= ATOL_LEAF, f"leaf sums differ by {err_leaf}")
            check(bool(((leaf / 100 >= 0.5) == (pleaf / 100 >= 0.5)).all()),
                  "decisions differ from the plain version")
            counts = [0, 1, 2, 3, 5, 7, 9, 11, 13]
            check(torch.equal(kfeats[:, counts], pfeats[:, counts]),
                  "count/flag features differ from the plain version")
            torch.testing.assert_close(kfeats, pfeats, rtol=RTOL_FEATURE,
                                       atol=0.0)
            out["max_abs_err"] = max(out["max_abs_err"], err_leaf,
                                     float((kfeats - pfeats).abs().max()))
            leaves[z], plains[z] = leaf, pleaf
        for z in ("bf16", "int8"):
            check(torch.equal(leaves[z], leaves["f32"]),
                  f"kernel z_mode {z} is not bit-identical to f32")
            check(torch.equal(plains[z], plains["f32"]),
                  f"plain z_mode {z} is not bit-identical to f32")
        line = {"phase": "kernel", "rows": b,
                "max_abs_err": out["max_abs_err"],
                "decision_share_fraud": float((leaves["f32"] / 100 >= 0.5)
                                              .float().mean())}
        if b == KERNEL_ROWS[-1]:
            tab = tables["int8"]
            out["ms"] = cuda_ms(
                lambda: forest_kernels.fused_forest_leaf_sum(tab, **args), 20)
            out["plain_ms"] = cuda_ms(
                lambda: forest_kernels.fused_forest_leaf_sum_plain(
                    tab, **args), 3)
            bound = _bound_ms(args, tab, feats, 100)
            out.update(bound_ms=bound["bound_ms"], bound_by=bound["bound_by"])
            line.update(ms=out["ms"], plain_ms=out["plain_ms"], **bound,
                        library_ms=None)
        emit(line)
    return out


def phase_main_path(dev, device_info) -> dict:
    from real_time_fraud_detection_system_tpu_torch.config import (
        Config,
        RuntimeConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.data import (
        generate_dataset,
    )
    from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        fit_scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    t0 = time.perf_counter()
    cfg = Config(runtime=RuntimeConfig(batch_buckets=(BATCH_ROWS,)))
    _, _, txs = generate_dataset(cfg.data)
    gen_s = time.perf_counter() - t0
    check(txs.customer_id.max() < cfg.features.customer_capacity
          and txs.terminal_id.max() < cfg.features.terminal_capacity,
          "ids exceed the direct-mode capacities")
    ens = synthetic_ensemble(cfg.model.forest_n_trees,
                             cfg.model.forest_max_depth, 15, seed=0,
                             device="cpu")

    # Scaler: fitted on a numpy sample of the stream's own features (the
    # first 4 batches, served by a throwaway engine).
    probe = ScoringEngine(cfg, "forest", ens,
                          fit_scaler(np.ones((2, 15)), device=dev),
                          device=dev)
    src = ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS)
    sample = [probe.process_batch(src.poll_batch()).features
              for _ in range(4)]
    scaler = fit_scaler(np.concatenate(sample), device=dev)
    del probe

    eng = ScoringEngine(cfg, "forest", ens, scaler, device=dev)
    check(eng.tables is not None, "fused kernel not admitted")
    sink = MemorySink()
    torch.cuda.synchronize()
    forest_kernels.fused_forest_leaf_sum.launches = 0
    stats = eng.run(ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS),
                    sink)
    launches = forest_kernels.fused_forest_leaf_sum.launches
    check(launches == stats["batches"],
          f"{launches} kernel launches for {stats['batches']} batches")
    check(stats["rows"] == txs.n, "not every row was scored")

    out = sink.concat()
    probs = out["prediction"]
    check(probs.shape == (txs.n,) and bool(np.isfinite(probs).all())
          and probs.min() >= 0.0 and probs.max() <= 1.0,
          "probabilities not finite in [0, 1]")
    feat_cols = [k for k in out if k.startswith(("tx_during", "customer_id_",
                                                 "terminal_id_"))]
    check(len(feat_cols) == 14 and all(np.isfinite(out[k]).all()
                                       for k in feat_cols),
          "feature columns missing or not finite")

    # The first two batches against a CPU-device engine on the same batches.
    cpu_scaler = scaler.to("cpu")
    ref = ScoringEngine(cfg, "forest", ens, cpu_scaler, device="cpu")
    ref_sink = MemorySink()
    ref.run(ReplaySource(txs, START_EPOCH_S, batch_rows=BATCH_ROWS), ref_sink,
            max_batches=2)
    max_err = 0.0
    for got, want in zip(sink.batches[:2], ref_sink.batches):
        for k in feat_cols:
            if k.startswith(("tx_during", "customer_id_nb", "terminal_id_nb",
                             "terminal_id_risk")):
                check(np.array_equal(got[k], want[k]), f"{k} differs on CPU")
            else:
                np.testing.assert_allclose(got[k], want[k], rtol=RTOL_FEATURE)
        np.testing.assert_allclose(got["prediction"], want["prediction"],
                                   atol=ATOL_LEAF / 100)
        check(np.array_equal(got["prediction"] >= 0.5,
                             want["prediction"] >= 0.5),
              "decisions differ from the CPU engine")
        max_err = max(max_err, float(np.abs(got["prediction"]
                                            - want["prediction"]).max()))
    emit({"phase": "main_path", "rows": stats["rows"],
          "batches": stats["batches"], "kernel_launches": launches,
          "rows_per_s": stats["rows_per_s"],
          "latency_p50_ms": stats["latency_p50_ms"],
          "latency_p99_ms": stats["latency_p99_ms"],
          "stage_ms_p50": stats["stage_ms_p50"],
          "wall_s": stats["wall_s"], "datagen_s": gen_s,
          "z_mode": stats["z_mode"],
          "fraud_share": float((probs >= 0.5).mean()),
          "max_abs_err_vs_cpu_engine": max_err,
          "card": device_info["smi_name"],
          "power_limit": device_info["power_limit"]})
    return {"launches": launches, "cfg": cfg, "ens": ens, "scaler": scaler,
            "txs": txs}


def phase_profile(dev, served) -> None:
    """Device time by kernel over a few batches of the main path under
    torch.profiler, and the device's idle share of that window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    eng = ScoringEngine(served["cfg"], "forest", served["ens"],
                        served["scaler"], device=dev)
    src = ReplaySource(served["txs"], START_EPOCH_S, batch_rows=BATCH_ROWS)
    eng.run(src, max_batches=1)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(src, max_batches=PROFILE_BATCHES)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + e.device_time_total / 1e3
    n = PROFILE_BATCHES
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    emit({"phase": "profile", "batches": n, "rows_per_batch": BATCH_ROWS,
          "wall_ms_per_batch": wall_ms / n,
          "device_ms_per_batch": ({k[:80]: v / n for k, v in top}
                                  if device else "not measured"),
          "device_busy_ms_per_batch": busy / n if device else None,
          "device_idle_share": 1.0 - busy / wall_ms if device else None})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import real_time_fraud_detection_system_tpu_torch  # noqa: F401

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda", 0)
    info = phase_device()
    phase_build()
    k = phase_kernel(dev)
    m = phase_main_path(dev, info)
    phase_profile(dev, m)
    emit({"kernels": [{
        "name": "fused_forest_leaf_sum",
        "route": "cuda",
        "source": "real_time_fraud_detection_system_tpu_torch/csrc/"
                  "fused_forest.cu",
        "replaces": "real_time_fraud_detection_system_tpu/ops/"
                    "pallas_forest.py:398",
        "launches": m["launches"],
        "max_abs_err": k["max_abs_err"],
        "ms": k["ms"],
        "plain_ms": k["plain_ms"],
        "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"],
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
