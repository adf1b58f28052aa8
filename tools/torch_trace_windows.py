#!/usr/bin/env python3
"""The cost of the port's span tracer, its device track's idle share and
its overlay on a profiler trace, in one benchmark cell on one card.

    python3 tools/torch_trace_windows.py \\
        --workload forest_t100_exact.cards64k --seed 2147483711 \\
        --seconds 10 --pairs 3 [--out out/windows.jsonl]

Sets the cell up as ``fraudbench/run.py`` does (the stream, the weights
and the engine from the seed, the warm run), serves one unmeasured
window, then windows of ``--seconds`` through ``ScoringEngine.run`` on
the same engine:

1. ``--pairs`` pairs of windows, the tracer off and on (the profiler off),
   in alternating order: each window's rows landed per second; each traced
   window's ``trace`` entry and, from its export, the device track's idle
   share (``summarize_chrome``'s ``device_idle_by_span`` over the track's
   window);
2. one window with the tracer on under ``torch.profiler`` (CPU and CUDA),
   as the benchmark's traced run: the profiler's busy seconds
   (``fraudbench/trace.py``, and over kernels and copies alone) against
   the device track's steps and compactions, and the offset of each
   device span from the first kernel of its replay in the profiler's
   trace (both on Kineto's clock): the first kernel after the span's
   start less 100 µs, and the first device event of the replay's own
   ``cudaGraphLaunch`` (``launch_overlay``).

Prints one JSON line per window and a summary line, each with the card's
name and power limit; ``--out`` writes them too. Exits non-zero without
CUDA. Not a benchmark cell: the windows share one process, so their rates
compare within it.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from bisect import bisect_left
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "fraudbench" / "_cache"
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
sys.path.insert(0, str(ROOT))

STAGE_PARTS = {
    "host_prep": ("host_prep/dedup", "host_prep/validate",
                  "host_prep/staging_wait", "host_prep/pack"),
    "dispatch": ("dispatch/h2d", "dispatch/replay", "dispatch/fetch_issue"),
    "result_wait": ("result_wait/fetch_wait", "result_wait/decode",
                    "result_wait/hooks", "result_wait/tail"),
}


def card() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True)
    except OSError:
        return {"card": "unknown"}
    return {"card": out.stdout.strip().splitlines()[0]
            if out.returncode == 0 and out.stdout.strip() else "unknown"}


def stage_sums(trace: dict) -> dict:
    """Each stage's median against the sum of its parts' medians (the
    result wait's compaction counted on its own batches: its median times
    its share of the batches), and the share of the stage's whole time
    its parts cover (its parts are leaves: the stage's total is its self
    time and theirs)."""
    spans = trace["spans"]
    out = {}
    for stage, parts in STAGE_PARTS.items():
        if stage not in spans:
            continue
        parts = [p for p in parts + ("state_compact",) if p in spans
                 and (p != "state_compact" or stage == "result_wait")]
        med = sum(spans[p]["median_ms"] * spans[p]["count"]
                  / spans[stage]["count"] if p == "state_compact"
                  else spans[p]["median_ms"] for p in parts)
        own = spans[stage]["self_ms"]
        total = own + sum(spans[p]["self_ms"] for p in parts)
        out[stage] = {"median_ms": spans[stage]["median_ms"],
                      "parts_ms": med,
                      "ratio": med / spans[stage]["median_ms"],
                      "mean_ms": total / spans[stage]["count"],
                      "covered": 1.0 - own / total}
    return out


def overlay(events: list, tracer_trace: dict) -> dict:
    """Per device signature of the tracer's export, the offsets (µs) of
    the first kernel of each replay in the profiler's events from the
    span's start (the first kernel starting at most 100 µs before the
    start; copies, fills and the profiler's device-side annotation ranges
    are no kernels): median, quartiles and count. A replayed graph's
    span starts where its first node ran, so the offset is the error of
    the anchor's clock; an eager dispatch's, where its work was queued,
    so there the offset adds the time the work took to launch."""
    kernels = sorted(a for name, on_dev, a, b in events
                     if on_dev and not name.startswith(
                         ("Memcpy", "Memset", "rtfds.", "fraudbench.")))
    dev = sorted((e for e in tracer_trace["traceEvents"]
                  if e.get("cat") == "device"), key=lambda e: e["ts"])
    offsets: dict = {}
    for e in dev:
        i = bisect_left(kernels, e["ts"] - 100.0)
        if i < len(kernels) and kernels[i] < e["ts"] + e["dur"]:
            offsets.setdefault(e["name"], []).append(kernels[i] - e["ts"])
    return {name: {"n": len(v), "median_us": statistics.median(v),
                   "quartiles_us": statistics.quantiles(v, n=4)
                   if len(v) > 1 else v}
            for name, v in offsets.items()}


def launch_overlay(kineto: list, tracer_trace: dict) -> dict:
    """Per device signature, the offset (µs) of the first device event
    of each replay from the span's start: the replay's ``cudaGraphLaunch``
    is the one inside the host span that launched it (``launched_by``),
    its device events those sharing its correlation id. ``kineto`` holds
    ``(name, on_device, start µs, correlation id)``."""
    launches = sorted((a, c) for name, on_dev, a, c in kineto
                      if not on_dev and "GraphLaunch" in name)
    first: dict = {}
    for name, on_dev, a, c in kineto:
        if on_dev and not name.startswith(("rtfds.", "fraudbench.")):
            first[c] = min(a, first.get(c, a))
    host = {e["args"]["id"]: e for e in tracer_trace["traceEvents"]
            if e.get("cat") != "device" and "id" in e.get("args", {})}
    offsets: dict = {}
    for e in tracer_trace["traceEvents"]:
        h = host.get((e.get("args") or {}).get("launched_by"))
        if e.get("cat") != "device" or h is None:
            continue
        i = bisect_left(launches, (h["ts"], -1))
        if i < len(launches) and launches[i][0] <= h["ts"] + h["dur"] \
                and launches[i][1] in first:
            offsets.setdefault(e["name"], []).append(
                first[launches[i][1]] - e["ts"])
    return {name: {"n": len(v), "median_us": statistics.median(v),
                   "quartiles_us": statistics.quantiles(v, n=4)
                   if len(v) > 1 else v}
            for name, v in offsets.items()}


def main(argv) -> int:
    ap = argparse.ArgumentParser(prog="tools/torch_trace_windows.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from fraudbench.gen.simulator import Stream
    from fraudbench.harness import Feed, Landing, load_cell
    from fraudbench.trace import profiler_events, reduce_events
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        get_tracer,
        summarize_chrome,
    )

    info = {"workload": args.workload, "seed": args.seed,
            "torch": torch.__version__, **card()}
    lines = []

    def emit(rec: dict) -> None:
        rec = {**info, **rec}
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    device = torch.device("cuda")
    cell = load_cell(args.workload)
    traffic = cell["traffic"]
    stream = Stream(traffic, args.seed, device)
    torch.cuda.synchronize()
    reg = MetricsRegistry()
    kind = cell["kind"].Kind(cell["config"], traffic, stream, args.seed,
                             device, reg,
                             lambda g: stream.device_rows(g, device))
    engine = kind.engine
    feed = Feed(stream, traffic.day0 * 86400)
    engine.run(feed, sink=Landing(None, traffic.batch_rows),
               max_batches=traffic.warm_batches)
    torch.cuda.synchronize()
    tracer = get_tracer().configure(capacity=1 << 18)

    def window(traced: bool, profiled: bool = False) -> dict:
        landing = Landing(None, traffic.batch_rows)
        tracer.clear()
        tracer.configure(enabled=traced)
        prof = None
        if profiled:
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        t0 = time.perf_counter()
        feed.deadline = t0 + args.seconds
        with torch.profiler.record_function("fraudbench.window"):
            stats = engine.run(feed, sink=landing)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.stop()
        tracer.configure(enabled=False)
        rows = sum(n for _, _, n in landing.landed)
        rec = {"traced": traced, "profiled": profiled,
               "tx_per_s": rows / wall, "window_s": wall,
               "batches": stats["batches"],
               "stage_ms_p50": stats["stage_ms_p50"]}
        if traced:
            export = tracer.export_chrome()
            digest = summarize_chrome(export, top_k=0)
            rec["trace"] = stats["trace"]
            rec["stage_sums"] = stage_sums(stats["trace"])
            rec["spans_dropped"] = export["otherData"][
                "spans_dropped_by_ring"]
            if "device_window_ms" in digest:
                idle = digest["device_idle_by_span"]
                rec["device_track"] = {
                    "window_ms": digest["device_window_ms"],
                    "busy_ms": digest["device_busy_ms"],
                    "idle_share": sum(idle.values())
                    / digest["device_window_ms"],
                    "idle_by_span_ms": idle}
            dev = stats["trace"]["device"]
            est = sum(dev[k]["median_ms"] * dev[k]["count"]
                      for k in ("device/step", "device/compact")
                      if k in dev) / 1e3
            rec["track_busy_s_from_medians"] = est
            if prof is not None:
                events = profiler_events(prof)
                red = reduce_events(events)
                # the kernels and copies alone: the benchmark's busy
                # seconds also count Kineto's device-side annotation
                # ranges, which hold each graph launch's wait
                work = reduce_events([e for e in events if not (
                    e[1] and e[0].startswith(("rtfds.", "fraudbench.")))])
                rec["profiler"] = {"busy_s": red["busy_s"],
                                   "work_busy_s": work["busy_s"],
                                   "window_s": red["window_s"],
                                   "idle_by_host": red["idle_by_host"]}
                rec["overlay"] = overlay(events, export)
                kineto = [(k.name(), k.device_type() == DeviceType.CUDA,
                           k.start_ns() * 1e-3, k.correlation_id())
                          for k in prof.profiler.kineto_results.events()]
                rec["launch_overlay"] = launch_overlay(kineto, export)
                del prof, events, kineto
        return rec

    window(True)  # unmeasured: the first window after the warm run
    for i in range(args.pairs):
        for traced in ((False, True) if i % 2 == 0 else (True, False)):
            emit({"window": "pair", "pair": i, **window(traced)})
    emit({"window": "profiled", **window(True, profiled=True)})
    pairs = [r for r in lines if r["window"] == "pair"]
    off = [r["tx_per_s"] for r in pairs if not r["traced"]]
    on = [r["tx_per_s"] for r in pairs if r["traced"]]
    # each pair's own cost; the median is resolved only where the pairs'
    # interquartile range is narrower than it
    costs = [1.0 - b / a for a, b in zip(off, on)]
    quart = (statistics.quantiles(costs, n=4) if len(costs) > 1
             else costs * 3)
    emit({"window": "summary",
          "tx_per_s_off": off, "tx_per_s_on": on,
          "cost": 1.0 - statistics.median(on) / statistics.median(off),
          "pair_costs": costs, "pair_cost_quartiles": quart,
          "cost_resolved": quart[2] - quart[0] < abs(quart[1]),
          "idle_share_profiler_free": [
              r["device_track"]["idle_share"] for r in pairs
              if "device_track" in r]})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            for rec in lines:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
