"""One run of one cell: set-up, the timed window through the program's
``ScoringEngine.run``, the metrics, and the check of what the window
produced against the plain reference.

Everything a cell is made of is found by name: ``BENCHMARK.json`` names
the cell's configuration and traffic; ``configs/<config>.json`` holds the
configuration as it is run (its ``kind`` names ``kinds/<kind>.py``, which
builds the program's engine and calls the reference);
``traffic/<traffic>.json`` the traffic's parameters, which
``gen/simulator.py`` draws from; ``limits/<config>.json`` the check's sample
size and limits; ``metrics/<metric>.py`` one reader per metric (its
twin ``<metric>.<cells>``, under another bound, shares it).

The run:

1. set-up (``setup_s``, from the process's start): the stream from the
   seed, the weights from the seed, the engine, and a warm run over the
   stream's first ``warm_batches`` batches, which captures the step's
   CUDA graphs and fills the hot tier;
2. the window: ``run`` over the rest of the stream through the port's
   ``ReplaySource``, ended by the first poll after ``--seconds``; every
   batch stamped when its poll returned and when it landed in the sink
   (a ``MemorySink`` that keeps only the sampled rows), all of it
   counted. A traced run serves the same window untraced first, then
   the traced one;
3. the check, once the window has closed and the engine is freed: the
   sampled rows, against the reference.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from fraudbench.gen.simulator import Stream, Traffic

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
PORT = "real_time_fraud_detection_system_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "real_time_fraud_detection_system_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, overrides: Optional[dict] = None) -> dict:
    """The cell and everything it names, by name. ``overrides`` replaces
    keys of the traffic (``traffic``) and of the configuration's groups
    (``features``, ``runtime``, ``model``): the CPU tests' small sizes."""
    overrides = overrides or {}
    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = load_json(ROOT / cfg["file"])
    for group in ("features", "runtime", "model"):
        config[group] = {**config[group], **overrides.get(group, {})}
    traffic = {**load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
               **overrides.get("traffic", {})}
    metrics = [m for m in bench["end_to_end"] + bench["per_layer"]
               if name in m.get("workloads", [name])]
    return {
        "bench": bench, "cell": cell, "config": config,
        "traffic": Traffic.from_json(traffic),
        "limits": load_json(BENCH / "limits" / f"{cell['config']}.json"),
        "kind": importlib.import_module(f"fraudbench.kinds.{config['kind']}"),
        "end_to_end": [m for m in metrics if m in bench["end_to_end"]],
        "per_layer": [m for m in metrics if m in bench["per_layer"]],
    }


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read(ctx)``. A metric ``<base>.<cells>``
    with no file of its own, the same reading under another set of cells
    and bound, is read by ``metrics/<base>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{metric.split('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"fraudbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole (the port's name begins with the JAX
    package's)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class _Cycle:
    """The pool's replay that a window reaches past the stream's end, as
    the table ``ReplaySource`` slices: the stored pool's rows, their ids
    and days shifted a batch at a time as they are polled, so that
    reaching it stalls no poll."""

    def __init__(self, base, lo: int, id_shift: int, day_shift: int):
        self.base, self.lo = base, lo
        self.id_shift, self.day_shift = id_shift, day_shift
        self.n = base.n - lo

    def slice(self, rows: slice):
        part = self.base.slice(slice(self.lo + rows.start,
                                     self.lo + rows.stop))
        part.tx_id = part.tx_id + self.id_shift
        part.tx_time_seconds = part.tx_time_seconds \
            + self.day_shift * 86400
        part.tx_time_days = part.tx_time_days + np.int32(self.day_shift)
        return part


class Feed:
    """The window's source: the port's columnar ``ReplaySource`` over the
    generated stream (the pool replayed, days shifted, when a window
    outruns it), ended by the first poll past ``deadline``; each poll's
    return time is stamped with its batch's first tx id."""

    def __init__(self, stream: Stream, start_epoch_s: int):
        from real_time_fraud_detection_system_tpu_torch.data.generator import (
            Transactions,
        )

        s, t = stream, stream.traffic
        self.stream = stream
        self.start_epoch_s = start_epoch_s
        days = np.repeat(s.batch_day, t.batch_rows)
        n = len(days)
        self.table = Transactions(
            tx_id=np.arange(n, dtype=np.int64),
            tx_time_seconds=(days - t.day0) * 86400 + s.tod_s,
            tx_time_days=(days - t.day0).astype(np.int32),
            customer_id=s.customer_id, terminal_id=s.terminal_id,
            amount_cents=s.amount_cents, tx_fraud=s.label,
            tx_fraud_scenario=np.zeros(n, np.int8))
        self.cycle = 0
        self._src = self._replay(0)
        self.deadline: Optional[float] = None
        self.polls: list = []

    def _replay(self, cycle: int):
        from real_time_fraud_detection_system_tpu_torch.runtime.sources import (  # noqa: E501
            ReplaySource,
        )

        table = self.table
        if cycle > 0:
            t, r = self.stream.traffic, self.stream.batch_rows
            sh = self.stream.cycle(cycle)
            table = _Cycle(self.table, t.warm_batches * r,
                           (sh["first_batch"] - t.warm_batches) * r,
                           sh["day_shift"])
        return ReplaySource(table, self.start_epoch_s,
                            batch_rows=self.stream.batch_rows,
                            with_labels=True)

    def poll_batch(self):
        if self.deadline is not None \
                and time.perf_counter() >= self.deadline:
            return None
        cols = self._src.poll_batch()
        if cols is None:
            self.cycle += 1
            self._src = self._replay(self.cycle)
            cols = self._src.poll_batch()
        if self.deadline is not None:
            self.polls.append((time.perf_counter(), int(cols["tx_id"][0]),
                               len(cols["tx_id"])))
        return cols

    @property
    def offsets(self):
        return self._src.offsets

    def seek(self, offsets):
        self._src.seek(offsets)


class Landing:
    """The window's sink: the port's ``MemorySink`` does its work on every
    batch, then gives up the batch's columns, of which the sampled rows
    are kept (host memory stays bounded); each batch is stamped when it
    landed."""

    def __init__(self, sample: Optional[np.ndarray], rows: int):
        from real_time_fraud_detection_system_tpu_torch.io.sink import (
            MemorySink,
        )

        self.inner = MemorySink()
        self.sample = sample
        self.rows = rows
        self.landed: list = []
        self.bad = 0
        self.kept: list = []

    def append(self, res) -> None:
        self.inner.append(res)
        t = time.perf_counter()
        cols = self.inner.batches.pop()
        n = len(cols["tx_id"])
        first = int(cols["tx_id"][0]) if n else -1
        self.landed.append((t, first, n))
        pred = cols["prediction"]
        self.bad += n - int(np.count_nonzero((pred >= 0.0) & (pred <= 1.0)))
        if self.sample is None or n == 0:
            return
        g = first // self.rows
        if g >= len(self.sample):
            return
        idx = self.sample[g]
        idx = idx[idx < n]
        self.kept.append({k: v[idx] for k, v in cols.items()})


def weighted_quantile(values: np.ndarray, weights: np.ndarray,
                      q: float) -> float:
    """The q-quantile of ``values`` repeated ``weights`` times (the lower
    value at a tie, as the rank ``ceil(q · total)``)."""
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    cum = np.cumsum(w)
    rank = max(1, int(np.ceil(q * cum[-1])))
    return float(v[np.searchsorted(cum, rank)])


def counter_totals(reg) -> dict:
    """Every counter family's total, and the tier counter by tier."""
    snap = {}
    for name in ("rtfds_feature_slots_reclaimed_total",
                 "rtfds_rows_total", "rtfds_batches_total"):
        snap[name] = reg.family_total(name) or 0.0
    for tier in ("dense", "cms"):
        s = reg.get("rtfds_feature_tier_rows_total", tier=tier)
        snap[f"tier.{tier}"] = float(s.value) if s is not None else None
    return snap


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: Optional[float] = None,
             control: bool = False, overrides: Optional[dict] = None
             ) -> dict:
    """One run of cell ``name``. Returns the result line's fields, the
    checks and (with ``control``) the control's readings."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = load_cell(name, overrides)
    traffic, limits = cell["traffic"], cell["limits"]
    config = cell["config"]
    device = torch.device(device)
    cuda = device.type == "cuda"
    rows = traffic.batch_rows

    # -- set-up ------------------------------------------------------------
    stream = Stream(traffic, seed, device)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        get_tracer,
    )

    reg = MetricsRegistry()

    def rows_fn(g_last: int) -> dict:
        return stream.device_rows(g_last, device)

    kind = cell["kind"].Kind(config, traffic, stream, seed, device, reg,
                             rows_fn)
    engine = kind.engine
    feed = Feed(stream, traffic.day0 * 86400)
    t_warm = time.perf_counter()
    engine.run(feed, sink=Landing(None, rows),
               max_batches=traffic.warm_batches)
    if cuda:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t_warm
    n_sample = int(limits["sample_rows_per_batch"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), 0x5A]))
    sample = np.sort(rng.integers(0, rows, (stream.n_batches
                                            + 4 * traffic.pool_batches,
                                            n_sample)), axis=1)
    landing = Landing(sample, rows)
    batches0 = engine.state.batches_done

    # -- the window --------------------------------------------------------
    untraced = None
    t_first = time.perf_counter()
    if trace:
        # the same window untraced first, for what the profiler and the
        # program's spans would slow (``step_mfu``, ``latency_p95_ms``);
        # then the traced one
        feed.deadline = t_first + float(seconds)
        engine.run(feed, sink=landing)
        if cuda:
            torch.cuda.synchronize()
        untraced = {"window_s": time.perf_counter() - t_first,
                    "rows": sum(n for _, _, n in landing.landed),
                    "batches": engine.state.batches_done - batches0}
    runs = [(0, traffic.warm_batches - 1)]
    if untraced is not None:
        runs.append((batches0, engine.state.batches_done - 1))
    batches0 = engine.state.batches_done
    before = counter_totals(reg)
    prof = None
    tracer = get_tracer()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        tracer.configure(enabled=True)
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if cuda else [])
        prof = profile(activities=acts)
        prof.start()
    n_landed0 = len(landing.landed)
    t_w0 = time.perf_counter()
    feed.deadline = t_w0 + float(seconds)
    with torch.profiler.record_function("fraudbench.window"):
        stats = engine.run(feed, sink=landing)
    if cuda:
        torch.cuda.synchronize()
    t_w1 = time.perf_counter()
    trace_s = {}
    if prof is not None:
        t = time.perf_counter()
        prof.stop()
        trace_s["stop"] = time.perf_counter() - t
        tracer.configure(enabled=False)
    setup_s = t_first - t0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = counter_totals(reg)
    batches1 = engine.state.batches_done
    runs.append((batches0, batches1 - 1))

    # -- what the window did -----------------------------------------------
    polls = {first: (t, n) for t, first, n in feed.polls}
    attempted = sum(n for _, n in polls.values())
    # per window (the untraced one first, where a traced run has it):
    # each landed batch's latency from its poll, weighted by its rows
    lat = [([], []), ([], [])]
    landed = 0
    for j, (t, first, n) in enumerate(landing.landed):
        if first in polls and polls[first][1] == n:
            w = lat[1 if j >= n_landed0 else 0]
            w[0].append((t - polls[first][0]) * 1e3)
            w[1].append(n)
            landed += n
    lat = [(np.array(ms), np.array(n, dtype=np.float64)) for ms, n in lat]
    window = {"window_s": t_w1 - t_w0, "rows": int(lat[1][1].sum()),
              "batches": batches1 - batches0, "latency_ms": lat[1][0],
              "latency_rows": lat[1][1]}
    if untraced is not None:
        untraced.update(latency_ms=lat[0][0], latency_rows=lat[0][1])
    red = None
    if prof is not None:
        from fraudbench.trace import profiler_events, reduce_events

        t = time.perf_counter()
        events = profiler_events(prof)
        trace_s["events"] = time.perf_counter() - t
        t = time.perf_counter()
        red = reduce_events(events)
        trace_s["reduce"] = time.perf_counter() - t
        trace_s["n_events"] = len(events)
        del prof, events
    ctx = {
        "cell": cell["cell"], "config": config, "traffic": traffic,
        "stats": stats, "before": before, "after": after,
        "setup_s": setup_s, **window, "untraced": untraced or window,
        "trace": red, "kind": kind,
        "kernel_counts": kind.kernel_counts(rows),
        "quantile": weighted_quantile,
    }
    wanted = cell["end_to_end"] if not trace else cell["per_layer"]
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # -- the check ---------------------------------------------------------
    t_c0 = time.perf_counter()
    kind.release()
    del engine
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kept = {k: np.concatenate([b[k] for b in landing.kept])
            for k in landing.kept[0]} if landing.kept else None
    numbers = {"rows_missing": float(attempted - landed),
               "bad_probs": float(landing.bad)}
    control_numbers = None
    if kept is not None:
        tx = kept["tx_id"]
        g = torch.from_numpy(tx // rows).to(device)
        i = torch.from_numpy(tx % rows).to(device)
        order = torch.argsort(g * rows + i)
        smp = {"g": g[order], "i": i[order]}
        got = {"probs": torch.from_numpy(kept["prediction"]).to(device)
               [order]}
        names = getattr(cell["kind"], "FEATURE_COLUMNS", None)
        if names:
            got["features"] = torch.from_numpy(np.stack(
                [kept[c].astype(np.float64) for c in names], 1)) \
                .to(device)[order]
        tiers = {"dense": (after["tier.dense"] or 0.0)
                 - (before["tier.dense"] or 0.0),
                 "cms": (after["tier.cms"] or 0.0)
                 - (before["tier.cms"] or 0.0)}
        numbers.update(kind.compare(got, smp, runs, rows_fn, tiers))
        if control:
            control_numbers = kind.compare(got, smp, runs, rows_fn, tiers,
                                           control=True)
    else:
        numbers["no_rows_sampled"] = 1.0  # nothing to compare: not correct
    check_s = time.perf_counter() - t_c0
    checks = {}
    for k, v in numbers.items():
        lim = limits["limits"].get(k, 0.0)
        checks[k] = {"value": v, "limit": lim}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell["cell"]["chips"],
           "memory_peak_bytes": int(peak)}
    if red is not None:
        dev["busy_s"] = red["busy_s"]
        dev["window_s"] = red["window_s"]
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(attempted - landed + landing.bad),
           "metrics": metrics, "device": dev}
    if red is not None:
        from fraudbench.trace import breakdown

        out["breakdown"] = breakdown(red)
    if control_numbers is not None:
        out["control"] = control_numbers
    out["check_s"] = check_s
    out["stages_ms"] = stats["stage_ms_p50"]
    out["warm_s"] = warm_s
    if trace_s:
        out["trace_s"] = trace_s
    out["checks"] = checks
    return out


def main(argv, t0: float) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="fraudbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0,
                    help="also print the control's readings (the "
                         "reference in the next lower precision)")
    args = ap.parse_args(argv)
    if not (ROOT / PORT).is_dir():
        print(f"fraudbench: the program under test ({PORT}/) is not in "
              f"this checkout", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("fraudbench: no CUDA device", file=sys.stderr)
        return 2
    chips = load_cell(args.workload)["cell"]["chips"]
    if torch.cuda.device_count() < chips:
        print(f"fraudbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   t0=t0, control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"fraudbench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(f"fraudbench: stage medians (ms) {json.dumps(out['stages_ms'])}; "
          f"the check took {out['check_s']:.1f} s; tracing "
          f"{json.dumps(out.get('trace_s', {}))}", file=sys.stderr)
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
