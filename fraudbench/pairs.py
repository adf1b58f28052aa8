"""Pairs of runs of one cell from two checkouts, run the way a check of a
change runs them, and the arithmetic a bound is set from.

    python3 fraudbench/pairs.py --workload <cell> --trees <A> <B> \\
        --pairs 6 --seed <n> --session <label> --out <set.json>

Each pair runs ``python3 fraudbench/run.py --workload <cell> --seed <s>
--seconds <run_seconds> --trace 0`` from the root of checkout A and of
checkout B, one after the other: A first in the even pairs, B first in
the odd ones. Both sides of a pair share its seed (``<n> + pair``); no two
pairs share one. Each side gets a ``HOME``, ``XDG_CACHE_HOME`` and
``TMPDIR`` of its own inside its checkout, and ``run_seconds`` comes from
this checkout's ``BENCHMARK.json``. ``<label>`` names the session, one machine's
stretch of sets, which the host's name does not tell apart. Every run is
kept in ``<set.json>``, written again after each run: its exit code,
``correct``, ``failed``, the end-to-end metrics, the engine's stage
medians (``stages_ms``), ``warm_s``, ``window_s`` where printed, the peak
memory, the numbers the run compared, and the end of the standard error
of a run that failed. A run that exits non-zero or is not ``correct``
counts toward no median.
Each side's median and quartiles (``statistics.quantiles(n=4)``), its
spread ``(Q3 - Q1) / median`` and the gap ``|median_A - median_B| /
median_A`` are printed and written for every metric. ``setup_s`` leaves
out each side's first run of the invocation, which builds the program's
kernels in a fresh checkout.

    python3 fraudbench/pairs.py --merge <set.json>... --metric <name> \\
        --commit <sha> --out <record.json>

gathers sets into one record with the bound that ``set_bound`` gives for
``<name>`` over the sets that report it: the larger of five times the
widest side spread and the widest gap, held to [0.01, 0.25] and rounded
up to three decimals.

The tool imports neither torch nor the program, so it never holds the
card while a run does.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import signal
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parent.parent
PORT = "real_time_fraud_detection_system_tpu_torch"
SIDES = ("A", "B")
BOUND_MIN, BOUND_MAX = 0.01, 0.25
SPREAD_TIMES = 5
FIRST_RUN_S, RUN_S = 1200, 360  # a run's allowance: building, or built
ERR_TAIL = 2000


def plan(pairs: int, seed: int) -> list:
    """``(seed, (first side, second side))`` of each pair."""
    return [(seed + i, SIDES if i % 2 == 0 else SIDES[::-1])
            for i in range(pairs)]


def last_line(stdout: str) -> Optional[dict]:
    """The run's result: the JSON object on its last non-empty line."""
    lines = [ln for ln in stdout.splitlines() if ln.strip()]
    if not lines:
        return None
    try:
        out = json.loads(lines[-1])
    except json.JSONDecodeError:
        return None
    return out if isinstance(out, dict) else None


def keep(out: Optional[dict], rc: int) -> dict:
    """What a set keeps of one run's result line."""
    if out is None:
        return {"rc": rc, "correct": None}
    dev = out.get("device", {})
    kept = {
        "rc": rc, "correct": out.get("correct"),
        "failed": out.get("failed"), "attempted": out.get("attempted"),
        "metrics": {k: v["value"] for k, v in out.get("metrics", {}).items()},
        "stages_ms": out.get("stages_ms"), "warm_s": out.get("warm_s"),
        "memory_peak_bytes": dev.get("memory_peak_bytes"),
        "checks": {k: c["value"] for k, c in out.get("checks", {}).items()},
    }
    if "window_s" in dev:
        kept["window_s"] = dev["window_s"]
    return kept


def counts(run: dict) -> bool:
    """Whether a run counts toward its side's medians."""
    return run.get("rc") == 0 and run.get("correct") is True


def quartiles(values: list) -> dict:
    """Median, quartiles (``statistics.quantiles(n=4)``) and spread
    ``(Q3 - Q1) / median`` of at least two values."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return {"n": len(values), "median": med, "q1": q1, "q3": q3,
            "spread": (q3 - q1) / med}


def summarize(runs: list) -> dict:
    """Each metric's quartiles on each side, over the runs that count,
    and the gap between the sides' medians. ``setup_s`` leaves out each
    side's first run (``"first": true``), which builds."""
    names = sorted({m for r in runs if counts(r) for m in r["metrics"]})
    out = {}
    for name in names:
        sides = {}
        for side in SIDES:
            vals = [r["metrics"][name] for r in runs
                    if r["side"] == side and counts(r)
                    and name in r["metrics"]
                    and not (name == "setup_s" and r.get("first"))]
            if len(vals) >= 2:
                sides[side] = quartiles(vals)
        entry = dict(sides)
        if len(sides) == 2:
            entry["gap"] = abs(sides["A"]["median"] - sides["B"]["median"]) \
                / sides["A"]["median"]
        out[name] = entry
    return out


def round_up(x: float, places: int = 3) -> float:
    """``x`` rounded up to ``places`` decimals (a float's last bits do not
    carry it to the next step)."""
    scale = 10 ** places
    return math.ceil(round(x * scale, 9)) / scale


def clamp_bound(x: float) -> float:
    """A bound held to the contract's [0.01, 0.25], rounded up to three
    decimals."""
    return round_up(min(max(x, BOUND_MIN), BOUND_MAX))


def set_bound(sets: list, metric: str) -> dict:
    """The bound of ``metric`` from same-tree sets: the larger of
    ``SPREAD_TIMES`` times the widest side spread and the widest gap over
    the sets whose runs report it, recomputed from the runs."""
    spreads, gaps = [], []
    for s in sets:
        entry = summarize(s["runs"]).get(metric)
        if not entry or "gap" not in entry:
            continue
        spreads += [entry[side]["spread"] for side in SIDES]
        gaps.append(entry["gap"])
    if not gaps:
        raise ValueError(f"no set reports {metric} on both sides")
    widest_spread, widest_gap = max(spreads), max(gaps)
    return {"metric": metric, "sets": len(gaps),
            "widest_spread": widest_spread, "widest_gap": widest_gap,
            "raw": max(SPREAD_TIMES * widest_spread, widest_gap),
            "bound": clamp_bound(max(SPREAD_TIMES * widest_spread,
                                     widest_gap))}


def tree_digest(tree: Path) -> str:
    """SHA-256 over the program's and the benchmark's files in a checkout,
    their build caches left out: equal digests, the same code."""
    h = hashlib.sha256()
    skip = {"_build", "_cache", "__pycache__"}
    for top in (PORT, "fraudbench"):
        base = tree / top
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = sorted(d for d in dirnames if d not in skip)
            for f in sorted(filenames):
                p = Path(dirpath) / f
                h.update(str(p.relative_to(tree)).encode() + b"\0")
                h.update(p.read_bytes())
    return h.hexdigest()


def card() -> Optional[str]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if r.returncode != 0:
        return None
    return r.stdout.strip() or None


def side_env(tree: Path) -> dict:
    """The run's environment: this one, with a home, a cache and a
    temporary directory of the side's own, inside its checkout."""
    env = dict(os.environ)
    base = tree / "fraudbench" / "_cache" / "pairs_env"
    for var, sub in (("HOME", "home"), ("XDG_CACHE_HOME", "xdg_cache"),
                     ("TMPDIR", "tmp")):
        d = base / sub
        d.mkdir(parents=True, exist_ok=True)
        env[var] = str(d)
    return env


def run_one(tree: Path, workload: str, seed: int, seconds: int,
            timeout: float) -> dict:
    """One run from the root of ``tree``, its process group ended if it
    outlives ``timeout`` (exit code 124)."""
    cmd = [sys.executable, "fraudbench/run.py", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", "0"]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=tree, env=side_env(tree),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        stdout, stderr = proc.communicate()
        rc = 124
    run = keep(last_line(stdout), rc)
    run["wall_s"] = time.perf_counter() - t0
    if not counts(run):
        run["stderr_tail"] = stderr[-ERR_TAIL:]
    return run


def run_pairs(workload: str, trees: list, pairs: int, seed: int,
              out: Optional[Path] = None,
              session: Optional[str] = None) -> dict:
    """Run the pairs; write the set to ``out`` after every run."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    seconds = int(bench["run_seconds"])
    names = dict(zip(SIDES, map(str, trees)))
    by_side = {s: Path(t).resolve() for s, t in names.items()}
    rec = {"workload": workload, "seconds": seconds, "seed": seed,
           "trees": names,
           "digests": {s: tree_digest(t) for s, t in by_side.items()},
           "session": session, "host": socket.gethostname(),
           "card": card(),
           "started": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "runs": []}
    seen = set()
    for i, (s, order) in enumerate(plan(pairs, seed)):
        for side in order:
            first = side not in seen
            seen.add(side)
            run = run_one(by_side[side], workload, s, seconds,
                          FIRST_RUN_S if first else RUN_S)
            run.update(pair=i, side=side, seed=s, first=first)
            rec["runs"].append(run)
            rate = {k: round(v, 4) for k, v in run.get("metrics", {}).items()}
            print(f"pair {i} side {side} seed {s} rc {run['rc']} correct "
                  f"{run['correct']} {json.dumps(rate)} "
                  f"wall {run['wall_s']:.1f} s", flush=True)
            rec["summary"] = summarize(rec["runs"])
            if out is not None:
                write(out, rec)
    return rec


def write(path: Path, obj: dict) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(path.suffix + ".part")
    tmp.write_text(json.dumps(obj, indent=1) + "\n")
    tmp.replace(path)


def report(summary: dict) -> str:
    """The summary as lines: each metric's sides and gap."""
    lines = []
    for name, entry in summary.items():
        parts = [f"{name}:"]
        for side in SIDES:
            if side in entry:
                q = entry[side]
                parts.append(f"{side} n {q['n']} median {q['median']!r} "
                             f"q1 {q['q1']!r} q3 {q['q3']!r} "
                             f"spread {q['spread']:.6f};")
        if "gap" in entry:
            parts.append(f"gap {entry['gap']:.6f}")
        lines.append(" ".join(parts))
    return "\n".join(lines)


def merge(files: list, metric: str, commit: str) -> dict:
    """Sets gathered into one record with ``metric``'s bound."""
    sets = [json.loads(Path(f).read_text()) for f in files]
    return {"metric": metric, "commit": commit,
            "rule": "max(5 * widest side spread, widest gap) over the sets "
                    "that report the metric, held to [0.01, 0.25], rounded "
                    "up to three decimals; spread (Q3 - Q1) / median by "
                    "statistics.quantiles(n=4), gap |median_A - median_B| "
                    "/ median_A, over runs that exit 0 and are correct",
            "bound": set_bound(sets, metric), "sets": sets}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="fraudbench/pairs.py")
    ap.add_argument("--workload")
    ap.add_argument("--trees", nargs=2)
    ap.add_argument("--pairs", type=int, default=6)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--session")
    ap.add_argument("--merge", nargs="+", metavar="SET")
    ap.add_argument("--metric")
    ap.add_argument("--commit")
    ap.add_argument("--out", required=True, type=Path)
    args = ap.parse_args(argv)
    if args.merge:
        if not (args.metric and args.commit):
            ap.error("--merge needs --metric and --commit")
        rec = merge(args.merge, args.metric, args.commit)
        write(args.out, rec)
        print(json.dumps(rec["bound"]))
        return 0
    if not (args.workload and args.trees and args.seed is not None):
        ap.error("--workload, --trees and --seed are required")
    rec = run_pairs(args.workload, args.trees, args.pairs, args.seed,
                    args.out, args.session)
    print(report(rec["summary"]), flush=True)
    bad = [r for r in rec["runs"] if not counts(r)]
    print(f"{len(rec['runs'])} runs, {len(bad)} not counted", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
