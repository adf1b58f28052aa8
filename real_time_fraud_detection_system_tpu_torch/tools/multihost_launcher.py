"""The port's fleet launcher: spawn, watch and aggregate N serving
processes of the port on this machine, each a real ``score`` worker
(``python -m real_time_fraud_detection_system_tpu_torch.cli score``) with
its own interpreter, its own CUDA context (or CPU), its own registry and
its own residue block of the global shard space. The launcher

- picks a coordinator port and injects ``--coordinator / --num-processes
  / --process-id`` (the workers rendezvous in a gloo process group;
  ``--no-coordinator`` runs an uncoordinated fleet with no group);
- substitutes ``{proc}`` (and, autoscaling, ``{gen}``) in the worker
  args; ``score`` itself puts ``--out`` / ``--checkpoint-dir`` /
  ``--raw-table`` / ``--cold-store`` under ``proc-NN/``;
- watches the fleet: coordinated, a worker's death is a HOST LOSS (the
  group's store lives in process 0), so the fleet is drained and every
  worker relaunched with ``--resume`` (per-process checkpoints and the
  sink's ``truncate_after`` fence keep it exactly-once); uncoordinated,
  only the dead worker respawns;
- optionally serves the aggregated view (``--metrics-port``): every
  worker's ``/metrics.json`` merged with a ``process`` label, as
  Prometheus text, and ``/cluster`` (liveness, restarts) as JSON;
- optionally appends the fleet's events to a flight record;
- with ``--autoscale``, resizes the fleet on sustained pressure or idle:
  drain by SIGTERM, merge through ``--resume-merge``, commit the
  topology, relaunch, and roll back on any fault in the window
  (``runtime/elastic.py``).

Prints ONE JSON line: per-worker stats (from each worker's own stats
line) and fleet totals. Exit 0 iff every worker of the final generation
exited 0.

Usage::

    python -m real_time_fraud_detection_system_tpu_torch.tools.\\
multihost_launcher --processes 2 -- \\
        score --source replay --data txs.npz --model-file m.npz \\
        --precompile --devices 1 --out out --checkpoint-dir ckpt \\
        --metrics-dump dumps/{proc}.json
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional

# the checkout's root (three levels up), so a script run finds the package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from real_time_fraud_detection_system_tpu_torch.utils.metrics import (  # noqa: E402
    FlightRecorder,
    merge_process_snapshots,
    render_snapshot_prometheus,
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _worker_snapshots(ports: Dict[int, int]) -> Dict[str, dict]:
    """Fetch each live worker's ``/metrics.json`` registry snapshot;
    a dead/not-up-yet worker is simply absent."""
    import urllib.request

    out: Dict[str, dict] = {}
    for pid, port in ports.items():
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/metrics.json",
                    timeout=2.0) as r:
                out[str(pid)] = json.loads(r.read().decode())
        except (OSError, ValueError):
            continue
    return out


def _arg_value(worker_args: List[str], flag: str) -> Optional[str]:
    for i, a in enumerate(worker_args):
        if a == flag and i + 1 < len(worker_args):
            return worker_args[i + 1]
        if a.startswith(flag + "="):
            return a.split("=", 1)[1]
    return None


def _gen_sub(tmpl: str, gen: int) -> str:
    return tmpl.replace("{gen}", f"gen-{gen:03d}")


def _last_json_line(path: str) -> Optional[dict]:
    """Last ``{...}`` line of a worker log — its stats line."""
    try:
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            out = None
            for ln in f:
                ln = ln.strip()
                if ln.startswith("{") and ln.endswith("}"):
                    try:
                        out = json.loads(ln)
                    except ValueError:
                        continue
            return out
    except OSError:
        return None


class _Worker:
    """One fleet member: the spawned process + its log + restart count."""

    def __init__(self, pid: int, cmd: List[str], env: dict,
                 log_path: str):
        self.process_id = pid
        self.cmd = cmd
        self.env = env
        self.log_path = log_path
        self.restarts = 0
        self.proc: Optional[subprocess.Popen] = None

    def spawn(self, extra_args: Optional[List[str]] = None) -> None:
        cmd = self.cmd + list(extra_args or [])
        log = open(self.log_path, "ab")
        try:
            self.proc = subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT, env=self.env)
        finally:
            log.close()  # the child holds its own fd

    def poll(self) -> Optional[int]:
        return self.proc.poll() if self.proc is not None else None

    def kill(self) -> None:
        if self.proc is not None and self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()

    def stats(self) -> Optional[dict]:
        return _last_json_line(self.log_path)


class _ClusterMetricsServer:
    """Coordinator-side aggregation view: ``/metrics`` (merged
    Prometheus text), ``/metrics.json`` (merged snapshot), ``/cluster``
    (liveness). Worker registries are scraped on demand from their
    ``--metrics-port`` endpoints; a dead worker simply drops out of the
    merge (its absence IS the signal, mirrored in /cluster)."""

    def __init__(self, port: int, worker_ports: Dict[int, int],
                 cluster_fn, include_launcher: bool = False):
        self.port = port
        self.worker_ports = worker_ports
        self.cluster_fn = cluster_fn
        # autoscale mode: merge the LAUNCHER's own registry (fleet
        # size, resize counters/durations) into the aggregation view
        # as the "launcher" process
        self.include_launcher = include_launcher
        self._httpd = None
        self._thread = None

    def _fetch_snapshots(self) -> Dict[str, dict]:
        out = _worker_snapshots(self.worker_ports)
        if self.include_launcher:
            from real_time_fraud_detection_system_tpu_torch.utils.metrics \
                import get_registry

            out["launcher"] = get_registry().snapshot()
        return out

    def start(self) -> None:
        from http.server import BaseHTTPRequestHandler, HTTPServer

        outer = self

        class Handler(BaseHTTPRequestHandler):
            def _send(self, code, body: bytes, ctype: str) -> None:
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 — stdlib handler API
                if self.path.startswith("/metrics.json"):
                    merged = merge_process_snapshots(
                        outer._fetch_snapshots())
                    self._send(200, json.dumps(merged).encode(),
                               "application/json")
                elif self.path.startswith("/metrics"):
                    merged = merge_process_snapshots(
                        outer._fetch_snapshots())
                    self._send(200,
                               render_snapshot_prometheus(merged).encode(),
                               "text/plain; version=0.0.4")
                elif self.path.startswith("/cluster"):
                    self._send(200, json.dumps(outer.cluster_fn()).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def log_message(self, *a):
                pass  # endpoint scrapes are not log news

        self._httpd = HTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="cluster-metrics",
            daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()


def build_workers(args, worker_args: List[str], coordinator: str,
                  n_processes: Optional[int] = None,
                  gen: Optional[int] = None) -> List[_Worker]:
    """``n_processes``/``gen`` override the fixed fleet shape for the
    autoscale path: ``{gen}`` in worker args substitutes per-generation
    paths (gen-NNN), the same way ``{proc}`` substitutes per-process
    ones, so every topology generation owns disjoint durable roots."""
    n = args.processes if n_processes is None else n_processes
    workers = []
    for pid in range(n):
        sub = [a.replace("{proc}", f"{pid:02d}") for a in worker_args]
        if gen is not None:
            sub = [_gen_sub(a, gen) for a in sub]
        cmd = [sys.executable, "-m",
               "real_time_fraud_detection_system_tpu_torch.cli"] + sub
        cmd += ["--num-processes", str(n),
                "--process-id", str(pid)]
        if coordinator:
            cmd += ["--coordinator", coordinator]
        if args.worker_metrics_base:
            cmd += ["--metrics-port",
                    str(args.worker_metrics_base + pid)]
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        prefix = f"gen-{gen:03d}-" if gen is not None else ""
        log_path = os.path.join(args.workdir,
                                f"{prefix}proc-{pid:02d}.log")
        workers.append(_Worker(pid, cmd, env, log_path))
    return workers


def _run_autoscale(args, worker_args: List[str], recorder) -> int:
    """Elastic fleet: pressure-driven resize loop around the worker set.

    The policy brain and FSM spine live in ``runtime.elastic`` (unit-
    tested without processes); this loop is their I/O shell. Steady
    state polls every worker's registry snapshot, distills the fleet
    signals (worst overload rung, lag trend, shed backlog) and, when a
    dwell completes, walks one resize through the chaos-survivable
    phases:

    - DRAINING: SIGTERM every worker (they run ``--drain-on-sigterm``),
      wait for ALL to exit 0 with a final checkpoint at their exact
      sink frontier. Any non-zero exit / timeout → rollback.
    - RETOPOLOGIZING: assemble the new generation's worker set with
      ``--resume --resume-merge OLD:P:L:REASON`` (the merge itself runs
      worker-side, idempotently, into each new worker's own lineage).
    - COMMITTING: atomically replace the topology manifest
      (tmp+fsync+rename+read-back); a torn manifest → rollback.
    - RELAUNCHING: spawn the new fleet; → STEADY.

    Rollback (any fault in the window) relaunches the PRE-resize fleet
    with ``--resume``: drained workers continue from their final
    checkpoints, a SIGKILLed worker replays from its last cadence
    checkpoint behind its sink ``truncate_after`` fence — exactly-once
    either way, counted in
    ``rtfds_fleet_resizes_total{outcome=rolled_back}``.
    """
    from real_time_fraud_detection_system_tpu_torch.runtime.elastic import (
        COMMITTING,
        DRAINING,
        RELAUNCHING,
        RETOPOLOGIZING,
        STEADY,
        ElasticConfig,
        ElasticPolicy,
        ResizeFsm,
        fleet_metrics,
        load_topology,
        signals_from_snapshots,
        store_topology,
    )

    ckpt_tmpl = _arg_value(worker_args, "--checkpoint-dir")
    if not ckpt_tmpl or "{gen}" not in ckpt_tmpl:
        print("# --autoscale needs --checkpoint-dir containing {gen} "
              "in the worker args (per-generation lineage roots)",
              file=sys.stderr, flush=True)
        return 2
    out_tmpl = _arg_value(worker_args, "--out")
    if out_tmpl and "{gen}" not in out_tmpl:
        print("# --autoscale needs {gen} in --out (per-generation sink "
              "parts keep batch_index lineages disjoint)",
              file=sys.stderr, flush=True)
        return 2
    cold_tmpl = _arg_value(worker_args, "--cold-store")
    if "--drain-on-sigterm" not in worker_args:
        worker_args = worker_args + ["--drain-on-sigterm"]

    policy = ElasticPolicy(ElasticConfig(
        min_processes=args.autoscale_min,
        max_processes=args.autoscale_max,
        grow_rung=args.autoscale_grow_rung,
        grow_dwell_s=args.autoscale_grow_dwell,
        shrink_dwell_s=args.autoscale_shrink_dwell,
        cooldown_s=args.autoscale_cooldown))
    fm = fleet_metrics()
    auto: dict = {"current": args.processes, "target": None,
                  "generation": 0, "completed": 0, "rolled_back": 0,
                  "last_resize": None, "spike_absorb_s": None}

    def _journal(rec: dict) -> None:
        if recorder is not None:
            recorder.record_event("resize_phase", **rec)

    fsm = ResizeFsm(journal=_journal)
    topo_path = os.path.join(args.workdir, "topology.json")
    cur_p = args.processes
    gen = 0
    chaos = args.chaos_resize or None
    resize_attempts = 0
    topo_man = {"generation": 0, "processes": cur_p,
                "local_devices": args.local_devices,
                "checkpoint_root": _gen_sub(ckpt_tmpl, 0),
                "reason": "bootstrap"}
    store_topology(topo_path, topo_man)
    fm.fleet_size.set(cur_p)
    fm.resize_pending.set(0)

    workers = build_workers(args, worker_args, "", n_processes=cur_p,
                            gen=gen)
    ports = {w.process_id: args.worker_metrics_base + w.process_id
             for w in workers}
    retired: List[_Worker] = []  # every pre-resize generation's workers

    def cluster_state() -> dict:
        return {
            "processes": cur_p,
            "coordinated": False,
            "fleet_restarts": 0,
            "autoscale": {
                **auto, "phase": fsm.phase,
                "min": policy.cfg.min_processes,
                "max": policy.cfg.max_processes,
            },
            "workers": [
                {"process": w.process_id, "alive": w.poll() is None,
                 "restarts": w.restarts, "rc": w.poll()}
                for w in workers
            ],
        }

    server = None
    if args.metrics_port:
        server = _ClusterMetricsServer(args.metrics_port, ports,
                                       cluster_state,
                                       include_launcher=True)
        server.start()
        print(f"# cluster metrics on :{server.port} "
              "(/metrics /metrics.json /cluster + autoscale)",
              file=sys.stderr, flush=True)

    resume_args = ["--resume"] if "--resume" not in worker_args else []

    def relaunch(n: int, g: int, extra: List[str]) -> None:
        nonlocal workers
        retired.extend(workers)
        workers = build_workers(args, worker_args, "", n_processes=n,
                                gen=g)
        ports.clear()
        ports.update({w.process_id: args.worker_metrics_base
                      + w.process_id for w in workers})
        for w in workers:
            w.spawn(extra)

    def do_resize(dec) -> None:
        nonlocal cur_p, gen, chaos, topo_man
        t_r = time.monotonic()
        auto["target"] = dec.target
        fm.resize_pending.set(1)
        if recorder is not None:
            recorder.record_event("resize_begin", direction=dec.direction,
                                  current=cur_p, target=dec.target,
                                  reason=dec.reason)
        print(f"# resize {dec.direction} {cur_p} -> {dec.target}: "
              f"{dec.reason}", file=sys.stderr, flush=True)
        fsm.to(DRAINING, direction=dec.direction, target=dec.target)

        def fail(stage: str, why: str) -> None:
            fsm.rollback(stage=stage, why=why)
            if recorder is not None:
                recorder.record_event("resize_rollback", stage=stage,
                                      why=why, direction=dec.direction)
            for w in workers:
                w.kill()
            try:
                # the torn-manifest fault quarantined the committed
                # topology; restore the pre-resize manifest so readers
                # keep seeing the fleet that is actually serving
                store_topology(topo_path, topo_man)
            except (OSError, ValueError):
                pass
            relaunch(cur_p, gen, resume_args)
            fm.resizes_total(dec.direction, "rolled_back").inc()
            fm.resize_pending.set(0)
            fm.resize_seconds.observe(time.monotonic() - t_r)
            auto["rolled_back"] += 1
            auto["target"] = None
            auto["last_resize"] = {
                "direction": dec.direction, "outcome": "rolled_back",
                "stage": stage, "why": why, "epoch": time.time()}
            fsm.to(STEADY, outcome="rolled_back", stage=stage)
            print(f"# resize rolled back at {stage}: {why} — "
                  f"pre-resize fleet of {cur_p} relaunched",
                  file=sys.stderr, flush=True)

        # -- DRAINING: coordinated drain to final checkpoints ----------
        if chaos == "kill-mid-drain":
            chaos = None
            victim = workers[-1]
            if victim.proc is not None and victim.proc.poll() is None:
                victim.proc.kill()  # SIGKILL: no final checkpoint lands
        for w in workers:
            if w.proc is not None and w.proc.poll() is None:
                w.proc.send_signal(signal.SIGTERM)
        deadline = time.monotonic() + args.drain_timeout
        while (time.monotonic() < deadline
               and any(w.poll() is None for w in workers)):
            time.sleep(0.1)
        rcs = {w.process_id: w.poll() for w in workers}
        if any(r is None or r != 0 for r in rcs.values()):
            fail("drain", f"worker exits {rcs} (want all 0: a final "
                 "checkpoint at the sink frontier)")
            return

        # -- RETOPOLOGIZING: new generation's worker set ---------------
        fsm.to(RETOPOLOGIZING, target=dec.target)
        old_ckpt = _gen_sub(ckpt_tmpl, gen)
        new_gen = gen + 1
        extra = list(resume_args) + [
            "--resume-merge",
            f"{old_ckpt}:{cur_p}:{args.local_devices}:{dec.reason}"]
        if cold_tmpl:
            old_cold = _gen_sub(cold_tmpl, gen)
            srcs = ([old_cold] if cur_p == 1 else
                    [os.path.join(old_cold, f"proc-{p:02d}")
                     for p in range(cur_p)])
            srcs = [s for s in srcs if os.path.isdir(s)]
            if srcs:
                extra += ["--resume-merge-cold", ",".join(srcs)]
        if chaos == "crash-pre-relaunch":
            chaos = None
            fail("retopologize", "injected crash between the final "
                 "checkpoints and the new fleet's launch")
            return

        # -- COMMITTING: atomically replace the topology manifest ------
        fsm.to(COMMITTING, generation=new_gen)
        new_man = {"generation": new_gen, "processes": dec.target,
                   "local_devices": args.local_devices,
                   "checkpoint_root": _gen_sub(ckpt_tmpl, new_gen),
                   "merged_from": old_ckpt, "direction": dec.direction,
                   "reason": dec.reason, "epoch": time.time()}
        committed = None
        if chaos == "torn-manifest":
            chaos = None
            with open(topo_path, "wb") as f:
                # a torn write: half a JSON object, no rename discipline
                f.write(json.dumps(new_man)[:17].encode())
            committed = load_topology(topo_path)  # quarantines the tear
        else:
            try:
                store_topology(topo_path, new_man)
                committed = new_man
            except (OSError, ValueError) as e:
                print(f"# topology commit failed: {e}", file=sys.stderr,
                      flush=True)
        if committed != new_man:
            fail("commit", "topology manifest failed read-back "
                 "(torn write)")
            return

        # -- RELAUNCHING: the new fleet adopts the merged lineage ------
        fsm.to(RELAUNCHING, generation=new_gen, processes=dec.target)
        from_p = cur_p
        relaunch(dec.target, new_gen, extra)
        gen, cur_p, topo_man = new_gen, dec.target, new_man
        fm.fleet_size.set(cur_p)
        fm.resizes_total(dec.direction, "completed").inc()
        fm.resize_pending.set(0)
        dt = time.monotonic() - t_r
        fm.resize_seconds.observe(dt)
        auto.update(current=cur_p, target=None, generation=gen)
        auto["completed"] += 1
        auto["last_resize"] = {
            "direction": dec.direction, "outcome": "completed",
            "from": from_p, "to": cur_p, "reason": dec.reason,
            "seconds": round(dt, 3), "epoch": time.time()}
        if recorder is not None:
            recorder.record_event("resize_complete",
                                  direction=dec.direction, processes=cur_p,
                                  generation=gen, seconds=round(dt, 3))
        fsm.to(STEADY, outcome="completed", generation=gen)
        print(f"# resize complete: {from_p} -> {cur_p} in {dt:.1f}s "
              f"(generation {gen})", file=sys.stderr, flush=True)

    for w in workers:
        w.spawn()
        if recorder is not None:
            recorder.record_event("cluster_worker_start",
                                  process=w.process_id, generation=gen)
    t0 = time.monotonic()
    rc = 0
    absorb_t0 = None
    try:
        while True:
            states = {w.process_id: w.poll() for w in workers}
            if all(s is not None for s in states.values()):
                rc = 0 if all(s == 0 for s in states.values()) else 1
                break
            if args.timeout and time.monotonic() - t0 > args.timeout:
                print("# fleet timeout — killing workers",
                      file=sys.stderr, flush=True)
                for w in workers:
                    w.kill()
                rc = 1
                break
            dead_bad = [w for w in workers
                        if states[w.process_id] not in (None, 0)]
            if dead_bad:
                # steady-state worker death (outside any resize window):
                # uncoordinated fleets respawn just the dead worker on
                # its own lineage
                stop = False
                for w in dead_bad:
                    if w.restarts >= args.max_worker_restarts:
                        for v in workers:
                            v.kill()
                        rc = 1
                        stop = True
                        break
                    w.restarts += 1
                    if recorder is not None:
                        recorder.record_event("cluster_worker_restart",
                                              process=w.process_id,
                                              attempt=w.restarts,
                                              generation=gen)
                    w.spawn(resume_args)
                if stop:
                    break
                time.sleep(args.autoscale_interval)
                continue
            sig = signals_from_snapshots(_worker_snapshots(ports))
            now = time.monotonic()
            if absorb_t0 is None and sig.worst_rung >= \
                    policy.cfg.grow_rung:
                absorb_t0 = now
            elif absorb_t0 is not None and sig.worst_rung <= 1:
                # spike absorbed: pressure first crossed the grow rung
                # absorb_t0 ago, and the (possibly resized) fleet is
                # back under control
                fm.spike_absorb.set(now - absorb_t0)
                auto["spike_absorb_s"] = round(now - absorb_t0, 3)
                absorb_t0 = None
            dec = policy.observe(sig, cur_p, now)
            if dec is not None and (args.max_resizes <= 0
                                    or resize_attempts < args.max_resizes):
                resize_attempts += 1
                do_resize(dec)
                policy.note_resized(time.monotonic())
            time.sleep(args.autoscale_interval)
    finally:
        for w in workers:
            w.kill()
        if server is not None:
            server.stop()
        try:
            # the fleet counters (resizes by outcome, fleet size, spike
            # absorb) live in THIS process's registry — persist them so
            # the smoke/bench can assert from artifacts, not stdout
            from real_time_fraud_detection_system_tpu_torch.utils.metrics \
                import get_registry

            with open(os.path.join(args.workdir,
                                   "launcher-metrics.json"), "w",
                      encoding="utf-8") as f:
                json.dump(get_registry().snapshot(), f)
        except (OSError, ValueError):
            pass

    # dedupe by log path (a respawned worker reuses its log; the last
    # stats line is the authoritative one for that lineage)
    by_log: Dict[str, _Worker] = {}
    for w in retired + workers:
        by_log[w.log_path] = w
    worker_rows = []
    rows_total = 0
    for path in sorted(by_log):
        w = by_log[path]
        st = w.stats() or {}
        rows = int(st.get("rows", 0) or 0)
        rows_total += rows
        worker_rows.append({
            "process": w.process_id,
            "rc": w.poll(),
            "restarts": w.restarts,
            "rows": rows,
            "rows_per_s": round(float(st.get("rows_per_s", 0.0)
                                      or 0.0), 1),
            "batches": int(st.get("batches", 0) or 0),
            "log": w.log_path,
        })
    if recorder is not None:
        recorder.close()
    print(json.dumps({
        "processes": cur_p,
        "coordinated": False,
        "serialized": False,
        "fleet_restarts": 0,
        "autoscale": {**auto, "phase": fsm.phase,
                      "attempts": resize_attempts,
                      "generations": gen + 1},
        "rows_total": rows_total,
        "workers": worker_rows,
    }), flush=True)
    return rc


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--processes", type=int, required=True,
                    help="fleet size (one score process each)")
    ap.add_argument("--local-devices", type=int, default=1,
                    help="shards per worker, recorded in the topology "
                         "manifest and the resize merges; pass the "
                         "matching --devices in the score args")
    ap.add_argument("--no-coordinator", action="store_true",
                    help="uncoordinated fleet: no process group "
                         "(no spanning mesh possible; per-worker "
                         "restart becomes safe)")
    ap.add_argument("--coordinator-port", type=int, default=0,
                    help="port for process 0's coordination service "
                         "(0 = pick a free one)")
    ap.add_argument("--workdir", default=".multihost",
                    help="per-worker logs land here (proc-NN.log)")
    ap.add_argument("--max-fleet-restarts", type=int, default=0,
                    help="coordinated mode: a worker death is a host "
                         "loss — drain the fleet and relaunch ALL "
                         "workers with --resume, at most this many "
                         "times")
    ap.add_argument("--max-worker-restarts", type=int, default=0,
                    help="uncoordinated mode: respawn just the dead "
                         "worker with --resume, at most this many "
                         "times per worker")
    ap.add_argument("--worker-metrics-base", type=int, default=0,
                    help="give worker i --metrics-port base+i "
                         "(0 = workers serve no ports)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve the coordinator-side aggregation view "
                         "(/metrics, /metrics.json, /cluster) on this "
                         "port; needs --worker-metrics-base")
    ap.add_argument("--flight-record", default="",
                    help="append cluster events (worker exits, fleet "
                         "restarts) to this JSONL — the dashboard's "
                         "Cluster tile reads it")
    ap.add_argument("--serialize", action="store_true",
                    help="run the workers ONE AT A TIME instead of "
                         "concurrently (requires --no-coordinator: a "
                         "barrier would deadlock staggered workers). "
                         "Residue blocks are disjoint, so the fleet's "
                         "output is identical; each worker gets the "
                         "host to itself — the bench uses this to "
                         "measure per-process rates as a pod (one "
                         "host per process) would deliver them, "
                         "uncontended by the shared-core CI box")
    ap.add_argument("--timeout", type=float, default=0.0,
                    help="kill the fleet after this many seconds "
                         "(0 = wait forever)")
    ap.add_argument("--autoscale", action="store_true",
                    help="elastic fleet: watch the aggregated worker "
                         "signals (worst overload rung, lag trend, shed "
                         "backlog) and resize the fleet under sustained "
                         "pressure/idle via coordinated drain -> "
                         "checkpoint merge -> relaunch, exactly-once "
                         "across every resize. Requires "
                         "--no-coordinator, --worker-metrics-base, and "
                         "{gen} in the worker --checkpoint-dir/--out "
                         "(the elastic fleet)")
    ap.add_argument("--autoscale-min", type=int, default=1,
                    help="never shrink below this many processes")
    ap.add_argument("--autoscale-max", type=int, default=4,
                    help="never grow beyond this many processes")
    ap.add_argument("--autoscale-grow-rung", type=int, default=2,
                    help="grow once the worst process holds this "
                         "overload rung for --autoscale-grow-dwell")
    ap.add_argument("--autoscale-grow-dwell", type=float, default=2.0,
                    help="seconds the grow condition must hold")
    ap.add_argument("--autoscale-shrink-dwell", type=float, default=10.0,
                    help="seconds of full fleet idle (rung 0, flat lag, "
                         "no shed backlog) before shrinking")
    ap.add_argument("--autoscale-cooldown", type=float, default=5.0,
                    help="seconds after any resize (completed or rolled "
                         "back) before either direction re-arms")
    ap.add_argument("--autoscale-interval", type=float, default=0.25,
                    help="seconds between fleet signal polls")
    ap.add_argument("--drain-timeout", type=float, default=90.0,
                    help="seconds to wait for every worker's "
                         "coordinated drain before rolling back")
    ap.add_argument("--max-resizes", type=int, default=0,
                    help="bound on resize ATTEMPTS, completed or rolled "
                         "back (0 = policy-limited only)")
    ap.add_argument("--chaos-resize", default="",
                    choices=["", "kill-mid-drain", "crash-pre-relaunch",
                             "torn-manifest"],
                    help="inject ONE fault into the first resize "
                         "window (the chaos smoke asserts it lands in "
                         "rtfds_fleet_resizes_total{outcome="
                         "rolled_back} with the pre-resize fleet "
                         "serving)")
    ap.add_argument("worker_args", nargs=argparse.REMAINDER,
                    help="-- score <args>  ({proc} substitutes the "
                         "2-digit process id)")
    args = ap.parse_args()

    worker_args = args.worker_args
    if worker_args and worker_args[0] == "--":
        worker_args = worker_args[1:]
    if not worker_args or worker_args[0] != "score":
        ap.error("worker args must start with the 'score' subcommand "
                 "(usage: ... -- score --source replay ...)")
    if args.processes < 1:
        ap.error("--processes must be >= 1")
    if args.metrics_port and not args.worker_metrics_base:
        ap.error("--metrics-port needs --worker-metrics-base (the "
                 "aggregator scrapes the workers' own endpoints)")
    if args.serialize and not args.no_coordinator:
        ap.error("--serialize requires --no-coordinator (the "
                 "process group's rendezvous would deadlock workers that "
                 "are not all running)")
    if args.autoscale:
        if not args.no_coordinator:
            ap.error("--autoscale requires --no-coordinator (a resize "
                     "changes the process count; a spanning "
                     "process group cannot survive that)")
        if not args.worker_metrics_base:
            ap.error("--autoscale needs --worker-metrics-base (the "
                     "policy reads each worker's registry snapshot)")
        if args.serialize:
            ap.error("--autoscale does not compose with --serialize "
                     "(pressure signals need the fleet running "
                     "concurrently)")

    os.makedirs(args.workdir, exist_ok=True)
    coordinator = ""
    if not args.no_coordinator:
        port = args.coordinator_port or _free_port()
        coordinator = f"127.0.0.1:{port}"

    recorder = None
    if args.flight_record:
        recorder = FlightRecorder(args.flight_record, manifest={
            "multihost": {"processes": args.processes,
                          "coordinated": bool(coordinator),
                          "autoscale": bool(args.autoscale)}})

    if args.autoscale:
        return _run_autoscale(args, worker_args, recorder)

    workers = build_workers(args, worker_args, coordinator)
    fleet_restarts = 0
    results: Dict[int, int] = {}

    def cluster_state() -> dict:
        return {
            "processes": args.processes,
            "coordinated": bool(coordinator),
            "fleet_restarts": fleet_restarts,
            "workers": [
                {"process": w.process_id,
                 "alive": w.poll() is None,
                 "restarts": w.restarts,
                 "rc": w.poll()}
                for w in workers
            ],
        }

    server = None
    if args.metrics_port:
        server = _ClusterMetricsServer(
            args.metrics_port,
            {w.process_id: args.worker_metrics_base + w.process_id
             for w in workers},
            cluster_state)
        server.start()
        print(f"# cluster metrics on :{server.port} "
              "(/metrics /metrics.json /cluster)", file=sys.stderr,
              flush=True)

    has_ckpt = "--checkpoint-dir" in worker_args
    resume_args = (["--resume"]
                   if has_ckpt and "--resume" not in worker_args else [])

    t0 = time.monotonic()
    rc = 0
    if args.serialize:
        # One worker at a time (disjoint residue blocks: the fleet's
        # output is identical to the concurrent run's) — each gets the
        # host alone, so its stats measure per-process capacity, not
        # shared-core time-slicing. Per-worker restart budget applies.
        try:
            for w in workers:
                while True:
                    w.spawn(resume_args if w.restarts else None)
                    if recorder is not None:
                        recorder.record_event("cluster_worker_start",
                                              process=w.process_id,
                                              attempt=w.restarts)
                    while w.poll() is None:
                        if args.timeout and \
                                time.monotonic() - t0 > args.timeout:
                            w.kill()
                            break
                        time.sleep(0.1)
                    if w.poll() == 0 or \
                            w.restarts >= args.max_worker_restarts:
                        break
                    w.restarts += 1
                results[w.process_id] = w.poll()
                if results[w.process_id] != 0:
                    rc = 1
        finally:
            for w in workers:
                w.kill()
            if server is not None:
                server.stop()
        return _report(args, workers, results, fleet_restarts,
                       coordinator, recorder, rc)

    for w in workers:
        w.spawn()
        if recorder is not None:
            recorder.record_event("cluster_worker_start",
                                  process=w.process_id)
    try:
        while True:
            states = {w.process_id: w.poll() for w in workers}
            if all(s is not None for s in states.values()):
                results = states
                break
            if args.timeout and time.monotonic() - t0 > args.timeout:
                print("# fleet timeout — killing workers",
                      file=sys.stderr, flush=True)
                for w in workers:
                    w.kill()
                results = {w.process_id: (w.poll() if w.poll() is not None
                                          else -9) for w in workers}
                rc = 1
                break
            dead_bad = [w for w in workers
                        if states[w.process_id] not in (None, 0)]
            if dead_bad and coordinator:
                # Host loss, pod semantics: the coordination service
                # (process 0) or a heartbeat-fenced peer is gone — the
                # fleet cannot continue half-alive. Drain and relaunch
                # everyone with --resume: each worker's own
                # checkpoint + sink truncate_after fencing (the
                # supervisor plane) makes the restart exactly-once per
                # residue block.
                if fleet_restarts >= args.max_fleet_restarts:
                    for w in workers:
                        w.kill()
                    # a worker that finished rc 0 before the fatal peer
                    # death keeps its honest exit code in the report
                    results = {w.process_id: (w.poll()
                                              if w.poll() is not None
                                              else 1)
                               for w in workers}
                    rc = 1
                    break
                fleet_restarts += 1
                for w in workers:
                    w.kill()
                if recorder is not None:
                    recorder.record_event(
                        "fleet_restart", generation=fleet_restarts,
                        died=[w.process_id for w in dead_bad])
                port = _free_port()
                coordinator = f"127.0.0.1:{port}"
                workers = build_workers(args, worker_args, coordinator)
                for w in workers:
                    w.restarts = fleet_restarts
                    w.spawn(resume_args)
                time.sleep(0.5)
                continue
            if dead_bad:
                # Uncoordinated fleet: a dead worker affects only its
                # own residue block — respawn just it, resuming its own
                # checkpoint lineage.
                for w in dead_bad:
                    if w.restarts >= args.max_worker_restarts:
                        for v in workers:
                            v.kill()
                        results = {v.process_id: v.poll()
                                   if v.poll() is not None else 1
                                   for v in workers}
                        rc = 1
                        break
                    w.restarts += 1
                    if recorder is not None:
                        recorder.record_event(
                            "cluster_worker_restart",
                            process=w.process_id, attempt=w.restarts)
                    w.spawn(resume_args)
                else:
                    time.sleep(0.2)
                    continue
                break
            time.sleep(0.2)
    finally:
        for w in workers:
            w.kill()
        if server is not None:
            server.stop()

    return _report(args, workers, results, fleet_restarts, coordinator,
                   recorder, rc)


def _report(args, workers, results, fleet_restarts, coordinator,
            recorder, rc) -> int:
    worker_rows = []
    rows_total = 0
    for w in workers:
        st = w.stats() or {}
        rows = int(st.get("rows", 0) or 0)
        rows_total += rows
        row = {
            "process": w.process_id,
            "rc": results.get(w.process_id, w.poll()),
            "restarts": w.restarts,
            "rows": rows,
            "rows_per_s": round(float(st.get("rows_per_s", 0.0) or 0.0),
                                1),
            "cpu_s": round(float(st.get("cpu_s", 0.0) or 0.0), 3),
            "batches": int(st.get("batches", 0) or 0),
            "log": w.log_path,
        }
        worker_rows.append(row)
        if recorder is not None:
            recorder.record_event(
                "cluster_worker", process=w.process_id, rc=row["rc"],
                rows=rows, rows_per_s=row["rows_per_s"],
                restarts=w.restarts)
        if row["rc"] != 0:
            rc = rc or 1
    if recorder is not None:
        recorder.close()
    print(json.dumps({
        "processes": args.processes,
        "coordinated": bool(coordinator),
        "serialized": bool(args.serialize),
        "fleet_restarts": fleet_restarts,
        "rows_total": rows_total,
        "workers": worker_rows,
    }), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
