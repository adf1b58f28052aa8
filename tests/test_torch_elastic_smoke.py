"""The port's elastic fleet end to end on the CPU: the port's launcher
with ``--autoscale`` watches real port workers' registries (the worst
overload rung, the lag trend, the shed backlog) and walks real resizes —
a drain by SIGTERM to final checkpoints, the worker-side merge
(``--resume-merge``), the topology commit, the relaunch — as the JAX
package's ``tests/test_elastic_smoke.py`` drives its fleet:

- GROW 1 → 2 under a spike (replay lag far past the ladder's high-water
  mark) completes mid-stream and covers the stream exactly once, each
  (generation, process) sink lineage without gaps or duplicates, the
  merged checkpoint's resize epoch recorded;
- SHRINK 2 → 1 on sustained idle merges both processes' states and still
  covers the stream exactly, the old cursors' per-owner floors dropping
  the rows the faster process already sank;
- a SIGKILLed worker mid-drain lands the resize in ``rolled_back`` with
  the pre-resize fleet serving to exact completion (the other two faults
  are slow, as in the JAX package).

The three drives run side by side from one fixture, each worker on one
thread.
"""

import glob
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    make_checkpointer,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder,
)
from test_torch_fleet_smoke import (  # pytest adds tests/
    LAUNCHER,
    make_dataset,
    make_model,
    part_indexes,
    read_parts,
    spawn_env,
)

N_ROWS = 60000
BATCH = 128
OVERLOAD = ["--overload", "--overload-lag-high", "512",
            "--overload-climb-dwell", "1"]
GROW = ["--autoscale-grow-rung", "2", "--autoscale-grow-dwell", "1.0",
        "--autoscale-shrink-dwell", "300", "--autoscale-cooldown", "3"]


def _port_base() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(root, name: str, *, processes: int, launcher_extra: list,
           score_extra: list) -> tuple:
    cell = root / name
    (cell / "dumps").mkdir(parents=True)
    cmd = [sys.executable, "-m", LAUNCHER,
           "--processes", str(processes), "--no-coordinator",
           "--autoscale", "--autoscale-min", "1", "--autoscale-max", "2",
           "--autoscale-interval", "0.2", "--max-resizes", "1",
           "--worker-metrics-base", str(_port_base()),
           "--workdir", str(cell / "wd"), "--timeout", "150",
           "--flight-record", str(cell / "cluster.jsonl"),
           *launcher_extra, "--",
           "score", "--device", "cpu", "--source", "replay",
           "--data", str(root / "txs.npz"),
           "--model-file", str(root / "model.npz"), "--precompile",
           "--devices", "1", "--batch-rows", str(BATCH),
           "--max-batch-rows", str(BATCH),
           "--out", str(cell / "out" / "{gen}"),
           "--checkpoint-dir", str(cell / "ckpt" / "{gen}"),
           "--cms-exchange", str(cell / "xch" / "{gen}"),
           "--metrics-dump", str(cell / "dumps" / "{gen}-{proc}.json"),
           *score_extra]
    return cell, subprocess.Popen(cmd, env=spawn_env(),
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)


def _finish(cell, proc) -> dict:
    out, err = proc.communicate(timeout=180)
    lines = [ln for ln in out.splitlines() if ln.startswith("{")]
    assert proc.returncode == 0 and lines, (
        f"{cell.name} rc={proc.returncode}\n{out[-2000:]}\n{err[-3000:]}")
    return {"cell": cell, "report": json.loads(lines[-1]),
            "launcher_metrics": json.loads(
                (cell / "wd" / "launcher-metrics.json").read_text()),
            "topology": json.loads(
                (cell / "wd" / "topology.json").read_text())}


def _spiky(root, name):
    return _start(root, name, processes=1, launcher_extra=GROW + (
        ["--chaos-resize", name] if name != "grow" else []),
        score_extra=OVERLOAD + ["--overload-spill",
                                str(root / name / "spill" / "{gen}-{proc}")])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_elastic")
    make_dataset(str(root / "txs.npz"), N_ROWS, seed=11)
    make_model(str(root / "model.npz"))
    started = {
        "grow": _spiky(root, "grow"),
        "shrink": _start(root, "shrink", processes=2, launcher_extra=[
            "--autoscale-grow-dwell", "300",
            "--autoscale-shrink-dwell", "1.5", "--autoscale-cooldown", "2"],
            score_extra=[]),
        "chaos": _spiky(root, "kill-mid-drain"),
    }
    return {k: _finish(*v) for k, v in started.items()}


def _series_total(snap: dict, name: str, **labels) -> float:
    return sum(float(r.get("value") or 0.0)
               for r in (snap.get(name) or {}).get("series", [])
               if all((r.get("labels") or {}).get(k) == v
                      for k, v in labels.items()))


def _assert_exactly_once(cell) -> None:
    ids = read_parts(str(cell / "out" / "**" / "part-*.parquet"))["tx_id"]
    assert len(ids) == N_ROWS, f"scored {len(ids)} rows of {N_ROWS}"
    assert np.array_equal(np.sort(ids), np.arange(N_ROWS))
    dirs = {os.path.dirname(p) for p in glob.glob(
        str(cell / "out" / "**" / "part-*.parquet"), recursive=True)}
    for d in sorted(dirs):
        idx = part_indexes(d)
        assert idx == list(range(1, len(idx) + 1)), (d, idx)


def _resize_epochs(cell, gen: int) -> list:
    """The resize epochs of the new generation's first checkpoint (the
    merged one)."""
    d = cell / "ckpt" / f"gen-{gen:03d}" / "proc-00"
    d = d if d.is_dir() else d.parent
    ck = make_checkpointer(str(d))
    first = ck.list_checkpoints()[0]
    return ck.manifest(first)["meta"]["resize_epochs"]


def test_grow_resize_completes_exactly_once(runs):
    run = runs["grow"]
    auto = run["report"]["autoscale"]
    assert auto["completed"] == 1 and auto["rolled_back"] == 0
    assert auto["current"] == 2 and auto["generations"] == 2
    assert auto["last_resize"]["direction"] == "grow"
    assert run["report"]["rows_total"] == N_ROWS
    # the new generation served rows: the resize landed mid-stream
    assert sum(w["rows"] for w in run["report"]["workers"]
               if "gen-001" in w["log"]) > 0
    _assert_exactly_once(run["cell"])
    epochs = _resize_epochs(run["cell"], 1)
    assert epochs[-1]["from_processes"] == 1
    assert epochs[-1]["to_processes"] == 2 and len(epochs[-1]["floors"]) == 1
    lm = run["launcher_metrics"]
    assert _series_total(lm, "rtfds_fleet_resizes_total",
                         direction="grow", outcome="completed") == 1
    assert _series_total(lm, "rtfds_fleet_size") == 2
    absorb = auto["spike_absorb_s"]
    assert absorb is not None and 0 < absorb < 150
    dumps = sorted(glob.glob(str(run["cell"] / "dumps" / "*.json")))
    assert len(dumps) == 3  # gen-000 ×1 + gen-001 ×2
    for path in dumps:
        with open(path, encoding="utf-8") as f:
            snap = json.load(f)
        assert _series_total(snap, "cuda_graph_recaptures_total") == 0


def test_grow_journals_every_phase(runs):
    manifest, records = FlightRecorder.read(str(runs["grow"]["cell"] /
                                                "cluster.jsonl"))
    assert manifest["multihost"]["autoscale"] is True
    events = {r.get("event") for r in records}
    assert {"resize_begin", "resize_phase", "resize_complete"} <= events
    phases = [r.get("phase") for r in records
              if r.get("event") == "resize_phase"]
    assert phases == ["draining", "retopologizing", "committing",
                      "relaunching", "steady"]


def test_shrink_merges_exactly_once_with_floors(runs):
    run = runs["shrink"]
    auto = run["report"]["autoscale"]
    assert auto["completed"] == 1 and auto["rolled_back"] == 0
    assert auto["current"] == 1
    assert auto["last_resize"]["direction"] == "shrink"
    assert run["report"]["rows_total"] == N_ROWS
    _assert_exactly_once(run["cell"])
    assert run["topology"]["processes"] == 1
    assert run["topology"]["generation"] == 1
    assert run["topology"]["direction"] == "shrink"
    rec = _resize_epochs(run["cell"], 1)[-1]
    assert (rec["from_processes"], rec["to_processes"]) == (2, 1)
    assert len(rec["floors"]) == 2 and rec["min_offset"] == min(rec["floors"])
    with open(run["cell"] / "dumps" / "gen-001-00.json",
              encoding="utf-8") as f:
        merged = json.load(f)
    skipped = _series_total(merged, "rtfds_resume_floor_skipped_rows_total")
    # the two old cursors stop where the drain finds them: where they
    # differ, the rows between them that the faster one sank are dropped
    assert (skipped > 0) == (len(set(rec["floors"])) > 1)
    assert _series_total(run["launcher_metrics"], "rtfds_fleet_resizes_total",
                         direction="shrink", outcome="completed") == 1


def test_chaos_kill_mid_drain_rolls_back_exactly_once(runs):
    run = runs["chaos"]
    auto = run["report"]["autoscale"]
    assert auto["rolled_back"] == 1 and auto["completed"] == 0
    assert auto["current"] == 1 and auto["generations"] == 1
    assert auto["last_resize"]["stage"] == "drain"
    assert run["report"]["rows_total"] >= N_ROWS
    _assert_exactly_once(run["cell"])
    assert run["topology"]["processes"] == 1
    assert run["topology"]["generation"] == 0
    _, records = FlightRecorder.read(str(run["cell"] / "cluster.jsonl"))
    rb = [r for r in records if r.get("event") == "resize_rollback"]
    assert len(rb) == 1 and rb[0]["stage"] == "drain"


@pytest.mark.slow
@pytest.mark.parametrize("mode,stage", [
    ("crash-pre-relaunch", "retopologize"),
    ("torn-manifest", "commit"),
])
def test_chaos_other_faults_roll_back(tmp_path, mode, stage):
    make_dataset(str(tmp_path / "txs.npz"), N_ROWS, seed=11)
    make_model(str(tmp_path / "model.npz"))
    run = _finish(*_spiky(tmp_path, mode))
    auto = run["report"]["autoscale"]
    assert auto["rolled_back"] == 1 and auto["completed"] == 0
    assert auto["last_resize"]["stage"] == stage
    _assert_exactly_once(run["cell"])
    assert run["topology"]["generation"] == 0
    if mode == "torn-manifest":
        assert glob.glob(str(run["cell"] / "wd" / "topology.json.torn-*"))
