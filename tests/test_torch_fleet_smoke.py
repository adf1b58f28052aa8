"""The port's fleet end to end on the CPU: the port's launcher
(``real_time_fraud_detection_system_tpu_torch/tools/multihost_launcher.py``)
spawns two real ``score`` workers of the port, coordinated over a gloo
process group, each serving its residue block of a co-partitioned stream
with ``--precompile``, ``--checkpoint-dir``, ``--drain-on-sigterm`` (a
final checkpoint at the stream's end), ``--metrics-dump`` and
``--cms-exchange``; beside them the port's single-process 2-shard engine
serves the same stream (the JAX package's ``tests/test_multihost_smoke.py``
for the port). Asserted from what the workers wrote (the report line,
registry dumps, Parquet parts, the flight record):

- the fleet covers the stream exactly (no row lost or scored twice);
- each process's sink ``batch_index`` lineage has no gap or duplicate;
- per-shard series carry global shard ids and ``process`` labels;
- probabilities and all 15 feature columns are bit-identical to the
  single-process control (whole-dollar amounts: float32 sums exact in
  any order).
"""

import glob
import json
import os
import re
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    make_checkpointer,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel,
    save_model,
    save_transactions,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    init_logreg,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_ROWS = 3072
N_PROCS = 2
BATCH_ROWS = 256
LAUNCHER = "real_time_fraud_detection_system_tpu_torch.tools.multihost_launcher"


def spawn_env() -> dict:
    """Workers on the CPU, one thread each (two interpreters share the
    host's cores), the checkout importable."""
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def make_dataset(path: str, n: int, seed: int = 3) -> None:
    """Co-partitioned whole-dollar stream: terminal residues track
    customer residues mod 2, so every key's history stays in one
    process block, and day-bucket sums are exact in float32."""
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, 256, n).astype(np.int64)
    term = (rng.integers(0, 128, n) * 2 + cust % 2).astype(np.int64)
    t_s = np.sort(rng.integers(0, 20 * 86400, n)).astype(np.int64)
    save_transactions(path, Transactions(
        tx_id=np.arange(n, dtype=np.int64),
        tx_time_seconds=t_s,
        tx_time_days=(t_s // 86400).astype(np.int32),
        customer_id=cust,
        terminal_id=term,
        amount_cents=(rng.integers(1, 300, n) * 100).astype(np.int64),
        tx_fraud=(rng.random(n) < 0.05).astype(np.int8),
        tx_fraud_scenario=np.zeros(n, np.int8)))


def make_model(path: str) -> None:
    save_model(path, TrainedModel(
        kind="logreg",
        scaler=Scaler(mean=torch.zeros(15), scale=torch.ones(15)),
        params=init_logreg(15, seed=1)))


def read_parts(pattern: str) -> dict:
    import pyarrow.parquet as pq

    parts = sorted(glob.glob(pattern, recursive=True))
    assert parts, f"no parquet parts under {pattern}"
    tables = [pq.read_table(p).to_pydict() for p in parts]
    return {k: np.concatenate([np.asarray(t[k]) for t in tables])
            for k in tables[0]}


def part_indexes(directory: str) -> list:
    return sorted(int(re.search(r"part-(\d+)", os.path.basename(p))
                      .group(1))
                  for p in glob.glob(os.path.join(directory,
                                                  "part-*.parquet")))


def series(snap: dict, name: str) -> list:
    return (snap.get(name) or {}).get("series", [])


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """ONE fleet run through the launcher and ONE control run."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))  # the process group needs loopback
    root = tmp_path_factory.mktemp("torch_fleet")
    data, model = str(root / "txs.npz"), str(root / "model.npz")
    make_dataset(data, N_ROWS)
    make_model(model)
    common = ["--device", "cpu", "--source", "replay", "--data", data,
              "--model-file", model, "--precompile",
              "--batch-rows", str(BATCH_ROWS),
              "--max-batch-rows", str(BATCH_ROWS)]
    (root / "dumps").mkdir()
    p = subprocess.run(
        [sys.executable, "-m", LAUNCHER, "--processes", str(N_PROCS),
         "--workdir", str(root / "wd"), "--timeout", "150",
         "--flight-record", str(root / "cluster.jsonl"), "--",
         "score", *common, "--devices", "1", "--out", str(root / "out"),
         "--checkpoint-dir", str(root / "ckpt"), "--drain-on-sigterm",
         "--cms-exchange", str(root / "xch"),
         "--metrics-dump", str(root / "dumps" / "{proc}.json")],
        env=spawn_env(), capture_output=True, text=True, timeout=180)
    lines = [ln for ln in p.stdout.splitlines() if ln.startswith("{")]
    assert p.returncode == 0 and lines, (
        f"fleet rc={p.returncode}\n{p.stdout[-2000:]}\n{p.stderr[-3000:]}")
    assert tcli.main(["score", *common, "--devices", str(N_PROCS),
                      "--out", str(root / "ctrl")]) == 0
    return {"root": root, "report": json.loads(lines[-1]),
            "dumps": {pid: json.loads((root / "dumps" / f"{pid:02d}.json")
                                      .read_text())
                      for pid in range(N_PROCS)}}


def test_fleet_completes_coordinated_and_covers_the_stream(fleet):
    rep = fleet["report"]
    assert rep["processes"] == N_PROCS and rep["coordinated"] is True
    assert rep["rows_total"] == N_ROWS and rep["fleet_restarts"] == 0
    assert all(w["rc"] == 0 and w["rows"] > 0 for w in rep["workers"])
    ids = read_parts(str(fleet["root"] / "out" / "**" /
                         "part-*.parquet"))["tx_id"]
    assert len(ids) == N_ROWS
    assert np.array_equal(np.sort(ids), np.arange(N_ROWS))


def test_each_process_lineage_is_gap_and_duplicate_free(fleet):
    for pid in range(N_PROCS):
        d = str(fleet["root"] / "out" / f"proc-{pid:02d}")
        idx = part_indexes(d)
        assert idx == list(range(1, len(idx) + 1)), (d, idx)
        # each process's final checkpoint is its own block's, stamped
        # with the writer's topology
        ck = make_checkpointer(str(fleet["root"] / "ckpt" /
                                   f"proc-{pid:02d}"))
        meta = ck.manifest(ck.latest())["meta"]
        assert (meta["process_count"], meta["process_id"]) == (N_PROCS, pid)
        assert meta["offsets"] == [N_ROWS]


def test_shard_series_carry_global_ids_and_process_labels(fleet):
    for pid, snap in fleet["dumps"].items():
        labels = [r["labels"] for r in series(snap, "rtfds_shard_rows")]
        assert labels == [{"shard": str(pid), "process": str(pid)}]
        skipped = series(snap, "rtfds_affine_skipped_rows_total")
        assert skipped and skipped[0]["value"] > 0
        assert sum(r["value"] for r in series(
            snap, "cuda_graph_recaptures_total")) == 0


def test_fleet_output_is_bit_identical_to_the_single_process(fleet):
    got = read_parts(str(fleet["root"] / "out" / "**" / "part-*.parquet"))
    want = read_parts(str(fleet["root"] / "ctrl" / "part-*.parquet"))
    g, w = np.argsort(got["tx_id"]), np.argsort(want["tx_id"])
    cols = [k for k in want if k not in ("processed_at_us",)]
    assert len(cols) == 20  # ids, time, keys, amount, 15 features, prediction
    for k in cols:
        assert got[k][g].tobytes() == want[k][w].tobytes(), k


def test_flight_record_holds_the_fleet(fleet):
    manifest, records = FlightRecorder.read(str(fleet["root"] /
                                                "cluster.jsonl"))
    assert manifest["multihost"] == {"processes": N_PROCS,
                                     "coordinated": True,
                                     "autoscale": False}
    started = [r["process"] for r in records
               if r.get("event") == "cluster_worker_start"]
    done = [r for r in records if r.get("event") == "cluster_worker"]
    assert sorted(started) == list(range(N_PROCS))
    assert sum(r["rows"] for r in done) == N_ROWS


_GROUP = r"""
import json, sys
import torch.distributed as dist
from real_time_fraud_detection_system_tpu_torch.parallel import distributed
from real_time_fraud_detection_system_tpu_torch.parallel import mesh
from real_time_fraud_detection_system_tpu_torch.config import (
    DistributedConfig)
from real_time_fraud_detection_system_tpu_torch.runtime.distributed import (
    bootstrap_distributed)
topo = bootstrap_distributed(DistributedConfig(
    coordinator=sys.argv[1], num_processes=2, process_id=int(sys.argv[2]),
    init_timeout_s=60), local_devices=2)
out = {"topology": topo.describe(),
       "probe": mesh.cross_process_collectives_supported(),
       "mesh": mesh.make_process_mesh(2, "cpu")}
dist.barrier()
distributed.shutdown_distributed()
print(json.dumps(out))
"""


def test_two_processes_join_a_gloo_group_and_probe_it(tmp_path):
    """Two interpreters bootstrap one coordinated fleet: the group reports
    two processes, the collective probe (a gloo ``all_reduce``) passes,
    the process mesh orders every process's shards by residue block, and
    both leave the group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _GROUP, f"127.0.0.1:{port}", str(pid)],
        env=spawn_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for pid in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    got = [json.loads(out.strip().splitlines()[-1]) for out, _ in outs]
    for pid, g in enumerate(got):
        assert g["topology"] == {
            "num_processes": 2, "process_id": pid, "local_devices": 2,
            "n_shards_total": 4, "owned_shards": [2 * pid, 2 * pid + 2],
            "coordinated": True}
        assert g["probe"] is None
        assert g["mesh"] == [[0, "cpu"], [0, "cpu"], [1, "cpu"], [1, "cpu"]]
