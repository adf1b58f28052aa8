"""The port stands alone: it imports neither jax nor the JAX package.

One check imports the port in a fresh interpreter where ``import jax``
fails, and serves a batch of each model kind on the CPU (the gbt weights
through the port's own artifact writer and reader), a batch under hash
keys and under the customer sketch from envelopes, and one through the
``score`` command, a supervised checkpointed run that crashes and
replays, and ingest and observability (a prefetched run under the tracer,
a flight record and the metrics server, a raw-table backfill, ``score
--scorer cpu`` with prefetch and the observability flags), and the
offline side (the feature replay, training of each kind, a selection
sweep and the ``train`` command), and the sharded engine (4 shards on
the CPU, a hot customer's spill, a restore at 8 shards, ``score --devices
4``), and the fleet (two processes' engines of a topology behind the
affine and floor sources, a sketch exchange, the merge of their states,
the launcher's worker commands, the elastic policy); the other reads the
port's sources (Python, CUDA and CUDA headers) and ``chip_smoke.py`` for
an import of jax or a dotted reference into the JAX package.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "real_time_fraud_detection_system_tpu_torch"

_SERVE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
import torch
from real_time_fraud_detection_system_tpu_torch.config import (
    Config, DataConfig, FeatureConfig, RuntimeConfig)
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel, dump_model_bytes, load_model_bytes)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble)
from real_time_fraud_detection_system_tpu_torch.models.gbt import (
    synthetic_gbt)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource)
import real_time_fraud_detection_system_tpu_torch.weights  # noqa: F401
import dataclasses
from real_time_fraud_detection_system_tpu_torch import cli
from real_time_fraud_detection_system_tpu_torch.core import native
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    save_transactions)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    AsyncSink, ConsoleSink, FanoutSink, ParquetSink)  # noqa: F401
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    SyntheticSource)  # noqa: F401

cfg = Config(data=DataConfig(n_customers=40, n_terminals=80, n_days=10),
             features=FeatureConfig(customer_capacity=64,
                                    terminal_capacity=128),
             runtime=RuntimeConfig(batch_buckets=(256,)))
_, _, txs = generate_dataset(cfg.data)
scaler = fit_scaler(np.ones((2, 15)), device="cpu")
logreg = LogRegParams(torch.full((15,), 0.1), torch.tensor(-1.0))
gbt = synthetic_gbt(3, 3, device="cpu")
model = load_model_bytes(dump_model_bytes(TrainedModel("gbt", scaler, gbt)),
                         device="cpu")
for kind, params in (("forest", synthetic_ensemble(3, 3, device="cpu")),
                     ("logreg", logreg), ("gbt", model.params)):
    eng = ScoringEngine(cfg, kind, params, scaler, device="cpu")
    sink = MemorySink()
    stats = eng.run(ReplaySource(txs, 1_743_465_600, batch_rows=200), sink,
                    max_batches=1)
    assert stats["batches"] == 1 and len(sink.concat()["prediction"]) == 200
# hash keys and the customer sketch, envelope ingest through the native
# decoder, and the score command
for features in ({"key_mode": "hash"}, {"customer_source": "cms",
                                        "cms_width": 256}):
    fcfg = dataclasses.replace(cfg.features, **features)
    eng = ScoringEngine(dataclasses.replace(cfg, features=fcfg), "forest",
                        synthetic_ensemble(3, 3, device="cpu"), scaler,
                        device="cpu")
    stats = eng.run(ReplaySource(txs, 1_743_465_600, batch_rows=200,
                                 mode="envelope"), MemorySink(),
                    max_batches=1)
    assert stats["batches"] == 1 and stats["host_prep_route"] == "native"
assert native.native_available()
import tempfile
with tempfile.TemporaryDirectory() as tmp:
    save_transactions(f"{tmp}/txs.npz", txs)
    with open(f"{tmp}/gbt.npz", "wb") as f:
        f.write(dump_model_bytes(TrainedModel("gbt", scaler, gbt)))
    assert cli.main(["score", "--device", "cpu", "--data", f"{tmp}/txs.npz",
                     "--model-file", f"{tmp}/gbt.npz", "--max-batches",
                     "1", "--batch-rows", "200"]) == 0
# a supervised, checkpointed run: a crash, a restore, a replay
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    Checkpointer)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    DeadLetterSink)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    FlakySource, run_with_recovery)
rcfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
    cfg.runtime, checkpoint_every_batches=1))
with tempfile.TemporaryDirectory() as tmp:
    stats = run_with_recovery(
        lambda: ScoringEngine(rcfg, "logreg", logreg, scaler, device="cpu"),
        FlakySource(ReplaySource(txs, 1_743_465_600, batch_rows=100),
                    fail_at=(1,)),
        Checkpointer(f"{tmp}/ck"), sink=MemorySink(), max_restarts=1,
        dead_letter=DeadLetterSink(f"{tmp}/dlq.jsonl"), max_batches=2)
    assert stats["restarts"] == 1 and stats["batches"] == 2
# ingest and observability: a prefetched run under the tracer, a flight
# record and the metrics server; a raw-table backfill; the score command
# with the CPU scorer, prefetch and every observability flag
import json
import urllib.request
from real_time_fraud_detection_system_tpu_torch.io.tables import (
    RawTransactionsTable)
from real_time_fraud_detection_system_tpu_torch.runtime.prefetch import (
    PrefetchSource)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    KafkaSource, RawTableSource, make_kafka_source)  # noqa: F401
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder, MetricsServer, run_manifest)
from real_time_fraud_detection_system_tpu_torch.utils.trace import get_tracer
from real_time_fraud_detection_system_tpu_torch.utils.tracing import (
    profile_to)
tracer = get_tracer().configure(enabled=True)
server = MetricsServer(port=0).start()
with tempfile.TemporaryDirectory() as tmp:
    eng = ScoringEngine(cfg, "forest", synthetic_ensemble(3, 3, device="cpu"),
                        scaler, device="cpu")
    eng.recorder = FlightRecorder(f"{tmp}/fr.jsonl",
                                  manifest=run_manifest(cfg, "forest"))
    raw = RawTransactionsTable(f"{tmp}/raw")
    src = PrefetchSource(ReplaySource(txs, 1_743_465_600, batch_rows=200),
                         max_batches=2)
    with profile_to(f"{tmp}/prof"):
        stats = eng.run(src, FanoutSink(MemorySink(), raw), max_batches=2)
    src.close()
    raw.flush()
    assert stats["batches"] == 2 and len(raw) == stats["rows"] == txs.n
    with urllib.request.urlopen(server.url + "/healthz", timeout=5) as r:
        assert json.loads(r.read())["status"] == "ok"
    eng.recorder.close()
    eng.recorder = None
    stats = eng.run(RawTableSource(f"{tmp}/raw", batch_rows=200),
                    MemorySink())
    assert stats["rows"] == txs.n
    save_transactions(f"{tmp}/txs.npz", txs)
    with open(f"{tmp}/gbt.npz", "wb") as f:
        f.write(dump_model_bytes(TrainedModel("gbt", scaler, gbt)))
    assert cli.main(["score", "--device", "cpu", "--data", f"{tmp}/txs.npz",
                     "--model-file", f"{tmp}/gbt.npz", "--max-batches", "2",
                     "--batch-rows", "200", "--scorer", "cpu",
                     "--prefetch-batches", "2", "--metrics-dump",
                     f"{tmp}/m.json", "--flight-record", f"{tmp}/f.jsonl",
                     "--trace-out", f"{tmp}/t.json"]) == 0
server.stop()
# the offline side: replay, training of each kind, selection, the train
# command (tree kinds, sklearn's oracle and the plots import their
# packages only when called)
from real_time_fraud_detection_system_tpu_torch.config import (
    ModelConfig, TrainConfig)
from real_time_fraud_detection_system_tpu_torch.features.offline import (
    compute_features_replay, warm_start_state)
from real_time_fraud_detection_system_tpu_torch.models import (  # noqa: F401
    cpu_oracle, metrics, optim, plots, selection)
from real_time_fraud_detection_system_tpu_torch.models.train import (
    train_model)
ocfg = dataclasses.replace(
    cfg, model=ModelConfig(forest_n_trees=2, forest_max_depth=2,
                           mlp_hidden=(4,), autoencoder_hidden=(4, 2),
                           seq_d_model=8, seq_n_layers=1, seq_d_ff=8),
    train=TrainConfig(delta_train_days=5, delta_delay_days=1,
                      delta_test_days=3, epochs=1, batch_size=64))
feats = compute_features_replay(txs, ocfg.features, chunk=256, device="cpu")
warm_start_state(txs, ocfg.features, chunk=256, device="cpu")
for kind in ("logreg", "mlp", "autoencoder", "gbt", "sequence"):
    model, met = train_model(txs, ocfg, features=feats, kind=kind,
                             device="cpu")
    assert "auc_roc" in met
rows = selection.model_selection_wrapper(
    txs, feats, ocfg, "logreg", {"learning_rate": [0.01]}, 0, 1, n_folds=1,
    device="cpu")
assert len(rows) == 2
with tempfile.TemporaryDirectory() as tmp:
    save_transactions(f"{tmp}/txs.npz", txs)
    assert cli.main(["train", "--device", "cpu", "--data", f"{tmp}/txs.npz",
                     "--model", "logreg", "--out-model", f"{tmp}/m.npz",
                     "--delta-train", "5", "--delta-delay", "1",
                     "--delta-test", "3", "--epochs", "1"]) == 0
# the sharded engine: 4 shards co-located on the CPU, a hot customer's
# spill, a checkpoint restored at 8 shards, and score --devices 4
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    Checkpointer)
from real_time_fraud_detection_system_tpu_torch.parallel import (  # noqa
    mesh, step)
from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
    import ShardedScoringEngine
hot = txs.slice(slice(0, 400))
hot.customer_id = hot.customer_id * 0 + 3
with tempfile.TemporaryDirectory() as tmp:
    ck = Checkpointer(f"{tmp}/ck")
    eng = ShardedScoringEngine(cfg, "forest",
                               synthetic_ensemble(3, 3, device="cpu"),
                               scaler, n_devices=4, device="cpu")
    stats = eng.run(ReplaySource(hot, 1_743_465_600, batch_rows=200),
                    MemorySink())
    assert stats["batches"] == 2 and eng.state.layout_devices == 4
    ck.save(eng.state)
    eng8 = ShardedScoringEngine(cfg, "forest",
                                synthetic_ensemble(3, 3, device="cpu"),
                                scaler, n_devices=8, device="cpu")
    assert ck.restore(eng8.state) is not None
    stats = eng8.run(ReplaySource(txs, 1_743_465_600, batch_rows=200),
                     MemorySink(), max_batches=1)
    assert stats["batches"] == 1 and eng8.state.layout_devices == 8
    save_transactions(f"{tmp}/txs.npz", txs)
    with open(f"{tmp}/gbt.npz", "wb") as f:
        f.write(dump_model_bytes(TrainedModel("gbt", scaler, gbt)))
    assert cli.main(["score", "--device", "cpu", "--data", f"{tmp}/txs.npz",
                     "--model-file", f"{tmp}/gbt.npz", "--max-batches",
                     "1", "--batch-rows", "200", "--devices", "4"]) == 0
# the fleet: two processes' engines of a topology behind the affine
# source, their states merged, a sketch exchange round, the launcher's
# worker commands and the elastic policy
from real_time_fraud_detection_system_tpu_torch.parallel import (  # noqa
    distributed)
from real_time_fraud_detection_system_tpu_torch.runtime import (
    cms_exchange, elastic)
from real_time_fraud_detection_system_tpu_torch.runtime.distributed import (
    ProcessTopology)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    OwnershipFloorSource, PartitionAffineSource)
from real_time_fraud_detection_system_tpu_torch.tools import (
    multihost_launcher)
from real_time_fraud_detection_system_tpu_torch.utils import tree
xcfg = cfg  # direct keys: the table's terminals are not co-partitioned
states = []
with tempfile.TemporaryDirectory() as tmp:
    for pid in (0, 1):
        topo = ProcessTopology(2, pid, 1)
        eng = ShardedScoringEngine(xcfg, "logreg", logreg, scaler,
                                   n_devices=1, device="cpu", topology=topo)
        eng.cms_exchange = cms_exchange.SketchExchange(f"{tmp}/x", pid, 2,
                                                       timeout_s=0.0)
        src = PartitionAffineSource(OwnershipFloorSource(
            ReplaySource(txs, 1_743_465_600, batch_rows=200), [0, 200], 2,
            1), topo)
        eng.run(src, MemorySink(), max_batches=2)
        eng._maybe_exchange_cms()
        states.append(tree.map(
            lambda t: t.numpy() if isinstance(t, torch.Tensor) else t,
            eng.checkpoint_state().feature_state))
mesh.merge_process_states(states, xcfg, [1, 1])
args = type("A", (), {"processes": 2, "local_devices": 1, "workdir": "/tmp",
                      "worker_metrics_base": 0})()
assert len(multihost_launcher.build_workers(args, ["score"], "")) == 2
assert elastic.ElasticPolicy(elastic.ElasticConfig()).observe(
    elastic.ClusterSignals(), 1, 0.0) is None
assert not any(m.split(".")[0] in ("jax", "real_time_fraud_detection_system_tpu")
               for m, mod in sys.modules.items() if mod is not None)
print("served without jax")
"""


def test_port_serves_a_batch_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "served without jax" in proc.stdout


_FORBIDDEN = [
    re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M),
    re.compile(r"real_time_fraud_detection_system_tpu\."),
]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*")
           if p.suffix in (".py", ".cu", ".cuh")
           and "_build" not in p.parts)
    + ["chip_smoke.py"])
def test_sources_name_neither_jax_nor_the_jax_package(path):
    text = (ROOT / path).read_text()
    for pattern in _FORBIDDEN:
        assert not pattern.search(text), (path, pattern.pattern)
