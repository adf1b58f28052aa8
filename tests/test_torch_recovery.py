"""The port's exactly-once durability against the JAX package's contract.

- **The recovery matrix** of ``tests/test_recovery_smoke.py`` (its cold
  tier's cells too: a crash mid-promotion, a torn segment manifest,
  flipped segment bytes), on both durable planes — a
  local checkpoint directory and ``StoreCheckpointer(LocalStore)`` —
  with the same exact counter deltas (``rtfds_checkpoint_corrupt_total``
  by reason, ``rtfds_checkpoint_fallbacks_total``,
  ``rtfds_retry_attempts_total``) and the same gap- and duplicate-free
  ``batch_index`` lineage in the Parquet sink.
- **The chaos timeline** of ``tests/test_chaos_smoke.py``: one flaky
  poll, one poison batch and one silent hang in one supervised run; 6
  batches, 1533 rows, 4 restarts, the dead-letter queue equal to the
  poison ids, backoff sleeps ``[0.01, 0.02]``.
- **The port's own traps**: a replay equals the uninterrupted run at
  pipeline depths 1, 2 and 3 and coalesced, and every checkpoint holds
  exactly the batches it counts; a restore of other params serves them
  (the kernel tables are re-derived) and writes into the engine's own
  tensors; a ``RuntimeError`` in the step (how PyTorch raises a CUDA
  fault) is never retried, bisected or quarantined; the ``score`` CLI's
  checkpoint, resume and dead-letter flags against the JAX ``score``.

Everything runs on the CPU (``device="cpu"``), where the sums are
deterministic, so replays are held bit for bit.
"""

import dataclasses
import gc
import json
import os
import threading
import time
import weakref
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    read_dead_letter as jread_dead_letter,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models.logreg import init_logreg
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    Checkpointer,
    StoreCheckpointer,
)
from real_time_fraud_detection_system_tpu_torch.io.registry import (
    make_model_registry,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    DeadLetterSink,
    MemorySink,
    ParquetDeadLetterSink,
    ParquetSink,
    make_dead_letter_sink,
    read_dead_letter,
)
from real_time_fraud_detection_system_tpu_torch.io.store import (
    LocalStore,
    make_store,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    PoisonRowError,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    FlakySource,
    FlakyStore,
    HangingSource,
    PoisonSource,
    RetryPolicy,
    TornStore,
    TransientError,
    corrupt_messages,
    poison_messages,
    run_with_recovery,
    with_retries,
)
from real_time_fraud_detection_system_tpu_torch.runtime.feedback import (
    FeatureCache,
    FeedbackLoop,
    encode_feedback_envelopes,
)
from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
    LearningLoop,
    StreamingLearner,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder,
    get_registry,
    set_active_recorder,
)

torch.set_num_threads(1)

EPOCH0 = 1_743_465_600
REASONS = ("checksum", "truncated", "incompatible")


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _counters():
    reg = get_registry()
    vals = {r: reg.counter("rtfds_checkpoint_corrupt_total",
                           reason=r).value for r in REASONS}
    vals["fallbacks"] = reg.counter(
        "rtfds_checkpoint_fallbacks_total").value
    vals["retried"] = reg.counter("rtfds_retry_attempts_total",
                                  outcome="retried").value
    return vals


def _cfg(**runtime) -> Config:
    return Config(
        features=FeatureConfig(customer_capacity=256, terminal_capacity=512,
                               cms_width=1 << 10),
        runtime=RuntimeConfig(**{"checkpoint_every_batches": 2,
                                 "batch_buckets": (256,), **runtime}))


_LOGREG = weights.from_numpy(jax.tree.map(np.asarray, init_logreg(15)),
                             device="cpu")


def _mk(small_dataset, rows: int, **runtime):
    part = _port_txs(small_dataset[3].slice(slice(0, rows)))
    cfg = _cfg(**runtime)

    def make_engine():
        return ScoringEngine(cfg, "logreg", _LOGREG,
                             Scaler(torch.zeros(15), torch.ones(15)),
                             device="cpu")

    return part, make_engine


@pytest.fixture(params=["local", "store"])
def plane(request, tmp_path):
    """A local checkpoint directory or an object store (LocalStore, so a
    cell can reach under the API to corrupt the stored bytes)."""
    if request.param == "local":
        d = str(tmp_path / "ck")

        def make(**kw):
            return Checkpointer(d, **kw)

        def file_of(path):
            return path
    else:
        root = str(tmp_path / "obj")

        def make(**kw):
            return StoreCheckpointer(LocalStore(root), **kw)

        def file_of(key):
            return os.path.join(root, key)

    return SimpleNamespace(kind=request.param, make=make, file_of=file_of)


def _phase1(make_engine, part, ckpt, sink_dir, max_batches):
    eng = make_engine()
    eng.run(ReplaySource(part, EPOCH0, batch_rows=256),
            sink=ParquetSink(sink_dir), checkpointer=ckpt,
            max_batches=max_batches)
    return eng


def _phase2(make_engine, part, ckpt, sink_dir, max_restarts=3):
    return run_with_recovery(
        make_engine, ReplaySource(part, EPOCH0, batch_rows=256), ckpt,
        sink=ParquetSink(sink_dir), max_restarts=max_restarts)


def _assert_lineage(sink_dir, part, n_parts):
    parts = sorted(p for p in os.listdir(sink_dir) if p.startswith("part-"))
    idxs = [int(p[len("part-"):-len(".parquet")]) for p in parts]
    assert idxs == list(range(1, n_parts + 1))
    total = sum(pq.read_table(os.path.join(sink_dir, f)).num_rows
                for f in parts)
    assert total == part.n
    back = ParquetSink(sink_dir).read_all()
    assert sorted(np.unique(back["tx_id"]).tolist()) == sorted(
        part.tx_id.tolist())


# -- the recovery matrix ----------------------------------------------------


def test_corrupt_latest_byte_flip(plane, tmp_path, small_dataset):
    part, make_engine = _mk(small_dataset, 1536)
    sink_dir = str(tmp_path / "analyzed")
    ckpt = plane.make()
    _phase1(make_engine, part, ckpt, sink_dir, max_batches=4)
    f = plane.file_of(ckpt.latest())
    data = open(f, "rb").read()
    with open(f, "r+b") as fh:
        fh.seek(len(data) // 2)
        fh.write(bytes([data[len(data) // 2] ^ 0xFF]))

    base = _counters()
    stats = _phase2(make_engine, part, plane.make(), sink_dir)
    after = _counters()

    assert stats["batches"] == 6 and stats["rows"] >= 1536
    assert after["checksum"] - base["checksum"] == 1
    assert after["truncated"] == base["truncated"]
    assert after["incompatible"] == base["incompatible"]
    assert after["fallbacks"] - base["fallbacks"] == 1
    fresh = plane.make()
    assert sum(1 for n in fresh._backend.list_names()
               if n.startswith("stale-")) == 1
    assert all(e["valid"] for e in fresh.verify_all())
    _assert_lineage(sink_dir, part, 6)


def test_corrupt_latest_truncation(plane, tmp_path, small_dataset):
    part, make_engine = _mk(small_dataset, 1536)
    sink_dir = str(tmp_path / "analyzed")
    ckpt = plane.make()
    _phase1(make_engine, part, ckpt, sink_dir, max_batches=4)
    f = plane.file_of(ckpt.latest())
    data = open(f, "rb").read()
    with open(f, "wb") as fh:
        fh.write(data[: len(data) // 3])

    base = _counters()
    stats = _phase2(make_engine, part, plane.make(), sink_dir)
    after = _counters()

    assert stats["batches"] == 6
    assert after["truncated"] - base["truncated"] == 1
    assert after["checksum"] == base["checksum"]
    assert after["fallbacks"] - base["fallbacks"] == 1
    _assert_lineage(sink_dir, part, 6)


def test_kill_during_save_local(tmp_path, small_dataset):
    """Killed between the temporary write and the rename: the committed
    lineage is intact, the orphan is swept, and nothing counts as
    corruption."""
    part, make_engine = _mk(small_dataset, 1536)
    d = str(tmp_path / "ck")
    sink_dir = str(tmp_path / "analyzed")
    ckpt = Checkpointer(d)
    _phase1(make_engine, part, ckpt, sink_dir, max_batches=4)
    latest = ckpt.latest()
    os.remove(latest)
    orphan = latest + ".tmp"
    with open(orphan, "wb") as fh:
        fh.write(b"half a checkpoint, interrupted")

    base = _counters()
    stats = _phase2(make_engine, part, Checkpointer(d), sink_dir)
    after = _counters()

    assert stats["batches"] == 6
    assert not os.path.exists(orphan)
    assert after == base
    _assert_lineage(sink_dir, part, 6)


def test_kill_during_save_store_torn_put(tmp_path, small_dataset):
    part, make_engine = _mk(small_dataset, 1536)
    root = str(tmp_path / "obj")
    sink_dir = str(tmp_path / "analyzed")
    torn = TornStore(LocalStore(root), tear_at=1, keep_bytes=256)
    _phase1(make_engine, part, StoreCheckpointer(torn), sink_dir,
            max_batches=4)  # the save at 2 lands, the one at 4 torn

    base = _counters()
    stats = _phase2(make_engine, part,
                    StoreCheckpointer(LocalStore(root)), sink_dir)
    after = _counters()

    assert stats["batches"] == 6
    assert after["truncated"] - base["truncated"] == 1
    assert after["fallbacks"] - base["fallbacks"] == 1
    _assert_lineage(sink_dir, part, 6)
    assert get_registry().counter(
        "rtfds_faults_injected_total", kind="torn_store_put").value >= 1


def test_flaky_store_hardening(tmp_path, small_dataset):
    """Scripted PUT and GET failures and a crash: the ops retry, the
    restore goes through the flake, nothing counts as corrupt."""
    part, make_engine = _mk(small_dataset, 1536)
    root = str(tmp_path / "obj")
    sink_dir = str(tmp_path / "analyzed")
    flaky = FlakyStore(LocalStore(root), fail_puts=(0,), fail_gets=(0,))
    ckpt = StoreCheckpointer(flaky, op_attempts=3)
    src = FlakySource(ReplaySource(part, EPOCH0, batch_rows=256),
                      fail_at=(3,))

    base = _counters()
    stats = run_with_recovery(make_engine, src, ckpt,
                              sink=ParquetSink(sink_dir), max_restarts=3)
    after = _counters()

    assert stats["batches"] == 6
    assert stats["restarts"] == 1
    assert after["retried"] - base["retried"] >= 2
    for r in REASONS:
        assert after[r] == base[r]
    assert after["fallbacks"] == base["fallbacks"]
    _assert_lineage(sink_dir, part, 6)


def test_delta_chain_break(plane, tmp_path, small_dataset):
    """A corrupted entry in the middle of a delta chain: the tip and the
    garbage both quarantine, the last valid full serves, and the replay
    completes the stream."""
    part, make_engine = _mk(small_dataset, 2048)
    sink_dir = str(tmp_path / "analyzed")
    ckpt = plane.make(full_every=10)
    _phase1(make_engine, part, ckpt, sink_dir, max_batches=6)
    names = [os.path.basename(p) for p in ckpt.list_checkpoints()]
    assert names == ["ckpt-0000000002.npz",
                     "ckpt-0000000004-delta.npz",
                     "ckpt-0000000006-delta.npz"]
    mid = ckpt.list_checkpoints()[1]
    with open(plane.file_of(mid), "wb") as fh:
        fh.write(b"garbage where a delta used to be")

    base = _counters()
    stats = _phase2(make_engine, part, plane.make(full_every=10), sink_dir)
    after = _counters()

    assert stats["batches"] == 8
    assert after["truncated"] - base["truncated"] == 2
    assert after["fallbacks"] - base["fallbacks"] == 1
    fresh = plane.make()
    assert sum(1 for n in fresh._backend.list_names()
               if n.startswith("stale-")) == 2
    report = fresh.verify_all()
    assert report and all(e["valid"] for e in report)
    _assert_lineage(sink_dir, part, 8)


def test_recovery_events_in_flight_record(tmp_path, small_dataset):
    part, make_engine = _mk(small_dataset, 1536)
    d = str(tmp_path / "ck")
    sink_dir = str(tmp_path / "analyzed")
    ckpt = Checkpointer(d)
    _phase1(make_engine, part, ckpt, sink_dir, max_batches=4)
    latest = ckpt.latest()
    with open(latest, "wb") as fh:
        fh.write(b"garbage")

    rec = FlightRecorder(str(tmp_path / "flight.jsonl"))
    set_active_recorder(rec)
    try:
        _phase2(make_engine, part, Checkpointer(d), sink_dir)
    finally:
        set_active_recorder(None)
        rec.close()
    _, records = FlightRecorder.read(str(tmp_path / "flight.jsonl"))
    evs = [r for r in records if r.get("kind") == "event"
           and r.get("event") == "checkpoint_fallback"]
    assert any(e.get("path") == os.path.basename(latest)
               and e.get("reason") == "truncated" for e in evs)
    assert any(e.get("restored") and e.get("skipped") == 1 for e in evs)


def test_delta_saves_carry_only_the_changed_leaves(tmp_path, small_dataset):
    """Between fulls a save stores the leaves whose bytes changed (the
    feature state), not the params or the scaler; a delta restore equals
    a full one bit for bit."""
    part, make_engine = _mk(small_dataset, 1536)
    ckpt = Checkpointer(str(tmp_path / "ck"), full_every=3)
    eng = _phase1(make_engine, part, ckpt, str(tmp_path / "a"),
                  max_batches=4)
    man = ckpt.manifest(ckpt.latest())
    assert man["kind"] == "delta" and man["base"] == "ckpt-0000000002.npz"
    assert man["stored"] and all(k.startswith("fs_")
                                 for k in man["stored"])
    full = Checkpointer(str(tmp_path / "full"))
    full.save(eng.state)
    a, b = make_engine(), make_engine()
    ckpt.restore(a.state)
    full.restore(b.state)
    for x, y in zip(a.state.feature_state.terminal,
                    b.state.feature_state.terminal):
        assert torch.equal(x, y)
    assert a.state.offsets == b.state.offsets == [1024]


# -- the chaos timeline -----------------------------------------------------


def _drain_zombies(release, timeout_s: float = 15.0):
    """Wake abandoned incarnation threads and wait for them to die at the
    fence, which releases the engines they hold."""
    release.set()
    deadline = time.time() + timeout_s
    for t in threading.enumerate():
        if t.name == "engine-incarnation" \
                and t is not threading.current_thread():
            t.join(max(0.0, deadline - time.time()))
            assert not t.is_alive(), "an abandoned incarnation never ended"


def test_chaos_smoke(small_dataset, tmp_path):
    """Scripted poll timeline (each wrapper counts its own polls; the
    hang wrapper is outermost, so its indices are absolute): i0 flaky →
    restart 1 (crash); i1, i2 batches 1-2, checkpoint @2; i3 batch 3
    holds poison → restart 2; i4 the replay crashes at the same point →
    crash loop, restart 3; i5 isolation: 3 rows to the DLQ, checkpoint
    @3; i6 batch 4, checkpoint @4; i7 silent hang → restart 4 (stall);
    i8+ batches 5-6."""
    part, _ = _mk(small_dataset, 1536)
    cfg = _cfg()
    engines = []

    def make_engine():
        eng = ScoringEngine(cfg, "logreg", _LOGREG,
                            Scaler(torch.zeros(15), torch.ones(15)),
                            device="cpu")
        engines.append(weakref.ref(eng))
        return eng

    poison_ids = [int(i) for i in part.tx_id[520:523]]  # inside batch 3
    hang = HangingSource(
        FlakySource(
            PoisonSource(ReplaySource(part, EPOCH0, batch_rows=256),
                         poison_tx_ids=poison_ids),
            fail_at=(0,)),
        hang_at=(7,), max_hang_s=120.0)

    reg = get_registry()
    m_crash = reg.counter("rtfds_engine_restarts_total", cause="crash")
    m_stall = reg.counter("rtfds_engine_restarts_total", cause="stall")
    m_loops = reg.counter("rtfds_crash_loops_total")
    m_dlq = reg.counter("rtfds_dead_letter_rows_total", reason="crash")
    base = (m_crash.value, m_stall.value, m_loops.value, m_dlq.value)

    recorder = FlightRecorder(str(tmp_path / "chaos.jsonl"))
    set_active_recorder(recorder)
    dlq = DeadLetterSink(str(tmp_path / "dlq.jsonl"))
    sink = ParquetSink(str(tmp_path / "analyzed"))
    ckpt = Checkpointer(str(tmp_path / "ck"))
    backoff_sleeps = []
    try:
        stats = run_with_recovery(
            make_engine, hang, ckpt, sink=sink, max_restarts=6,
            stall_timeout_s=6.0, crash_loop_k=2, dead_letter=dlq,
            restart_backoff=RetryPolicy(base_delay_s=0.01, multiplier=2.0,
                                        max_delay_s=1.0),
            sleep=backoff_sleeps.append,
        )
    finally:
        set_active_recorder(None)
        recorder.close()
        _drain_zombies(hang.release)

    assert stats["batches"] == 6
    assert stats["rows"] == 1536 - 3
    assert stats["restarts"] == 4

    assert m_crash.value - base[0] == 3  # flake + poison + classification
    assert m_stall.value - base[1] == 1  # the hang
    assert m_loops.value - base[2] == 1
    assert m_dlq.value - base[3] == 3
    assert reg.gauge("rtfds_dead_letter_rows").value == len(dlq)

    assert dlq.tx_ids() == sorted(poison_ids)
    for rec in dlq.read_all():
        assert rec["reason"] == "crash"
        assert "PoisonRowError" in rec["error"]
        assert rec["batch_index"] == 3

    assert backoff_sleeps == [0.01, 0.02]

    parts = sorted((tmp_path / "analyzed").glob("part-*.parquet"))
    idxs = [int(p.name[len("part-"):-len(".parquet")]) for p in parts]
    assert idxs == [1, 2, 3, 4, 5, 6]
    total = sum(pq.read_table(str(f)).num_rows for f in parts)
    assert total == 1536 - 3
    back = sink.read_all()
    assert sorted(np.unique(back["tx_id"]).tolist()) == sorted(
        set(part.tx_id.tolist()) - set(poison_ids))

    _, records = FlightRecorder.read(str(tmp_path / "chaos.jsonl"))
    events = [r for r in records if r.get("kind") == "event"]
    kinds = [(e.get("event"), e.get("cause") or e.get("phase") or
              e.get("fault_kind")) for e in events]
    assert kinds.count(("restart", "crash")) == 3
    assert kinds.count(("restart", "stall")) == 1
    assert ("poison", "detected") in kinds
    assert ("poison", "isolated") in kinds
    assert any(e.get("event") == "dead_letter" and e.get("rows") == 3
               for e in events)
    assert any(e.get("event") == "fault" and e.get("fault_kind") == "hang"
               for e in events)
    assert any(e.get("event") == "fault"
               and e.get("fault_kind") == "flaky_poll" for e in events)

    # one engine per incarnation (4 restarts + the isolation); once the
    # zombie has died at its fence, no engine but the last is alive
    assert len(engines) == 6
    gc.collect()
    assert sum(r() is not None for r in engines[:-1]) == 0


# -- the port's own traps ---------------------------------------------------


def _run_sink(make_engine, part, poll_rows=256, **kw):
    sink = MemorySink()
    eng = make_engine()
    eng.run(ReplaySource(part, EPOCH0, batch_rows=poll_rows), sink, **kw)
    return eng, sink


def _by_index(sink_dir: str) -> dict:
    out = {}
    for f in sorted(os.listdir(sink_dir)):
        t = pq.read_table(os.path.join(sink_dir, f)).to_pydict()
        t.pop("processed_at_us")
        out[int(f[len("part-"):-len(".parquet")])] = t
    return out


@pytest.mark.parametrize("depth,coalesce,poll_rows", [
    (1, 0, 256), (2, 0, 256), (3, 0, 256), (2, 512, 128)],
    ids=["depth1", "depth2", "depth3", "depth2-coalesced"])
def test_replay_equals_the_uninterrupted_run(tmp_path, small_dataset, depth,
                                             coalesce, poll_rows):
    """Every checkpoint holds exactly the batches it counts (the loop
    drains before launching past a batch that will save), and a run
    crashed twice and replayed from its checkpoints writes the sink
    output and the final state of the uninterrupted run, bit for bit."""
    buckets = (256, 512) if coalesce else (256,)
    part, make_engine = _mk(small_dataset, 2560, pipeline_depth=depth,
                            coalesce_rows=coalesce, batch_buckets=buckets)
    ref_dir = str(tmp_path / "ref")
    ref = make_engine()
    ckpt = Checkpointer(str(tmp_path / "ck"), keep=10)
    ref.run(ReplaySource(part, EPOCH0, batch_rows=poll_rows),
            sink=ParquetSink(ref_dir), checkpointer=ckpt)
    n = ref.state.batches_done
    saved = ckpt.list_checkpoints()
    assert len(saved) == n // 2
    for path in saved:
        at = Checkpointer(str(tmp_path / "ck"), keep=10)
        restored = make_engine()
        at.restore(restored.state, path=path)
        k = restored.state.batches_done
        exact, _ = _run_sink(make_engine, part, poll_rows, max_batches=k)
        assert restored.state.offsets == exact.state.offsets
        assert restored.state.rows_done == exact.state.rows_done
        for a, b in zip(restored.state.feature_state.terminal
                        + restored.state.feature_state.customer,
                        exact.state.feature_state.terminal
                        + exact.state.feature_state.customer):
            assert torch.equal(a, b), f"checkpoint {path} at batch {k}"

    src = FlakySource(ReplaySource(part, EPOCH0, batch_rows=poll_rows),
                      fail_at=(5, 12))
    crashed = str(tmp_path / "crashed")
    final = {}

    def make_and_keep():
        final["eng"] = make_engine()
        return final["eng"]

    stats = run_with_recovery(make_and_keep, src,
                              Checkpointer(str(tmp_path / "ck2")),
                              sink=ParquetSink(crashed), max_restarts=3)
    assert stats["restarts"] == 2 and stats["batches"] == n
    assert _by_index(crashed) == _by_index(ref_dir)
    for a, b in zip(final["eng"].state.feature_state.terminal,
                    ref.state.feature_state.terminal):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["forest", "gbt"])
def test_restore_of_other_params_serves_them(tmp_path, small_dataset, kind):
    """An engine built with other weights of the same shapes restores a
    checkpoint and serves the checkpoint's weights: the restore copies
    them into the engine's own tensors (the addresses stay) and the next
    step re-derives the kernel tables from them."""
    part = _port_txs(small_dataset[3].slice(slice(0, 1024)))
    cfg = _cfg()
    scaler = Scaler(torch.full((15,), 2.0), torch.full((15,), 3.0))
    if kind == "gbt":
        p1, p2 = (weights.from_numpy(jax.tree.map(np.asarray, jgbt
                  .synthetic_gbt(6, 4, 15, seed=s)), device="cpu")
                  for s in (1, 2))
    else:
        p1, p2 = (weights.from_numpy(jax.tree.map(np.asarray, jforest
                  .synthetic_ensemble(6, 4, 15, seed=s)), device="cpu")
                  for s in (1, 2))
    ref, ref_sink = _run_sink(lambda: ScoringEngine(
        cfg, kind, p1, scaler, device="cpu"), part)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    first = ScoringEngine(cfg, kind, p1, scaler, device="cpu")
    first.run(ReplaySource(part, EPOCH0, batch_rows=256),
              checkpointer=ckpt, max_batches=2)

    other = ScoringEngine(cfg, kind, p2, scaler, device="cpu")
    tables = other.tables if kind == "forest" else other.leaf_tables
    assert tables is not None
    ptrs = [t.data_ptr() for _, t in _tensor_leaves(other.state)]
    epoch = other.state.params_epoch
    ckpt.restore(other.state)
    assert other.state.params_epoch == epoch + 1
    assert [t.data_ptr() for _, t in _tensor_leaves(other.state)] == ptrs
    src = ReplaySource(part, EPOCH0, batch_rows=256)
    src.seek(other.state.offsets)
    sink = MemorySink()
    other.run(src, sink)
    got = sink.concat()["prediction"]
    want = np.concatenate([b["prediction"] for b in ref_sink.batches[2:]])
    np.testing.assert_array_equal(got, want)
    new = other.tables if kind == "forest" else other.leaf_tables
    old = ref.tables if kind == "forest" else ref.leaf_tables
    assert torch.equal(new.nodes, old.nodes)
    # a restore of the same params again keeps the tables
    ckpt.restore(other.state)
    assert other.state.params_epoch == epoch + 1


def _tensor_leaves(state):
    from real_time_fraud_detection_system_tpu_torch.utils.tree import leaves_with_path as _leaves

    return [(p, t) for tree in (state.feature_state, state.params,
                                state.scaler)
            for p, t in _leaves(tree) if isinstance(t, torch.Tensor)]


def test_engine_owns_its_params(small_dataset):
    """The caller's params are never written by a restore: the engine
    serves copies."""
    cfg = _cfg()
    scaler = Scaler(torch.zeros(15), torch.ones(15))
    eng = ScoringEngine(cfg, "logreg", _LOGREG, scaler, device="cpu")
    assert eng.state.params.w.data_ptr() != _LOGREG.w.data_ptr()
    assert eng.state.scaler.mean.data_ptr() != scaler.mean.data_ptr()
    assert torch.equal(eng.state.params.w, _LOGREG.w)


def _failing_step(make_engine, at_batch: int, exc):
    """Engines whose step raises ``exc`` on the batch numbered
    ``at_batch`` (1-based over the engine's lifetime)."""
    def make():
        eng = make_engine()
        step = eng._step

        def failing(packed):
            if eng.state.batches_done + 1 >= at_batch \
                    and packed.shape[1] == 256:
                raise exc
            return step(packed)

        eng._step = failing
        return eng

    return make


@pytest.mark.parametrize("with_dlq", [True, False])
def test_a_device_fault_is_never_retried_or_quarantined(
        tmp_path, small_dataset, with_dlq):
    """A ``RuntimeError`` in the step — how PyTorch raises a CUDA fault —
    propagates out of the supervisor at once: no restart, no crash loop,
    no bisection, nothing in the dead-letter queue."""
    part, make_engine = _mk(small_dataset, 1536, pipeline_depth=1)
    reg = get_registry()
    before = (reg.family_total("rtfds_engine_restarts_total") or 0.0,
              reg.counter("rtfds_crash_loops_total").value)
    dlq = DeadLetterSink(str(tmp_path / "dlq.jsonl")) if with_dlq else None
    err = RuntimeError("CUDA error: an illegal memory access was "
                       "encountered")
    with pytest.raises(RuntimeError, match="illegal memory access"):
        run_with_recovery(
            _failing_step(make_engine, 3, err),
            ReplaySource(part, EPOCH0, batch_rows=256),
            Checkpointer(str(tmp_path / "ck")), max_restarts=5,
            crash_loop_k=1, dead_letter=dlq)
    assert not isinstance(err, TransientError)
    assert (reg.family_total("rtfds_engine_restarts_total") or 0.0,
            reg.counter("rtfds_crash_loops_total").value) == before
    if dlq is not None:
        assert len(dlq) == 0 and dlq.read_all() == []


def test_a_device_fault_during_isolation_propagates(tmp_path,
                                                    small_dataset):
    """The bisection counts only recoverable failures: a ``RuntimeError``
    in a probe propagates, and no row is quarantined for it."""
    part, make_engine = _mk(small_dataset, 1536, pipeline_depth=1)
    poison = [int(part.tx_id[600])]
    calls = {"n": 0}

    def make():
        eng = make_engine()
        step = eng._step

        def flaky_device(packed):
            if eng.state.batches_done >= 2:
                calls["n"] += 1
                if calls["n"] > 2:  # from the isolation's probes on
                    raise RuntimeError("CUDA error: unspecified launch "
                                       "failure")
            return step(packed)

        eng._step = flaky_device
        return eng

    dlq = DeadLetterSink(str(tmp_path / "dlq.jsonl"))
    src = PoisonSource(ReplaySource(part, EPOCH0, batch_rows=256), poison)
    with pytest.raises(RuntimeError, match="launch failure"):
        run_with_recovery(make, src, Checkpointer(str(tmp_path / "ck")),
                          max_restarts=5, crash_loop_k=1, dead_letter=dlq)
    assert len(dlq) == 0



@pytest.mark.parametrize("mode", ["nvcc-missing", "build-dir-unusable",
                                  "library-will-not-load"])
def test_a_kernel_that_cannot_build_or_load_is_never_retried(
        tmp_path, small_dataset, monkeypatch, mode):
    """A kernel library that fails to build or load — no nvcc where the
    toolkit should be, a build directory that cannot be made, a library
    that will not load — raises ``RuntimeError`` (the system's
    ``OSError`` as its cause), never an ``OSError``, which the supervisor
    would retry as transient and then bisect into the dead-letter queue.
    The step loads the library as a card step's first launch does: the
    supervisor raises at once, no restart counted, nothing quarantined."""
    from real_time_fraud_detection_system_tpu_torch.ops import cuda_lib
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels as fk,
    )

    build = tmp_path / "build"
    monkeypatch.setattr(cuda_lib, "_nvcc",
                        lambda: str(tmp_path / "no-cuda" / "bin" / "nvcc"))
    if mode == "build-dir-unusable":
        (tmp_path / "a-file").write_text("")
        build = tmp_path / "a-file" / "build"
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", build)
    if mode == "library-will-not-load":
        build.mkdir()
        (build / f"lib{fk.SOURCE.stem}-{cuda_lib._digest(fk.SOURCE)}.so"
         ).write_bytes(b"not a shared library")
    fk._library.cache_clear()

    with pytest.raises(RuntimeError) as info:
        cuda_lib.load_library(fk.SOURCE)
    assert not isinstance(info.value, OSError)
    assert isinstance(info.value.__cause__, OSError)

    part, make_engine = _mk(small_dataset, 1536, pipeline_depth=1)

    def make():
        eng = make_engine()
        step = eng._step

        def first_launch(packed):
            fk._library()
            return step(packed)

        eng._step = first_launch
        return eng

    reg = get_registry()
    before = (reg.family_total("rtfds_engine_restarts_total") or 0.0,
              reg.counter("rtfds_crash_loops_total").value)
    dlq = DeadLetterSink(str(tmp_path / "dlq.jsonl"))
    try:
        with pytest.raises(RuntimeError) as info:
            run_with_recovery(
                make, ReplaySource(part, EPOCH0, batch_rows=256),
                Checkpointer(str(tmp_path / "ck")), max_restarts=5,
                crash_loop_k=1, dead_letter=dlq)
    finally:
        fk._library.cache_clear()
    assert isinstance(info.value.__cause__, OSError)
    assert (reg.family_total("rtfds_engine_restarts_total") or 0.0,
            reg.counter("rtfds_crash_loops_total").value) == before
    assert len(dlq) == 0 and dlq.read_all() == []


def _jax_logreg_engine():
    from real_time_fraud_detection_system_tpu.config import Config as JConfig
    from real_time_fraud_detection_system_tpu.config import (
        FeatureConfig as JFeatureConfig,
    )
    from real_time_fraud_detection_system_tpu.config import (
        RuntimeConfig as JRuntimeConfig,
    )
    from real_time_fraud_detection_system_tpu.runtime import (
        ScoringEngine as JScoringEngine,
    )

    jcfg = JConfig(
        features=JFeatureConfig(customer_capacity=256, terminal_capacity=512,
                                cms_width=1 << 10),
        runtime=JRuntimeConfig(checkpoint_every_batches=2,
                               batch_buckets=(256,), max_batch_rows=256))
    return JScoringEngine(jcfg, "logreg", init_logreg(15),
                          JScaler(jnp.zeros(15, jnp.float32),
                                  jnp.ones(15, jnp.float32)))


@pytest.mark.parametrize("stall_timeout_s", [0.0, 30.0],
                         ids=["unwatched", "watched"])
def test_supervised_max_batches_counts_the_lifetime_as_jax(
        tmp_path, small_dataset, stall_timeout_s):
    """``run_with_recovery(max_batches=N)`` stops at the engine's N-th
    batch, restored batches included, as the JAX supervisor does, with
    and without the watchdog's thread: a crash after the checkpoint at 2
    replays up to 5 (not 2 + 5); a resumed session with 7 goes on to 7;
    one with 4, below the restored 7, serves nothing. Both packages report
    the same batches, rows and restarts and write the same ``batch_index``
    lineage and Parquet."""
    from real_time_fraud_detection_system_tpu.io import (
        Checkpointer as JCheckpointer,
    )
    from real_time_fraud_detection_system_tpu.io import (
        ParquetSink as JParquetSink,
    )
    from real_time_fraud_detection_system_tpu.runtime import (
        ReplaySource as JReplaySource,
    )
    from real_time_fraud_detection_system_tpu.runtime.faults import (
        FlakySource as JFlakySource,
    )
    from real_time_fraud_detection_system_tpu.runtime.faults import (
        run_with_recovery as jrun_with_recovery,
    )

    part, make_engine = _mk(small_dataset, 2560)
    jtxs = small_dataset[3].slice(slice(0, 2560))
    pkgs = {
        "jax": (_jax_logreg_engine, JReplaySource, JFlakySource,
                JCheckpointer, JParquetSink, jrun_with_recovery, jtxs),
        "port": (make_engine, ReplaySource, FlakySource, Checkpointer,
                 ParquetSink, run_with_recovery, part),
    }
    seen = {}
    for pkg, (make, replay, flaky, ckpt, sink, supervise, txs) in \
            pkgs.items():
        seen[pkg] = []
        for max_batches, fail_at in ((5, (3,)), (7, ()), (4, ())):
            st = supervise(
                make, flaky(replay(txs, EPOCH0, batch_rows=256),
                            fail_at=fail_at),
                ckpt(str(tmp_path / pkg / "ck")),
                sink=sink(str(tmp_path / pkg / "out")), max_restarts=2,
                max_batches=max_batches, stall_timeout_s=stall_timeout_s)
            seen[pkg].append((st["batches"], st["rows"], st["restarts"]))
    assert seen["port"] == seen["jax"] == [(5, 1280, 1), (7, 1792, 0),
                                           (7, 1792, 0)]
    lineage = {pkg: sorted(_by_index(str(tmp_path / pkg / "out")))
               for pkg in pkgs}
    assert lineage["port"] == lineage["jax"] == list(range(1, 8))
    _assert_same_parquet(tmp_path / "port" / "out", tmp_path / "jax" / "out")


@pytest.mark.parametrize("supervised", [False, True],
                         ids=["unsupervised", "supervised"])
def test_score_max_batches_counts_the_lifetime_as_the_jax_score(
        cli_files, capsys, tmp_path, supervised):
    """``score --max-batches`` on a resumed run counts the restored
    batches, as the JAX score does: a supervised session stops after
    batch 1, and the resumed one with ``--max-batches 2``, supervised or
    not, serves batch 2 alone."""
    d = cli_files.dir
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), "--batch-rows", "1024"]
    stats = {}
    for pkg in ("jax", "port"):
        ck, out = str(tmp_path / f"{pkg}-ck"), str(tmp_path / f"{pkg}-out")
        rc, _ = _score(pkg, [*common, "--checkpoint-dir", ck, "--out", out,
                             "--max-restarts", "1", "--max-batches", "1"],
                       capsys)
        assert rc == 0
        rc, stats[pkg] = _score(pkg, [
            *common, "--checkpoint-dir", ck, "--out", out, "--resume",
            "--max-batches", "2",
            *(["--max-restarts", "1"] if supervised else [])], capsys)
        assert rc == 0
    for key in ("rows", "batches"):
        assert stats["port"][key] == stats["jax"][key], key
    assert sorted(_by_index(str(tmp_path / "port-out"))) == sorted(
        _by_index(str(tmp_path / "jax-out"))) == [1, 2]
    _assert_same_parquet(tmp_path / "port-out", tmp_path / "jax-out")

def test_retries_keep_the_error_type():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("down")
        return "ok"

    sleeps = []
    assert with_retries(flaky, RetryPolicy(max_attempts=3, base_delay_s=0.5,
                                           multiplier=2.0),
                        retry_on=(ConnectionError,),
                        sleep=sleeps.append) == "ok"
    assert sleeps == [0.5, 1.0]
    with pytest.raises(KeyError):
        with_retries(lambda: {}["missing"], retry_on=(ConnectionError,))
    with pytest.raises(ValueError):
        RetryPolicy(jitter=2.0)


def test_poison_row_error_is_transient_and_engine_exports_it():
    from real_time_fraud_detection_system_tpu_torch.runtime import faults

    assert PoisonRowError is faults.PoisonRowError
    assert issubclass(PoisonRowError, TransientError)
    assert issubclass(TransientError, RuntimeError)


def test_envelope_injectors_round_trip():
    from real_time_fraud_detection_system_tpu_torch.core.envelope import (
        decode_transaction_envelopes_fast,
        encode_transaction_envelopes,
    )

    n = 40
    msgs = encode_transaction_envelopes(
        np.arange(n), np.full(n, EPOCH0 * 10 ** 6), np.arange(n) % 7,
        np.arange(n) % 5, np.arange(n) * 100 + 5)
    poisoned = poison_messages(msgs, poison_at=(3, 9))
    cols, invalid = decode_transaction_envelopes_fast(poisoned)
    assert not invalid.any()
    assert (cols["tx_amount_cents"] < 0).tolist() == [
        i in (3, 9) for i in range(n)]
    cut = corrupt_messages(msgs, corrupt_every=10)
    _, invalid = decode_transaction_envelopes_fast(cut)
    assert invalid.tolist() == [i % 10 == 9 for i in range(n)]


def test_dead_letter_sinks_are_idempotent(tmp_path):
    cols = {"tx_id": np.array([5, 6, 7]),
            "tx_amount_cents": np.array([-1, -2, -3])}
    for path in (str(tmp_path / "dlq.jsonl"), str(tmp_path / "dlq")):
        dlq = make_dead_letter_sink(path)
        assert isinstance(dlq, DeadLetterSink if path.endswith(".jsonl")
                          else ParquetDeadLetterSink)
        assert dlq.put_rows(cols, reason="crash", error="bad",
                            batch_index=3) == 3
        assert dlq.put_rows(cols, reason="crash", error="bad",
                            batch_index=3) == 0
        dlq.close()
        again = make_dead_letter_sink(path)
        assert again.tx_ids() == [5, 6, 7] and len(again) == 3
        recs = read_dead_letter(path)
        assert [r["tx_id"] for r in recs] == [5, 6, 7]
        assert recs[0]["columns"]["tx_amount_cents"] == -1
        # the JAX package reads the port's queue
        assert [r["tx_id"] for r in jread_dead_letter(path)] == [5, 6, 7]
        again.close()
    with pytest.raises(FileNotFoundError):
        read_dead_letter(str(tmp_path / "none"))


def test_store_urls(tmp_path):
    assert isinstance(make_store(f"file://{tmp_path}/s"), LocalStore)
    with pytest.raises(NotImplementedError, match="A9"):
        make_store("s3://bucket/prefix")


# -- the score CLI against the JAX score ------------------------------------


@pytest.fixture(scope="module")
def cli_files(small_dataset, tmp_path_factory):
    """A 3,000-row table, the same with three poisoned rows (negative
    amounts), and a forest artifact, written by the JAX package."""
    d = tmp_path_factory.mktemp("score")
    jtxs = small_dataset[3].slice(slice(0, 3000))
    jsave_transactions(str(d / "txs.npz"), jtxs)
    bad = jtxs.slice(slice(None))
    bad.amount_cents = np.array(bad.amount_cents, copy=True)
    poison = [1500, 1501, 2200]
    bad.amount_cents[poison] = -bad.amount_cents[poison] - 1
    jsave_transactions(str(d / "poisoned.npz"), bad)
    rng = np.random.default_rng(3)
    model = JTrainedModel(
        kind="forest",
        scaler=JScaler(jnp.asarray(rng.normal(3, 1, 15).astype(np.float32)),
                       jnp.asarray(rng.uniform(0.5, 3, 15)
                                   .astype(np.float32))),
        params=jforest.synthetic_ensemble(10, 5, 15, seed=3))
    with open(d / "forest.npz", "wb") as f:
        f.write(jdump_model_bytes(model))
    return SimpleNamespace(dir=d, poison_ids=sorted(
        int(jtxs.tx_id[i]) for i in poison))


def _score(pkg: str, args: list, capsys) -> tuple:
    if pkg == "jax":
        rc = jcli_main(["score", *args])
    else:
        rc = tcli.main(["score", "--device", "cpu", *args])
    out = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(out[-1]) if rc == 0 else out)


def _assert_same_parquet(tdir, jdir):
    tout = ParquetSink(str(tdir)).read_all()
    jout = ParquetSink(str(jdir)).read_all()
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], atol=1e-6)
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col], rtol=1e-6)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


@pytest.mark.parametrize("resume_from", ["own", "other"])
def test_score_resume_matches_the_jax_score(cli_files, capsys, tmp_path,
                                            resume_from):
    """``--checkpoint-dir``/``--max-restarts`` over two batches, then
    ``--resume`` to the end — each package from its own checkpoints, or
    from the other package's — writes the Parquet of the JAX score."""
    d = cli_files.dir
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), "--batch-rows", "1024",
              "--max-restarts", "1"]
    stats = {}
    for pkg in ("jax", "port"):
        rc, st = _score(pkg, [*common, "--checkpoint-dir",
                              str(tmp_path / f"{pkg}-ck"), "--out",
                              str(tmp_path / f"{pkg}-out"),
                              "--max-batches", "2"], capsys)
        assert rc == 0 and st["batches"] == 2 and st["restarts"] == 0
    for pkg in ("jax", "port"):
        src = pkg if resume_from == "own" else (
            "port" if pkg == "jax" else "jax")
        rc, stats[pkg] = _score(pkg, [*common, "--checkpoint-dir",
                                      str(tmp_path / f"{src}-ck"),
                                      "--out", str(tmp_path / f"{pkg}-out"),
                                      "--resume"], capsys)
        assert rc == 0
    assert stats["port"]["rows"] == stats["jax"]["rows"] == 3000
    assert stats["port"]["batches"] == stats["jax"]["batches"] == 3
    _assert_same_parquet(tmp_path / "port-out", tmp_path / "jax-out")


def test_score_supervised_quarantines_what_the_jax_score_does(
        cli_files, capsys, tmp_path):
    """A table with three poisoned rows under ``--max-restarts``,
    ``--dead-letter`` and ``--crash-loop-k 2``: both packages quarantine
    exactly those rows and write the same Parquet."""
    d = cli_files.dir
    stats = {}
    for pkg in ("jax", "port"):
        rc, stats[pkg] = _score(pkg, [
            "--data", str(d / "poisoned.npz"), "--model-file",
            str(d / "forest.npz"), "--batch-rows", "1024",
            "--checkpoint-dir", str(tmp_path / f"{pkg}-ck"),
            "--max-restarts", "3", "--crash-loop-k", "2",
            "--dead-letter", str(tmp_path / f"{pkg}-dlq.jsonl"),
            "--out", str(tmp_path / f"{pkg}-out")], capsys)
        assert rc == 0
    for key in ("rows", "batches", "restarts", "dead_letter_rows"):
        assert stats["port"][key] == stats["jax"][key], key
    assert stats["port"]["rows"] == 3000 - 3
    assert stats["port"]["dead_letter_rows"] == 3
    for pkg in ("jax", "port"):
        recs = read_dead_letter(str(tmp_path / f"{pkg}-dlq.jsonl"))
        assert [r["tx_id"] for r in recs] == cli_files.poison_ids
        assert all("PoisonRowError" in r["error"] for r in recs)
    _assert_same_parquet(tmp_path / "port-out", tmp_path / "jax-out")


@pytest.mark.parametrize("flags", [
    ["--crash-loop-k", "0"],
    ["--restart-backoff-ms", "-1"],
    ["--checkpoint-full-every", "0"],
    ["--checkpoint-op-attempts", "0"],
    ["--checkpoint-op-timeout", "-1"],
    ["--max-restarts", "2"],
    ["--stall-timeout", "5"],
    ["--checkpoint-dir", "CK", "--stall-timeout", "5"],
    ["--resume-merge", "old:2:1:grow"],
], ids=["crash-loop-k", "backoff", "full-every", "op-attempts",
        "op-timeout", "restarts-without-dir", "stall-unsupervised",
        "stall-without-restarts", "resume-merge"])
def test_score_refuses_what_the_jax_score_refuses(cli_files, capsys,
                                                  caplog, tmp_path, flags):
    d = cli_files.dir
    flags = [str(tmp_path / "ck") if f == "CK" else f for f in flags]
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), *flags]
    assert _score("jax", common, capsys)[0] == 2
    assert _score("port", common, capsys) == (2, [])
    if flags[0] == "--resume-merge":
        assert "--resume-merge requires --checkpoint-dir" in caplog.text


# -- the cold tier's cells of tests/test_recovery_smoke.py -------------------


def _mk_cold(small_dataset, rows: int, cold_dir: str):
    """An oversubscribed exact hot tier (64 customer slots, 120
    customers): compaction demotes under pressure every batch and the
    returning customers keep promotions in flight."""
    part = _port_txs(small_dataset[3].slice(slice(0, rows)))
    cfg = Config(
        features=FeatureConfig(
            key_mode="exact", customer_capacity=64, terminal_capacity=128,
            cms_width=1 << 10, compact_every=1, cold_store=cold_dir,
            cold_demote_slots=16, cold_highwater=0.5,
            cold_promote_queue=64),
        runtime=RuntimeConfig(checkpoint_every_batches=2,
                              batch_buckets=(256,)))

    def make_engine():
        return ScoringEngine(cfg, "logreg", _LOGREG,
                             Scaler(torch.zeros(15), torch.ones(15)),
                             device="cpu")

    return part, make_engine


def test_cold_crash_mid_promotion_resume_exactly_once(tmp_path,
                                                      small_dataset):
    """A dying incarnation leaves a segment written after its last
    checkpoint and a promotion request that never lands; the resume
    prunes the segment (replay writes its demotions again), fences the
    promoter, survives a second crash mid-replay and completes with a
    gap- and duplicate-free sink and no corruption counted."""
    from real_time_fraud_detection_system_tpu_torch.io.coldstore import (
        ColdStore,
    )

    cold_dir = str(tmp_path / "cold")
    part, make_engine = _mk_cold(small_dataset, 1536, cold_dir)
    d, sink_dir = str(tmp_path / "ck"), str(tmp_path / "analyzed")
    eng = _phase1(make_engine, part, Checkpointer(d), sink_dir,
                  max_batches=4)
    assert eng._cold.keys_count > 0
    lineage = Checkpointer(d).manifest(
        Checkpointer(d).latest())["meta"]["cold_lineage"]
    assert lineage["segments"]
    nb = eng.cfg.features.n_day_buckets
    eng._cold.append("customer", np.array([999_999], np.uint32),
                     np.full((1, nb), 20_000, np.int32),
                     np.ones((1, nb), np.float32),
                     np.ones((1, nb), np.float32),
                     np.zeros((1, nb), np.float32))
    assert eng._cold.flush() is not None
    assert eng._promoter.request("customer", 999_999)  # never lands
    base = _counters()
    stats = run_with_recovery(
        make_engine, FlakySource(ReplaySource(part, EPOCH0, batch_rows=256),
                                 fail_at=(1,)),
        Checkpointer(d), sink=ParquetSink(sink_dir), max_restarts=3)
    after = _counters()
    assert stats["batches"] == 6 and stats["restarts"] == 1
    for r in REASONS + ("fallbacks",):
        assert after[r] == base[r]
    _assert_lineage(sink_dir, part, 6)
    for n in os.listdir(cold_dir):
        if n.startswith("seg-") and n.endswith(".json"):
            with open(os.path.join(cold_dir, n)) as f:
                assert 999_999 not in json.load(f)["keys"].get(
                    "customer", [])
    assert not ColdStore(cold_dir).contains("customer", 999_999)
    eng.fence_cold()


@pytest.mark.parametrize("damage", ["torn-manifest", "byte-flip"])
def test_cold_damage_degrades_honestly(tmp_path, small_dataset, damage):
    """A torn segment manifest is quarantined at open; flipped segment
    bytes are caught at the promotion read and quarantined there. Either
    way the affected keys serve from the sketch, nothing counts as
    checkpoint corruption, and the resumed stream completes gap- and
    duplicate-free."""
    cold_dir = str(tmp_path / "cold")
    part, make_engine = _mk_cold(small_dataset, 1536, cold_dir)
    d, sink_dir = str(tmp_path / "ck"), str(tmp_path / "analyzed")
    eng = _phase1(make_engine, part, Checkpointer(d), sink_dir,
                  max_batches=4)
    eng.fence_cold()
    lineage = Checkpointer(d).manifest(
        Checkpointer(d).latest())["meta"]["cold_lineage"]
    seq = int(lineage["segments"][0]["seq"])
    if damage == "torn-manifest":
        victims = [os.path.join(cold_dir, f"seg-{seq:08d}.json")]
        for f in victims:
            data = open(f, "rb").read()
            with open(f, "wb") as fh:
                fh.write(data[: len(data) // 2])
    else:
        victims = [os.path.join(cold_dir, n) for n in os.listdir(cold_dir)
                   if n.endswith(".npz")]
        assert victims
        for f in victims:
            data = open(f, "rb").read()
            with open(f, "r+b") as fh:
                fh.seek(len(data) // 2)
                fh.write(bytes([data[len(data) // 2] ^ 0xFF]))
    base = _counters()
    stats = _phase2(make_engine, part, Checkpointer(d), sink_dir)
    after = _counters()
    assert stats["batches"] == 6
    for r in REASONS:
        assert after[r] == base[r]
    _assert_lineage(sink_dir, part, 6)
    names = os.listdir(cold_dir)
    assert any(n.startswith("quarantine-seg-") for n in names)
    if damage == "torn-manifest":
        assert f"quarantine-seg-{seq:08d}.json" in names
        assert f"seg-{seq:08d}.npz" not in names


# -- the learning loop under the supervisor ---------------------------------

class _LabelTopic:
    """A feedback topic with a committed position (a Kafka group's
    offset): each incarnation opens a session at the last commit, so
    labels consumed after the last checkpoint are redelivered. A session
    can be scripted to hang in its ``hang_at``-th poll (0-based)."""

    def __init__(self):
        self.msgs: list = []
        self.committed = 0
        self.published: set = set()
        self.release = threading.Event()

    def session(self, hang_at: int = -1):
        topic = self

        class _Session:
            pos = topic.committed
            polls = 0

            def poll_messages(self, max_events):
                if self.polls == hang_at:
                    topic.release.wait(timeout=30.0)
                self.polls += 1
                out = topic.msgs[self.pos:self.pos + max_events]
                self.pos += len(out)
                return out

            def commit(self):
                topic.committed = self.pos

            def close(self):
                pass

        return _Session()


class _DelayedLabels:
    """Publishes the labels of the batch polled 3 polls earlier (each
    transaction once, replays included); in-band labels ride on the even
    batches only, so the in-step SGD and the feedback both run."""

    def __init__(self, inner, part, topic):
        self.inner, self.part, self.topic = inner, part, topic

    def poll_batch(self):
        cols = self.inner.poll_batch()
        if cols is None:
            return None
        k = int(self.inner.offsets[0]) // 256 - 1
        if k >= 3:
            sl = self.part.slice(slice((k - 3) * 256, (k - 2) * 256))
            fresh = ~np.isin(sl.tx_id, list(self.topic.published))
            self.topic.published.update(map(int, sl.tx_id[fresh]))
            self.topic.msgs += encode_feedback_envelopes(
                sl.tx_id[fresh], sl.tx_fraud[fresh])
        if k % 2:
            cols = {c: v for c, v in cols.items() if c != "label"}
        return cols

    @property
    def offsets(self):
        return self.inner.offsets

    def seek(self, offsets):
        self.inner.seek(offsets)


def _learning_session(small_dataset, tmp, inject=None, hang_feedback=-1,
                      stall_timeout_s=0.0):
    """One supervised session with online SGD, the feedback loop, a hot
    reload at lifetime batch 3 and a learning loop (its gate out of
    reach: promotions would depend on the learner thread's timing).
    ``inject`` wraps every incarnation's source."""
    part = _port_txs(small_dataset[3].slice(slice(0, 2560)))
    cfg = dataclasses.replace(
        _cfg(), learn=dataclasses.replace(
            _cfg().learn, promote_min_labels=10 ** 9))
    scaler = Scaler(torch.zeros(15), torch.full((15,), 50.0))
    other = weights.from_numpy(
        jax.tree.map(np.asarray, init_logreg(15, seed=3)), device="cpu")
    registry = make_model_registry(str(tmp / "reg"))
    learner = StreamingLearner("logreg", _LOGREG, scaler, cfg, registry,
                               device="cpu")
    learning = LearningLoop(registry, cfg, "logreg",
                            model=TrainedModel("logreg", scaler, _LOGREG),
                            learner=learner, device="cpu")
    cache = FeatureCache(1 << 14)
    topic = _LabelTopic()
    held: dict = {"engines": [], "loops": []}

    def make_engine():
        eng = ScoringEngine(cfg, "logreg", _LOGREG, scaler, device="cpu",
                            online_lr=0.05, feature_cache=cache)
        held["engines"].append(eng)
        return eng

    def make_source():
        src = _DelayedLabels(ReplaySource(part, EPOCH0, batch_rows=256,
                                          with_labels=True), part, topic)
        return inject(src) if inject is not None else src

    def make_feedback(engine):
        hang = hang_feedback if not held["loops"] else -1
        loop = FeedbackLoop(engine, topic.session(hang_at=hang))
        held["loops"].append(loop)
        return loop

    def make_model_reload():
        def poll():
            eng = held["engines"][-1]
            if eng.state.batches_done == 3:
                return other, None
            return None
        return poll

    out = str(tmp / "out")
    try:
        stats = run_with_recovery(
            make_engine, checkpointer=Checkpointer(str(tmp / "ck")),
            sink=ParquetSink(out), make_source=make_source,
            make_feedback=make_feedback,
            make_model_reload=make_model_reload, learning=learning,
            stall_timeout_s=stall_timeout_s, max_restarts=3)
    finally:
        learning.close()
    return SimpleNamespace(stats=stats, out=_by_index(out), held=held,
                           topic=topic, registry=registry,
                           engine=held["engines"][-1], cache=cache)


def _same_session(a, b):
    assert a.out == b.out
    fa, fb = a.engine.state.feature_state, b.engine.state.feature_state
    for x, y in zip(fa.terminal + fa.customer, fb.terminal + fb.customer):
        assert torch.equal(x, y)
    for x, y in zip(a.engine.state.params, b.engine.state.params):
        assert torch.equal(x, y)
    assert a.engine.state.model_version == b.engine.state.model_version


def test_supervised_learning_crash_equals_the_clean_run(tmp_path,
                                                         small_dataset):
    """Crashes at the first polls after the checkpoints at batches 4 and 8
    have landed (at depth 2 the poll of batch 6, while batch 5 is in
    flight, and of batch 10): the feedback session reopens at the
    committed position, the reloader is rebuilt, the learning loop
    re-attaches, and the sink, the state, the params and the version
    stamp equal the clean session's bit for bit. (A crash between a
    feedback apply and the next checkpoint would not: the shared feature
    cache keeps the dead incarnation's ``labeled`` marks, so the replayed
    labels are skipped — the JAX package's at-least-once contract.)"""
    clean = _learning_session(small_dataset, tmp_path / "clean")
    failed: set = set()

    class _FailBeforeBatch(FlakySource):
        """Fails the first poll of batches 5 and 9 (0-based), in
        whichever incarnation reaches them."""

        def poll_batch(self):
            k = int(self.inner.offsets[0]) // 256
            if k in (5, 9) and k not in failed:
                failed.add(k)
                raise TransientError(f"injected poll failure before {k}")
            return self.inner.poll_batch()

    crashed = _learning_session(small_dataset, tmp_path / "crashed",
                                inject=_FailBeforeBatch)
    assert crashed.stats["restarts"] == 2
    assert clean.stats["batches"] == crashed.stats["batches"] == 10
    _same_session(clean, crashed)
    # the feedback and the reload both happened, and were versioned
    assert float(clean.engine.state.feature_state.terminal.fraud.sum()) > 0
    assert sum(loop.stats["applied"] for loop in crashed.held["loops"]) > 0
    assert clean.engine.state.model_version == 2
    assert clean.registry.meta(2)["source"] == "reload"
    assert crashed.registry.champion_version() == 2
    assert len(crashed.held["loops"]) == 3  # one session per incarnation


def test_a_fenced_incarnation_applies_no_feedback(tmp_path, small_dataset):
    """The first incarnation's feedback session hangs in its poll after
    batch 5 (batch 4 checkpointed): the watchdog abandons it, the next
    incarnation replays batch 5 and applies the labels, and when the
    zombie wakes its apply dies at the fenced shadow scorer and feature
    cache — nothing of it lands — and the session equals the clean run."""
    clean = _learning_session(small_dataset, tmp_path / "clean")
    hung = _learning_session(small_dataset, tmp_path / "hung",
                             hang_feedback=4, stall_timeout_s=1.0)
    zombie = hung.held["loops"][0]
    applied = zombie.stats["applied"]
    labeled = hung.cache._labeled.copy()
    _drain_zombies(hung.topic.release)
    assert hung.stats["restarts"] == 1
    assert zombie.stats["applied"] == applied  # the zombie landed nothing
    np.testing.assert_array_equal(hung.cache._labeled, labeled)
    _same_session(clean, hung)


def test_fences_of_the_learning_plane():
    """A fenced feedback loop, learning loop and reloader refuse an
    abandoned incarnation; the reloader's shared signature is put back
    when its incarnation was abandoned during the poll."""
    from real_time_fraud_detection_system_tpu_torch.runtime import faults

    fence = faults._AbandonFence()
    calls = []

    class _Loop:
        def poll_and_apply(self):
            calls.append(1)
            return 1

    g = faults._FenceGuard(_Loop(), fence)
    assert g.poll_and_apply() == 1
    sig = {"sig": "old"}

    def poll():
        sig["sig"] = "new"
        fence.abandoned = True  # abandoned while the poll ran
        return ("params", None)

    poll.sig_state = sig
    fenced = faults._fence_model_reload(poll, fence)
    with pytest.raises(faults.StallError):
        fenced()
    assert sig["sig"] == "old"
    with pytest.raises(faults.StallError):
        g.poll_and_apply()
    assert calls == [1]
