"""Port parity: the host cold tier (``io/coldstore.py``, the engine's
demotion and promotion) and the exact path's ``score`` against the JAX
package (``tests/test_cold_store.py``'s cases).

- **The files.** A store written by either package opens in the other
  and serves the same rows; a checkpoint that carries a cold lineage
  moves across the packages in both directions, and the restore prunes
  the segments written after it.
- **The store's contracts.** Append, flush and reopen from manifests
  alone; newest wins; a byte flip quarantines the segment; a torn
  manifest and an orphan blob are cleaned up on open; promoted segments
  go at ``gc``; the promoter's queue is bounded and a corrupt segment is
  isolated per key; a fenced handle refuses writes.
- **The engine.** Demote → miss (served from the sketch, counted) →
  promote → the next touch equals a never-evicted control bit for bit
  (whole-dollar amounts), and equals the JAX engine on the same stream.
- **The CLI.** ``score --key-mode exact`` with compaction and a cold store
  writes the Parquet of the JAX ``score``, column by column.

Tolerances: rows, keys, lineage and features bit for bit (the streams are
whole-dollar); probabilities within ``atol=1e-6`` (a dot or tree sum in
another order), customer averages of non-whole-dollar data within
``rtol=1e-6``.
"""

import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io import coldstore as jcold
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io import coldstore as tcold
from real_time_fraud_detection_system_tpu_torch.io.sink import ParquetSink
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime import faults
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

torch.set_num_threads(1)

DAY0 = 20200
NB = 4  # day buckets of the unit-level rows
ATOL_PROB = 1e-6
RTOL_SUM_ORDER = 1e-6


def _rows(seed: int, n: int):
    r = np.random.default_rng(seed)
    return (r.integers(0, 100, (n, NB)).astype(np.int32),
            r.random((n, NB), dtype=np.float32),
            r.random((n, NB), dtype=np.float32),
            r.random((n, NB), dtype=np.float32))


def _assert_rows(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in got:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# -- the files, both ways ----------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_written_by_either_package_opens_in_the_other(tmp_path,
                                                              writer):
    """Two flushed segments and a re-demotion (newest wins), written by
    one package, reopened by the other from manifests alone: the same
    keys, rows, lineage and bytes; then the reader appends a segment and
    the writer's package reopens that too."""
    d = str(tmp_path / "cold")
    w, r = (jcold, tcold) if writer == "jax" else (tcold, jcold)
    cs = w.ColdStore(d)
    cs.append("customer", [10, 20, 30], *_rows(0, 3))
    cs.append("terminal", np.array([7, 0xFFFFFFFF, 8], np.uint32),
              *_rows(1, 3))
    cs.flush()
    cs.append("customer", [20], *_rows(2, 1))
    cs.flush()
    other = r.ColdStore(d)
    assert other.keys_count == cs.keys_count == 5
    assert other.lineage() == cs.lineage()
    assert other.bytes == cs.bytes
    for table, keys in (("customer", [10, 20, 30, 99]),
                        ("terminal", [7, 8])):
        _assert_rows(other.get_rows(table, keys), cs.get_rows(table, keys))
        np.testing.assert_array_equal(other.index_snapshot(table),
                                      cs.index_snapshot(table))
    other.append("terminal", [9], *_rows(3, 1))
    assert other.flush() == 2
    again = w.ColdStore(d)
    _assert_rows(again.get_rows("terminal", [9]),
                 other.get_rows("terminal", [9]))
    with open(os.path.join(d, "seg-00000002.json")) as f:
        man = json.load(f)
    assert set(man) == {"format", "seq", "blob", "crc", "bytes", "keys"}


# -- the store's contracts ---------------------------------------------------


def test_store_append_flush_reopen(tmp_path):
    d = str(tmp_path / "cold")
    cs = tcold.ColdStore(d, segment_mb=4.0)
    bd, cnt, amt, frd = _rows(0, 3)
    assert cs.append("customer", [10, 20, 30], bd, cnt, amt, frd) == 3
    got = cs.get_rows("customer", [20, 999])
    assert set(got) == {20}
    np.testing.assert_array_equal(got[20][0], bd[1])
    assert cs.flush() == 0 and cs.flush() is None
    bd2 = _rows(2, 1)
    cs.append("customer", [20], *bd2)
    cs.flush()
    cs2 = tcold.ColdStore(d)
    assert cs2.keys_count == 3
    np.testing.assert_array_equal(cs2.get_rows("customer", [20])[20][0],
                                  bd2[0][0])
    assert [s["seq"] for s in cs2.lineage()["segments"]] == [0, 1]
    # a small segment threshold flushes on append
    small = tcold.ColdStore(str(tmp_path / "small"), segment_mb=1e-6)
    small.append("customer", [1], *_rows(4, 1))
    assert small.lineage()["segments"]


def test_store_mark_promoted_then_gc(tmp_path):
    d = str(tmp_path / "cold")
    cs = tcold.ColdStore(d)
    keys = np.array([5, 0xFFFFFFFF, 6], np.uint32)
    assert cs.append("customer", keys, *_rows(3, 3)) == 2
    cs.flush()
    cs.append("terminal", [9], *_rows(4, 1))
    cs.flush()
    cs.mark_promoted("customer", [5, 6])
    assert [s["seq"] for s in cs.lineage()["segments"]] == [1]
    assert cs.gc() == [0]
    names = os.listdir(d)
    assert "seg-00000000.npz" not in names
    assert cs.keys_count == 1 and cs.contains("terminal", 9)


def test_store_byte_flip_quarantines(tmp_path):
    d = str(tmp_path / "cold")
    cs = tcold.ColdStore(d)
    cs.append("customer", [1, 2], *_rows(5, 2))
    cs.flush()
    blob = os.path.join(d, "seg-00000000.npz")
    data = open(blob, "rb").read()
    with open(blob, "r+b") as fh:
        fh.seek(len(data) // 2)
        fh.write(bytes([data[len(data) // 2] ^ 0xFF]))
    cs2 = tcold.ColdStore(d)
    assert cs2.keys_count == 2
    with pytest.raises(tcold.ColdStoreCorruptError):
        cs2.get_rows("customer", [1])
    assert cs2.keys_count == 0
    names = os.listdir(d)
    assert "quarantine-seg-00000000.npz" in names
    assert "quarantine-seg-00000000.json" in names
    assert cs2.get_rows("customer", [1]) == {}


def test_store_torn_manifest_and_orphan_blob(tmp_path):
    d = str(tmp_path / "cold")
    cs = tcold.ColdStore(d)
    cs.append("customer", [1], *_rows(6, 1))
    cs.flush()
    cs.append("terminal", [2], *_rows(7, 1))
    cs.flush()
    man = os.path.join(d, "seg-00000001.json")
    data = open(man, "rb").read()
    with open(man, "wb") as fh:
        fh.write(data[: len(data) // 2])
    with open(os.path.join(d, "seg-00000063.npz"), "wb") as fh:
        fh.write(b"orphan blob, manifest never committed")
    cs2 = tcold.ColdStore(d)
    assert cs2.keys_count == 1 and cs2.contains("customer", 1)
    names = os.listdir(d)
    assert "quarantine-seg-00000001.json" in names
    assert "seg-00000001.npz" not in names
    assert "seg-00000063.npz" not in names
    assert 1 in cs2.get_rows("customer", [1])


def test_promoter_poison_isolation_and_bounded_queue(tmp_path):
    d = str(tmp_path / "cold")
    cs = tcold.ColdStore(d)
    cs.append("customer", [11], *_rows(8, 1))
    cs.append("customer", [12], *_rows(9, 1))
    cs.flush()
    cs.append("customer", [13], *_rows(10, 1))  # buffered: still served
    blob = os.path.join(d, "seg-00000000.npz")
    with open(blob, "r+b") as fh:
        fh.seek(10)
        fh.write(b"\xff\xff\xff\xff")
    p = tcold.ColdPromoter(cs, depth=4)
    try:
        assert p.request("customer", 11) and p.request("customer", 13)
        ready = []
        t0 = time.perf_counter()
        while len(ready) < 2 and time.perf_counter() - t0 < 10.0:
            ready += p.poll_ready()
            time.sleep(0.01)
        got = {k: rows for _, k, rows, _ in ready}
        assert got[11] is None and got[13] is not None
        assert p.corrupt_skipped == 1
        # the generation fence: a reset drops what is in flight
        p.reset()
        assert p.backlog() == 0
    finally:
        p.close()
    p2 = tcold.ColdPromoter(tcold.ColdStore(d), depth=2)
    p2.close()
    assert p2.request("customer", 1) and p2.request("customer", 2)
    assert not p2.request("customer", 3)


def test_a_fenced_store_refuses_writes(tmp_path):
    cs = tcold.ColdStore(str(tmp_path / "cold"))
    cs.append("customer", [1], *_rows(0, 1))
    cs.fence()
    for call in (lambda: cs.append("customer", [2], *_rows(1, 1)),
                 cs.flush, cs.gc, lambda: cs.mark_promoted("customer", [1]),
                 lambda: cs.sync_to(None)):
        with pytest.raises(tcold.ColdStoreFencedError):
            call()
    assert 1 in cs.get_rows("customer", [1])  # reads still serve


# -- the engine ---------------------------------------------------------------


def _cols(cust, term, day):
    cust = np.asarray(cust, np.int64)
    term = np.asarray(term, np.int64)
    n = len(cust)
    us = (day * 86400 + np.arange(n) % 86400).astype(np.int64) * 1_000_000
    return {
        "tx_id": np.arange(n, dtype=np.int64),
        "tx_datetime_us": us,
        "customer_id": cust,
        "terminal_id": term,
        "tx_amount_cents": np.full(n, 1200, np.int64),
        "kafka_ts_ms": us // 1000,
    }


def _cold_fields(tmp_path, sub="cold"):
    return dict(customer_capacity=128, terminal_capacity=128,
                cms_width=1 << 12, key_mode="exact", compact_every=2,
                cold_store=str(tmp_path / sub), cold_demote_slots=16,
                cold_highwater=0.25, cold_promote_queue=64)


def _control_fields(fields):
    return dict(fields, customer_capacity=4096, terminal_capacity=4096,
                cold_store="", compact_every=0)


def _cold_batches():
    """A: early keys demoted under pressure; B: later keys that push
    occupancy past the highwater; then 16 of the demoted A keys return."""
    a = np.arange(0, 48)
    b = np.arange(1000, 1032)
    return a, [
        _cols(a, a + 10000, DAY0),
        _cols(a, a + 10000, DAY0),
        _cols(b, b + 10000, DAY0 + 2),
        _cols(b, b + 10000, DAY0 + 3),
        _cols(b, b + 10000, DAY0 + 4),
        _cols(a[:16], a[:16] + 10000, DAY0 + 5),
    ]


W = np.random.default_rng(9).normal(0, 0.1, 15).astype(np.float32)


def _port_engine(fields, reg=None):
    return ScoringEngine(
        Config(features=FeatureConfig(**fields),
               runtime=RuntimeConfig(batch_buckets=(64,))),
        "logreg", weights.from_numpy(
            {"w": W, "b": np.float32(-0.5)}, device="cpu"),
        Scaler(torch.zeros(15), torch.ones(15)), device="cpu",
        metrics=reg or MetricsRegistry())


def _jax_engine(fields, reg=None):
    return JScoringEngine(
        JConfig(features=JFeatureConfig(**fields),
                runtime=JRuntimeConfig(batch_buckets=(64,),
                                       max_batch_rows=64)),
        kind="logreg",
        params=JLogRegParams(w=jnp.asarray(W), b=jnp.float32(-0.5)),
        scaler=JScaler(jnp.zeros(15, jnp.float32),
                       jnp.ones(15, jnp.float32)),
        metrics=reg or JMetricsRegistry())


class _HeldPromotions:
    """Holds every cold-store read of both packages' promoter threads
    until :meth:`release`, and counts the reads done per store: which
    promotions land in which between-steps pass then depends on the test
    alone, never on how far a promoter thread got under load (the keys a
    pass admits together decide their slots)."""

    def __init__(self, monkeypatch):
        self._open = threading.Event()
        self._lock = threading.Lock()
        self.reads: dict = {}
        for cls in (tcold.ColdStore, jcold.ColdStore):
            monkeypatch.setattr(cls, "get_rows", self._held(cls.get_rows))

    def _held(self, get_rows):
        def read(store, table, keys):
            self._open.wait()
            out = get_rows(store, table, keys)
            with self._lock:
                self.reads[id(store)] = self.reads.get(id(store), 0) + 1
            return out

        return read

    def release(self) -> None:
        self._open.set()

    def wait_resolved(self, promoter, n: int, timeout_s: float = 30.0):
        """Wait until ``promoter`` has read all ``n`` requested keys and
        queued every one as ready (its request queue is then empty, so
        its backlog is the ready queue alone)."""
        t0 = time.perf_counter()
        while not (self.reads.get(id(promoter.store), 0) == n
                   and promoter.backlog() == n):
            assert time.perf_counter() - t0 < timeout_s, (
                self.reads.get(id(promoter.store)), promoter.backlog(), n)
            time.sleep(0.005)


def test_engine_demote_miss_promote_bit_identity(tmp_path, monkeypatch):
    """Demote → miss (served from the sketch, counted degraded) → promote
    → the next touch is bit-identical to a never-evicted control, and to
    the JAX engine's run of the same flow, whose counters it matches.

    Both engines' promoters are held until the batches are done and then
    resolve every requested key before either drains, so both land the
    same keys in the same passes (none between the batches, then full
    passes in request order)."""
    held = _HeldPromotions(monkeypatch)
    fields = _cold_fields(tmp_path)
    reg, jreg = MetricsRegistry(), JMetricsRegistry()
    eng = _port_engine(fields, reg)
    ctrl = _port_engine(_control_fields(fields))
    jeng = _jax_engine(_cold_fields(tmp_path, "jax-cold"), jreg)
    a, batches = _cold_batches()
    try:
        for cols in batches:
            r = eng.process_batch({k: v.copy() for k, v in cols.items()})
            ctrl.process_batch({k: v.copy() for k, v in cols.items()})
            jr = jeng.process_batch({k: v.copy() for k, v in cols.items()})
            np.testing.assert_array_equal(r.features,
                                          np.asarray(jr.features))
            np.testing.assert_allclose(r.probs, np.asarray(jr.probs),
                                       rtol=0, atol=ATOL_PROB)
    finally:
        held.release()
    for name in ("rtfds_feature_cold_demotions_total",
                 "rtfds_feature_cold_keys"):
        assert reg.get(name).value == jreg.get(name).value > 0, name
    assert eng._degraded_keys == jeng._degraded_keys != set()
    held.wait_resolved(eng._promoter, len(eng._degraded_keys))
    held.wait_resolved(jeng._promoter, len(jeng._degraded_keys))
    assert eng.drain_promotions(timeout_s=30.0)
    assert jeng.drain_promotions(timeout_s=30.0)
    assert reg.get("rtfds_feature_cold_promotions_total").value == \
        jreg.get("rtfds_feature_cold_promotions_total").value > 0
    cols = _cols(a[:16], a[:16] + 10000, DAY0 + 5)
    r_e = eng.process_batch({k: v.copy() for k, v in cols.items()})
    r_c = ctrl.process_batch({k: v.copy() for k, v in cols.items()})
    np.testing.assert_array_equal(r_e.features, r_c.features)
    np.testing.assert_array_equal(r_e.probs, r_c.probs)
    for table in ("customer", "terminal"):
        kd = getattr(eng.state.feature_state, f"{table}_dir")
        jkd = getattr(jeng.state.feature_state, f"{table}_dir")
        for name in ("keys", "slots", "free", "free_top"):
            np.testing.assert_array_equal(getattr(kd, name).numpy(),
                                          np.asarray(getattr(jkd, name)))
    eng.fence_cold()
    jeng._promoter.close()


def test_run_reports_degraded_keys_and_flushes_the_lineage(tmp_path):
    fields = _cold_fields(tmp_path)
    eng = _port_engine(fields)

    class Src:
        def __init__(self, batches):
            self.b, self.i = batches, 0

        def poll_batch(self):
            if self.i == len(self.b):
                return None
            self.i += 1
            return self.b[self.i - 1]

        @property
        def offsets(self):
            return [self.i]

        def seek(self, offsets):
            self.i = offsets[0]

    stats = eng.run(Src(_cold_batches()[1]))
    assert stats["exactness_degraded_keys"] > 0
    assert eng.state.cold_lineage == eng._cold.lineage()
    assert eng.state.cold_lineage["segments"]
    assert not eng._cold_pending  # run() drains the promotions
    eng.fence_cold()
    with pytest.raises(tcold.ColdStoreFencedError):
        eng._cold.flush()


def test_supervisor_fences_the_cold_tier_of_an_abandoned_incarnation(
        tmp_path):
    """A stalled incarnation is abandoned: its promoter stops and its
    store handle refuses writes, so the zombie cannot write a segment
    under its successor."""
    eng = _port_engine(_cold_fields(tmp_path))

    class Hang:
        offsets = [0]

        def poll_batch(self):
            time.sleep(1.0)

        def seek(self, offsets):
            pass

    with pytest.raises(faults.StallError):
        faults._run_watched(eng, Hang(), None, None, 0,
                            faults.Heartbeat(timeout_s=0.2))
    with pytest.raises(tcold.ColdStoreFencedError):
        eng._cold.append("customer", [1], *_rows(0, 1))
    assert not eng._promoter._thread


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_cold_lineage_moves_across_the_packages(tmp_path, writer):
    """One package serves the demoting batches, flushes and saves a
    checkpoint with the cold lineage; the other restores it over the same
    store after a crash left a segment written after the save: the
    lineage comes back, the sync prunes that segment, the checkpointed
    segments serve, and the inspect report of either package says ok."""
    fields = _cold_fields(tmp_path)
    a, batches = _cold_batches()
    if writer == "jax":
        src = _jax_engine(fields)
        ck = jckpt.Checkpointer(str(tmp_path / "ck"))
    else:
        src = _port_engine(fields)
        ck = tckpt.Checkpointer(str(tmp_path / "ck"))
    for cols in batches[:5]:
        src.process_batch({k: v.copy() for k, v in cols.items()})
    src._cold.flush()
    lin = src._cold.lineage()
    assert lin["total_keys"] > 0 and lin["segments"]
    src.state.cold_lineage = lin
    path = ck.save(src.state)
    src._promoter.close()
    for pkg in (jckpt, tckpt):
        man = pkg.Checkpointer(str(tmp_path / "ck")).manifest(path)
        assert man["meta"]["cold_lineage"] == lin
        rep = pkg.feature_state_report(man)
        assert rep["cold"]["crc_verdict"] == "ok"
        assert rep["cold"]["total_keys"] == lin["total_keys"]
        assert sum(rep["occupancy_per_shard"]["customer"]) > 0

    dst = _port_engine(fields) if writer == "jax" else _jax_engine(fields)
    nb = 40
    dst._cold.append("customer", np.array([777777], np.uint32),
                     np.full((1, nb), DAY0, np.int32),
                     np.ones((1, nb), np.float32),
                     np.ones((1, nb), np.float32),
                     np.zeros((1, nb), np.float32))
    orphan = dst._cold.flush()
    if writer == "jax":
        assert tckpt.Checkpointer(str(tmp_path / "ck")).restore(
            dst.state) is not None
    else:
        assert jckpt.Checkpointer(str(tmp_path / "ck")).restore(
            dst.state) is not None
    assert dst.state.cold_lineage == lin
    dst._sync_cold_after_restore()
    assert dst._cold.keys_count == lin["total_keys"]
    assert not dst._cold.contains("customer", 777777)
    assert not os.path.exists(
        str(tmp_path / "cold" / f"seg-{orphan:08d}.npz"))
    # the restored directories are the writer's, bit for bit
    for table in ("customer", "terminal"):
        s = getattr(src.state.feature_state, f"{table}_dir")
        t = getattr(dst.state.feature_state, f"{table}_dir")
        for name in ("keys", "slots", "free", "free_top"):
            np.testing.assert_array_equal(np.asarray(getattr(s, name)),
                                          np.asarray(getattr(t, name)))
    dst._promoter.close()


# -- the CLI -----------------------------------------------------------------


@pytest.fixture(scope="module")
def score_files(small_dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("score-exact")
    jsave_transactions(str(d / "txs.npz"), small_dataset[3].slice(
        slice(0, 3000)))
    rng = np.random.default_rng(3)
    model = JTrainedModel(
        kind="forest",
        scaler=JScaler(jnp.asarray(rng.normal(3, 1, 15).astype(np.float32)),
                       jnp.asarray(rng.uniform(0.5, 3, 15)
                                   .astype(np.float32))),
        params=jforest.synthetic_ensemble(10, 5, 15, seed=3))
    with open(d / "forest.npz", "wb") as f:
        f.write(jdump_model_bytes(model))
    return d


@pytest.mark.parametrize("flags", [
    ("--key-mode", "exact"),
    ("--key-mode", "exact", "--state-compact-every", "2",
     "--state-hbm-budget-mb", "256", "--cold-promote-queue", "8",
     "--cold-segment-mb", "1")], ids=["exact", "compact-cold"])
def test_score_key_mode_exact_equals_the_jax_score(score_files, capsys,
                                                   tmp_path, flags):
    d = score_files
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), "--batch-rows", "1024", *flags]
    extra = {}
    if "--state-compact-every" in flags:
        extra = {"j": ["--cold-store", str(tmp_path / "jcold")],
                 "t": ["--cold-store", str(tmp_path / "tcold")]}
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert jcli_main(["score", "--out", str(jdir), *common,
                      *extra.get("j", [])]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out", str(tdir),
                      *common, *extra.get("t", [])]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["rows"] == jstats["rows"] == 3000
    assert tstats["batches"] == jstats["batches"]
    jout = ParquetSink(str(jdir)).read_all()
    tout = ParquetSink(str(tdir)).read_all()
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], rtol=0,
                                       atol=ATOL_PROB)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            assert tout[col].dtype == jout[col].dtype, col
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    if extra:
        assert tstats["exactness_degraded_keys"] == \
            jstats["exactness_degraded_keys"]
