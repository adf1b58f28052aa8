"""Port parity: ``runtime/prefetch.py::PrefetchSource`` — the cases of
``tests/test_prefetch.py`` on the port (stream identity, consumed-offset
semantics, the original error type, the sync-mode rewind, the generation
fence, the crash/replay lineage with a poll fault and with an engine
kill, poison isolation under prefetch, the wait series), and a port
engine with prefetch against a JAX engine with prefetch on the same
batches.

Tolerances: batches, offsets, tx ids and lineages bit-identical; the
port's prefetched output bit-identical to its own unprefetched run;
against the JAX package, every id, count and flag bit-identical, amount
averages within ``rtol=1e-6`` (float32 window sums in another order) and
logreg probabilities within ``atol=1e-6`` (the dot in another order),
with identical decisions.
"""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    Config as JConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    DataConfig as JDataConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.runtime import (
    PrefetchSource as JPrefetchSource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    DataConfig,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    Checkpointer,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    DeadLetterSink,
    MemorySink,
    ParquetSink,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    FlakySource,
    PoisonSource,
    TransientError,
    run_with_recovery,
)
from real_time_fraud_detection_system_tpu_torch.runtime.prefetch import (
    PrefetchSource,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
    SyntheticSource,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
    get_registry,
)

torch.set_num_threads(1)

EPOCH0 = 1_743_465_600  # 2025-04-01
RTOL_SUM_ORDER = 1e-6
ATOL_PROB = 1e-6
WAIT_S = 5.0


def _wait_for(pred, timeout=WAIT_S):
    t0 = time.monotonic()
    while not pred():
        if time.monotonic() - t0 > timeout:
            raise AssertionError("condition not reached in time")
        time.sleep(0.01)


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _part(small_dataset, n: int) -> Transactions:
    return _port_txs(small_dataset[3].slice(slice(0, n)))


def _weights():
    rng = np.random.default_rng(11)
    w = rng.normal(0.0, 0.3, 15).astype(np.float32)
    mean = rng.normal(0.0, 1.0, 15).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, 15).astype(np.float32)
    return w, np.float32(-1.0), mean, scale


def _cfgs(every: int = 2):
    """The JAX test's small config, in each package."""
    kw = dict(features=dict(customer_capacity=128, terminal_capacity=256,
                            cms_width=1 << 10),
              runtime=dict(checkpoint_every_batches=every,
                           batch_buckets=(256,), max_batch_rows=256))
    port = Config(data=DataConfig(n_customers=50, n_terminals=100,
                                  n_days=30),
                  features=FeatureConfig(**kw["features"]),
                  runtime=RuntimeConfig(**kw["runtime"]))
    jax_cfg = JConfig(data=JDataConfig(n_customers=50, n_terminals=100,
                                       n_days=30),
                      features=JFeatureConfig(**kw["features"]),
                      runtime=JRuntimeConfig(**kw["runtime"]))
    return port, jax_cfg


def _make_engine(every: int = 2):
    cfg, _ = _cfgs(every)
    w, b, mean, scale = _weights()

    def make():
        return ScoringEngine(
            cfg, "logreg",
            LogRegParams(torch.from_numpy(w), torch.tensor(b)),
            Scaler(torch.from_numpy(mean), torch.from_numpy(scale)),
            device="cpu")

    return make


def _make_jax_engine(every: int = 2):
    _, cfg = _cfgs(every)
    w, b, mean, scale = _weights()

    def make():
        return JScoringEngine(
            cfg, kind="logreg",
            params=JLogRegParams(jnp.asarray(w), jnp.asarray(b)),
            scaler=JScaler(jnp.asarray(mean), jnp.asarray(scale)))

    return make


def _lineage(out_dir: str):
    return sorted(int(f[len("part-"):-len(".parquet")])
                  for f in os.listdir(out_dir)
                  if f.startswith("part-") and f.endswith(".parquet"))


class _ListSource:
    """A fixed list of batches behind the source protocol."""

    def __init__(self, batches):
        self.batches = batches
        self._pos = 0

    def poll_batch(self):
        if self._pos >= len(self.batches):
            return None
        b = self.batches[self._pos]
        self._pos += 1
        return {k: np.array(v, copy=True) for k, v in b.items()}

    @property
    def offsets(self):
        return [self._pos]

    def seek(self, offsets):
        self._pos = int(offsets[0])


def test_prefetch_stream_identical_offsets_trail(small_dataset):
    """Prefetched batches equal synchronous polls byte for byte, and
    ``offsets`` after each consumption equals the synchronous source's —
    never the producer's read-ahead."""
    part = _part(small_dataset, 2048)
    ref = ReplaySource(part, EPOCH0, batch_rows=256)
    reg = MetricsRegistry()
    src = PrefetchSource(ReplaySource(part, EPOCH0, batch_rows=256),
                         max_batches=3, registry=reg)
    try:
        _wait_for(lambda: src._q.qsize() >= 3)
        assert list(src.offsets) == [0]
        n = 0
        while True:
            a, b = ref.poll_batch(), src.poll_batch()
            if a is None:
                assert b is None
                break
            n += 1
            for k in a:
                assert np.array_equal(a[k], b[k]), k
            assert list(src.offsets) == list(ref.offsets)
        assert n == 8
        assert src.poll_batch() is None
        assert reg.get("rtfds_prefetch_queue_depth") is not None
    finally:
        src.close()


def test_prefetch_error_propagates_original_type(small_dataset):
    """A producer-side poll failure is raised on the loop thread with its
    original type; ``seek`` revives the source for the replay."""
    part = _part(small_dataset, 1024)
    src = PrefetchSource(
        FlakySource(ReplaySource(part, EPOCH0, batch_rows=256),
                    fail_at=(2,)),
        max_batches=2)
    try:
        got = []
        with pytest.raises(TransientError):
            for _ in range(10):
                cols = src.poll_batch()
                if cols is None:
                    break
                got.append(cols)
        assert len(got) == 2
        src.seek(src.offsets)
        more = 0
        while src.poll_batch() is not None:
            more += 1
        assert len(got) + more == 4
    finally:
        src.close()


def test_prefetch_set_sync_rewinds_readahead(small_dataset):
    """``set_sync(True)`` drops the queued read-ahead and rewinds the
    inner source to the consumed position: every row once, in order."""
    part = _part(small_dataset, 2048)
    src = PrefetchSource(ReplaySource(part, EPOCH0, batch_rows=256),
                         max_batches=4)
    try:
        _wait_for(lambda: src._q.qsize() >= 4)
        first = src.poll_batch()
        src.set_sync(True)
        assert list(src.inner.offsets) == list(src.offsets)
        seen = [first["tx_id"]]
        while True:
            cols = src.poll_batch()
            if cols is None:
                break
            seen.append(cols["tx_id"])
        ids = np.concatenate(seen)
        assert np.array_equal(ids, np.sort(ids))
        assert len(ids) == 2048 and len(np.unique(ids)) == 2048
        src.set_sync(False)
    finally:
        src.close()


def test_prefetch_seek_fences_the_producer_generation(small_dataset):
    """A ``seek`` while the producer is ahead stops that generation (its
    thread exits, its queue is orphaned) and serves from the sought
    position, as the JAX package's prefetcher does."""
    part = _part(small_dataset, 2048)
    srcs = [cls(ReplaySource(part, EPOCH0, batch_rows=256), max_batches=2)
            if cls is PrefetchSource else
            cls(JReplaySource(small_dataset[3].slice(slice(0, 2048)),
                              EPOCH0, batch_rows=256), max_batches=2)
            for cls in (PrefetchSource, JPrefetchSource)]
    try:
        firsts = []
        for src in srcs:
            _wait_for(lambda: src._q.qsize() >= 2)
            old_thread, old_q = src._thread, src._q
            src.seek([768])
            old_thread.join(timeout=WAIT_S)
            assert not old_thread.is_alive()
            assert src._q is not old_q
            cols = src.poll_batch()
            assert list(src.offsets) == [1024]
            firsts.append(cols["tx_id"])
        assert np.array_equal(firsts[0], firsts[1])
        assert np.array_equal(
            firsts[0], part.tx_id[768:1024])
    finally:
        for src in srcs:
            src.close()


def test_prefetch_commit_uses_consumed_offsets():
    """A broker commit through the prefetcher carries the consumed
    offsets, not the read-ahead."""

    class _Brokerish:
        def __init__(self, batches=8):
            self._n = batches
            self._pos = 0
            self.committed = None

        def poll_batch(self):
            if self._pos >= self._n:
                return None
            self._pos += 1
            return {"tx_id": np.array([self._pos], np.int64)}

        @property
        def offsets(self):
            return [self._pos]

        def seek(self, offsets):
            self._pos = int(offsets[0])

        def commit(self, offsets=None):
            self.committed = (list(offsets) if offsets is not None
                              else [self._pos])

    inner = _Brokerish()
    src = PrefetchSource(inner, max_batches=4)
    try:
        _wait_for(lambda: src._q.qsize() >= 4)
        src.poll_batch()
        src.poll_batch()
        src.commit()
        assert inner.committed == [2]
    finally:
        src.close()


def test_prefetch_crash_replay_exactly_once_poll_fault(small_dataset,
                                                       tmp_path):
    """A producer-side crash mid-stream under prefetch: the supervisor
    seeks the consumed position, the lineage has no gap or duplicate and
    the rows equal a clean unprefetched run's bit for bit."""
    make_engine = _make_engine()
    part = _part(small_dataset, 2048)
    ref = ParquetSink(str(tmp_path / "ref"))
    make_engine().run(ReplaySource(part, EPOCH0, batch_rows=256), sink=ref)
    clean = ref.read_all()

    sink = ParquetSink(str(tmp_path / "out"))
    src = PrefetchSource(
        FlakySource(ReplaySource(part, EPOCH0, batch_rows=256),
                    fail_at=(3, 6)),
        max_batches=3)
    try:
        stats = run_with_recovery(make_engine, src,
                                  Checkpointer(str(tmp_path / "ck")),
                                  sink=sink, max_restarts=5)
    finally:
        src.close()
    # 1 or 2 restarts: the supervisor's first seek fences the first
    # generation, so a fault the producer hit while reading ahead fires
    # into a discarded generation
    assert 1 <= stats["restarts"] <= 2
    assert _lineage(str(tmp_path / "out")) == \
        list(range(1, stats["batches"] + 1))
    out = sink.read_all()
    i1, i2 = np.argsort(out["tx_id"]), np.argsort(clean["tx_id"])
    assert np.array_equal(out["tx_id"][i1], clean["tx_id"][i2])
    assert np.array_equal(out["prediction"][i1], clean["prediction"][i2])


def test_prefetch_crash_replay_exactly_once_engine_kill(small_dataset,
                                                        tmp_path):
    """The engine dies (a sink failure) while the queue holds read-ahead:
    the checkpoint recorded consumed offsets only, so the replay
    re-serves the read-ahead — a contiguous lineage, every row once."""
    make_engine = _make_engine()
    part = _part(small_dataset, 2048)
    ref = MemorySink()
    make_engine().run(ReplaySource(part, EPOCH0, batch_rows=256), sink=ref)
    clean = ref.concat()

    class _KillsOnce(ParquetSink):
        def __init__(self, d):
            super().__init__(d)
            self.fired = False

        def append(self, res):
            if not self.fired and res.batch_index == 4:
                self.fired = True
                raise OSError("injected sink crash at batch 4")
            super().append(res)

    sink = _KillsOnce(str(tmp_path / "out"))
    src = PrefetchSource(ReplaySource(part, EPOCH0, batch_rows=256),
                         max_batches=4)
    try:
        _wait_for(lambda: src._q.qsize() >= 4)
        stats = run_with_recovery(make_engine, src,
                                  Checkpointer(str(tmp_path / "ck")),
                                  sink=sink, max_restarts=3)
    finally:
        src.close()
    assert stats["restarts"] == 1 and stats["rows"] == 2048
    assert _lineage(str(tmp_path / "out")) == \
        list(range(1, stats["batches"] + 1))
    out = sink.read_all()
    assert np.array_equal(np.sort(out["tx_id"]), np.sort(clean["tx_id"]))


def test_prefetch_poison_isolation_runs_unprefetched(small_dataset,
                                                     tmp_path):
    """Poison rows under prefetch: isolation runs synchronously (the
    supervisor's ``set_sync``), quarantines exactly the poison rows and
    flips back; the survivors equal a never-poisoned stream bit for bit."""
    make_engine = _make_engine(every=1)
    part = _part(small_dataset, 1024)
    src_b = ReplaySource(part, EPOCH0, batch_rows=256)
    batches = []
    while (cols := src_b.poll_batch()) is not None:
        batches.append(cols)
    poison_ids = [int(i) for i in batches[2]["tx_id"][10:13]]
    clean_batches = [{k: v[~np.isin(b["tx_id"], poison_ids)]
                      for k, v in b.items()} for b in batches]
    clean_sink = MemorySink()
    make_engine().run(_ListSource(clean_batches), sink=clean_sink)
    clean = clean_sink.concat()

    dlq = DeadLetterSink(str(tmp_path / "dlq.jsonl"))
    sink = MemorySink()
    src = PrefetchSource(
        PoisonSource(_ListSource(batches), poison_tx_ids=poison_ids),
        max_batches=3)
    syncs = []
    set_sync = src.set_sync

    def recorded(flag):
        syncs.append(bool(flag))
        set_sync(flag)

    src.set_sync = recorded
    try:
        stats = run_with_recovery(make_engine, src,
                                  Checkpointer(str(tmp_path / "ck")),
                                  sink=sink, max_restarts=5, crash_loop_k=2,
                                  dead_letter=dlq)
        assert stats["batches"] == len(batches)
        assert syncs == [True, False] and not src._sync
        assert dlq.tx_ids() == sorted(poison_ids)
    finally:
        src.close()
        dlq.close()
    out = sink.concat()
    _, last = np.unique(out["tx_id"][::-1], return_index=True)
    keep = len(out["tx_id"]) - 1 - last
    out = {k: v[keep] for k, v in out.items()}
    a, b = np.argsort(out["tx_id"]), np.argsort(clean["tx_id"])
    np.testing.assert_array_equal(out["tx_id"][a], clean["tx_id"][b])
    np.testing.assert_array_equal(out["prediction"][a],
                                  clean["prediction"][b])


def test_prefetch_wait_metric_counts_blocked_time():
    """A slow producer blocks the consumer; the blocked time lands in
    ``rtfds_prefetch_wait_seconds_total``."""

    class _Slow:
        def __init__(self):
            self._i = 0

        def poll_batch(self):
            if self._i >= 3:
                return None
            time.sleep(0.05)
            self._i += 1
            return {"tx_id": np.array([self._i], np.int64)}

        @property
        def offsets(self):
            return [self._i]

        def seek(self, offsets):
            self._i = int(offsets[0])

    reg = MetricsRegistry()
    src = PrefetchSource(_Slow(), max_batches=2, registry=reg)
    try:
        while src.poll_batch() is not None:
            pass
    finally:
        src.close()
    wait = reg.get("rtfds_prefetch_wait_seconds_total")
    assert wait is not None and wait.value > 0.04
    assert reg.get("rtfds_prefetch_queue_depth").value == 0


def test_synthetic_source_emits_telemetry(small_dataset):
    """``SyntheticSource`` publishes the per-source series under
    ``source="synthetic"``: polls, rows, the lag and seeks."""
    part = _part(small_dataset, 512)
    reg = get_registry()
    src = SyntheticSource(part, EPOCH0, rate_tps=0.0, batch_rows=256)
    polls0 = reg.get("rtfds_source_poll_seconds", source="synthetic")
    n0 = polls0.count if polls0 is not None else 0
    rows0 = reg.get("rtfds_source_rows_total", source="synthetic")
    r0 = rows0.value if rows0 is not None else 0
    rows = 0
    while (cols := src.poll_batch()) is not None:
        rows += len(cols["tx_id"])
    assert rows == 512
    assert reg.get("rtfds_source_poll_seconds",
                   source="synthetic").count == n0 + 3
    assert reg.get("rtfds_source_rows_total",
                   source="synthetic").value == r0 + 512
    assert reg.get("rtfds_source_lag_rows").value == 0
    s0 = reg.get("rtfds_source_seeks_total", source="synthetic").value
    src.seek([0])
    assert reg.get("rtfds_source_seeks_total",
                   source="synthetic").value == s0 + 1


@pytest.mark.parametrize("depth", [1, 3])
def test_port_engine_with_prefetch_matches_the_jax_engine_with_prefetch(
        small_dataset, depth):
    """The same batches through a prefetched port engine and a prefetched
    JAX engine (and the port's own unprefetched run): identical lineage,
    outputs under the stated tolerances, and bit for bit against the
    port's unprefetched run."""
    jtxs = small_dataset[3].slice(slice(0, 2048))
    part = _port_txs(jtxs)
    plain = MemorySink()
    _make_engine()().run(ReplaySource(part, EPOCH0, batch_rows=256), plain)
    tsink, jsink = MemorySink(), JMemorySink()
    src = PrefetchSource(ReplaySource(part, EPOCH0, batch_rows=256),
                         max_batches=depth)
    jsrc = JPrefetchSource(JReplaySource(jtxs, EPOCH0, batch_rows=256),
                           max_batches=depth)
    try:
        tstats = _make_engine()().run(src, tsink)
        jstats = _make_jax_engine()().run(jsrc, jsink)
    finally:
        src.close()
        jsrc.close()
    assert tstats["batches"] == jstats["batches"] == 8
    assert list(src.offsets) == list(jsrc.offsets) == [2048]
    tout, jout, pout = tsink.concat(), jsink.concat(), plain.concat()
    for col in tout:
        if col == "processed_at_us":
            continue
        assert np.array_equal(tout[col], pout[col]), col
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], rtol=0.0,
                                       atol=ATOL_PROB)
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


def test_prefetch_producer_does_no_device_work(small_dataset):
    """The producer thread runs the inner poll only: every poll lands on
    a thread other than the loop's, and the batches it queues are host
    numpy arrays."""
    part = _part(small_dataset, 1024)
    threads = []
    inner = ReplaySource(part, EPOCH0, batch_rows=256)
    poll = inner.poll_batch

    def tagged():
        threads.append(threading.current_thread().name)
        return poll()

    inner.poll_batch = tagged
    src = PrefetchSource(inner, max_batches=2)
    try:
        while (cols := src.poll_batch()) is not None:
            assert all(isinstance(v, np.ndarray) for v in cols.values())
    finally:
        src.close()
    assert threads and threading.current_thread().name not in threads
