"""Port parity: the adaptive batch controller and the overload ladder,
against the JAX package's.

The controllers are fed the same scripted inputs (batch rows and
latencies; a scripted ``rtfds_source_lag_rows``) and must make the same
decisions after every input: the same target, the same rung, the same
actions in the same order, the same spill and replay. Then an engine run
under a scripted backlog climbs to rung 3, defers, replays and descends
as the JAX engine's run of the same rows does, and its predictions equal
a never-overloaded run's bit for bit (deferral is whole-batch and
ordered) and the JAX engine's within ``ATOL_PROB`` (the logit in another
order).
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    OverloadConfig as JOverloadConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime.autobatch import (
    AutoBatchController as JAutoBatch,
)
from real_time_fraud_detection_system_tpu.runtime.overload import (
    LadderActions as JLadderActions,
)
from real_time_fraud_detection_system_tpu.runtime.overload import (
    OverloadController as JOverloadController,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry,
)
from real_time_fraud_detection_system_tpu_torch.config import (
    OverloadConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    MemorySink,
    read_dead_letter,
)
from real_time_fraud_detection_system_tpu_torch.runtime.autobatch import (
    AutoBatchController,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.overload import (
    LadderActions,
    OverloadController,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder,
    MetricsRegistry,
    set_active_recorder,
)
from test_torch_online_sgd import (  # pytest adds tests/
    FEATURE_SCALE,
    START,
    configs,
    logreg_pair,
    port_txs,
)

torch.set_num_threads(1)

ATOL_PROB = 1e-6
BUCKETS = (256, 1024, 4096)


# -- the adaptive batch controller ------------------------------------------

def _slo_script():
    return ([(256, 0.001)] * 4 + [(1024, 0.002)] * 4 + [(4096, 0.050)] * 4
            + [(1024, 0.008)] * 12 + [(64, 0.5)] + [(4096, 0.001)] * 3)


def _climb(latency):
    """Observations the controller's own target feeds: (rows, latency)
    chosen from the target it reports before each."""
    return lambda target: (target, latency(target))


@pytest.mark.parametrize("slo_ms,script", [
    (10.0, _slo_script()),
    (0.0, _climb(lambda r: 0.005 + r * 1e-6)),
    (0.0, _climb(lambda r: (r / 256.0) ** 2 * 0.001)),
    (5.0, _climb(lambda r: r * 2e-6)),
], ids=["slo-up-down-hold", "throughput-big", "throughput-small",
        "slo-climb"])
def test_autobatch_decisions_equal_the_jax_controller(slo_ms, script):
    tr, jr = MetricsRegistry(), JMetricsRegistry()
    t = AutoBatchController(BUCKETS, latency_slo_ms=slo_ms, decide_every=4,
                            registry=tr)
    j = JAutoBatch(BUCKETS, latency_slo_ms=slo_ms, decide_every=4,
                   registry=jr)
    steps = script if isinstance(script, list) else range(60)
    for i, step in enumerate(steps):
        rows, lat = step if isinstance(script, list) \
            else script(j.target_rows())
        t.observe(rows, lat)
        j.observe(rows, lat)
        assert t.target_rows() == j.target_rows(), i
        if i == 30:
            t.force_max()
            j.force_max()
        if i == 40:
            t.release_force()
            j.release_force()
    assert t.adjustments == j.adjustments
    for d in ("up", "down"):
        assert tr.get("rtfds_autobatch_adjustments_total",
                      direction=d).value == jr.get(
            "rtfds_autobatch_adjustments_total", direction=d).value
    assert tr.get("rtfds_autobatch_target_rows").value == \
        jr.get("rtfds_autobatch_target_rows").value


# -- the ladder ---------------------------------------------------------------

class _Lag:
    value = 0.0


def _scripted(registry_cls):
    class Reg(registry_cls):
        """A registry whose rtfds_source_lag_rows is scripted."""

        def __init__(self):
            super().__init__()
            self.lag = _Lag()

        def get(self, name, **labels):
            if name == "rtfds_source_lag_rows":
                return self.lag
            return super().get(name, **labels)

    return Reg()


def _pair(**overload_kw):
    ok = dict(enabled=True, spill_path="", lag_high_rows=1000,
              climb_dwell_batches=3, descend_dwell_batches=2)
    ok.update(overload_kw)
    calls = {"t": [], "j": []}

    def acts(cls, log):
        return cls(shed_optional=lambda on: log.append(("shed", on)),
                   degrade_emission=lambda on: log.append(("emit", on)),
                   force_max_batch=lambda on: log.append(("batch", on)))

    treg, jreg = _scripted(MetricsRegistry), _scripted(JMetricsRegistry)
    t = OverloadController(RuntimeConfig(overload=OverloadConfig(**ok)),
                           registry=treg,
                           actions=acts(LadderActions, calls["t"]))
    j = JOverloadController(JRuntimeConfig(overload=JOverloadConfig(**ok)),
                            registry=jreg,
                            actions=acts(JLadderActions, calls["j"]))
    return t, j, treg, jreg, calls


LAGS = {
    "climb-and-descend": [5000] * 9 + [100] * 8,
    "dead-band": [5000] * 3 + [800] * 20 + [100] * 3,
    "spike": [5000, 100, 5000, 100, 5000, 5000, 100] * 3,
    "ramp": list(range(0, 6000, 400)) + list(range(6000, 0, -400)),
}


@pytest.mark.parametrize("script", sorted(LAGS))
def test_ladder_decisions_equal_the_jax_controller(script):
    t, j, treg, jreg, calls = _pair()
    cols = {"tx_id": np.arange(4, dtype=np.int64)}
    for i, lag in enumerate(LAGS[script]):
        treg.lag.value = jreg.lag.value = float(lag)
        t.observe_batch(256, 0.01)
        j.observe_batch(256, 0.01)
        assert t.rung == j.rung, i
        assert t.should_defer() == j.should_defer(), i
        if t.should_defer():
            t.defer(cols, [i])
            j.defer(cols, [i])
        assert t.want_replay() == j.want_replay(), i
        while t.want_replay():
            a, b = t.next_replay(), j.next_replay()
            assert (a.seq, a.rows, a.offsets) == (b.seq, b.rows, b.offsets)
            t.note_replayed(a.rows)
            j.note_replayed(b.rows)
        assert t.pending_rows == j.pending_rows, i
    assert calls["t"] == calls["j"]
    for name in ("rtfds_overload_rung", "rtfds_shed_rows_total",
                 "rtfds_shed_replayed_rows_total", "rtfds_shed_pending_rows",
                 "rtfds_overload_pressure"):
        assert treg.get(name).value == jreg.get(name).value, name
    for d in ("climb", "descend"):
        assert treg.get("rtfds_overload_transitions_total",
                        direction=d).value == jreg.get(
            "rtfds_overload_transitions_total", direction=d).value


def test_spill_cap_idle_ticks_and_stream_end_equal_the_jax_controller():
    t, j, treg, jreg, _ = _pair(climb_dwell_batches=1,
                                max_deferred_batches=2)
    cols = {"tx_id": np.arange(4, dtype=np.int64)}
    for c in (t, j):
        c.reg.lag.value = 5000.0
        for _ in range(3):
            c.observe_batch(256, 0.01)
        c.defer(cols, [0])
        c.defer(cols, [1])
    assert t.want_replay() == j.want_replay() is True
    assert t.next_replay().seq == j.next_replay().seq == 0
    for c in (t, j):
        c.note_replayed(4)
        c.reg.lag.value = 0.0
        c.idle_tick()
        c.idle_tick()
    assert t.rung == j.rung
    for c in (t, j):
        c.finish_stream()
    while j.want_replay():
        a, b = t.next_replay(), j.next_replay()
        assert a.seq == b.seq
        t.note_replayed(a.rows)
        j.note_replayed(b.rows)
    assert not t.want_replay()
    assert t.rung == j.rung
    assert t.invariant()["shed_rows"] == j.invariant()["shed_rows"] == 8.0
    assert t.invariant()["replayed_rows"] == 8.0


# -- an engine under a scripted backlog ---------------------------------------

N_ROWS = 6144
POLL = 256
LAG_HIGH = 4000


class _Backlog:
    """A source that publishes its backlog (the rows not polled yet) as
    ``rtfds_source_lag_rows`` and counts what it serves in
    ``rtfds_source_rows_total`` in the engine's registry: the signals a
    live source gives the ladder."""

    def __init__(self, inner, registry, total):
        self.inner = inner
        self.total = total
        self.served = 0
        self._lag = registry.gauge("rtfds_source_lag_rows", "backlog")
        self._rows = registry.counter("rtfds_source_rows_total",
                                      "rows ingested", source="scripted")

    def poll_batch(self):
        cols = self.inner.poll_batch()
        if cols is not None:
            self.served += len(cols["tx_id"])
            self._rows.inc(len(cols["tx_id"]))
        self._lag.set(self.total - self.served)
        return cols

    @property
    def offsets(self):
        return self.inner.offsets


def _ladder_cfgs(tmp_path, enabled):
    ok = dict(enabled=enabled, spill_path=str(tmp_path / "spill"),
              lag_high_rows=LAG_HIGH, climb_dwell_batches=2,
              descend_dwell_batches=2, recorder_sample_every=4)
    jcfg, tcfg = configs(buckets=(POLL,))
    jcfg = jcfg.replace(runtime=dataclasses.replace(
        jcfg.runtime, autobatch=True,
        overload=JOverloadConfig(**dict(
            ok, spill_path=str(tmp_path / "jspill")))))
    tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, autobatch=True, overload=OverloadConfig(**ok)))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def ladder_runs(small_dataset, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ladder")
    jtxs = small_dataset[3].slice(slice(0, N_ROWS))
    jp, js, tp, ts = logreg_pair(scale=FEATURE_SCALE)
    runs = {}
    for name, enabled in (("port", True), ("control", False)):
        _, tcfg = _ladder_cfgs(tmp, enabled)
        reg = MetricsRegistry()
        eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                            metrics=reg)
        rec = FlightRecorder(str(tmp / f"{name}.jsonl"))
        set_active_recorder(rec)
        sink = MemorySink()
        try:
            stats = eng.run(_Backlog(ReplaySource(port_txs(jtxs), START,
                                                  batch_rows=POLL),
                                     reg, N_ROWS), sink)
        finally:
            set_active_recorder(None)
            rec.close()
        runs[name] = (eng, reg, stats, sink)
    jcfg, _ = _ladder_cfgs(tmp, True)
    jreg = JMetricsRegistry()
    jeng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                          metrics=jreg)
    jsink = JMemorySink()
    jeng.run(_Backlog(JReplaySource(jtxs, START, batch_rows=POLL), jreg,
                      N_ROWS), sink=jsink)
    runs["jax"] = (jeng, jreg, None, jsink)
    runs["tmp"] = tmp
    return runs


def _events(path, name):
    return [r for r in map(json.loads, open(path)) if r.get("event") == name]


def test_overloaded_run_climbs_defers_replays_and_descends(ladder_runs):
    eng, reg, stats, sink = ladder_runs["port"]
    tmp = ladder_runs["tmp"]
    climbs = _events(tmp / "port.jsonl", "overload_climb")
    descends = _events(tmp / "port.jsonl", "overload_descend")
    assert [e["rung"] for e in climbs] == [1, 2, 3]
    assert [e["rung"] for e in descends] == [2, 1, 0]
    shed = reg.get("rtfds_shed_rows_total").value
    assert shed > 0 and shed == reg.get(
        "rtfds_shed_replayed_rows_total").value
    # no silent loss: scored + deferred-pending == polled
    assert reg.get("rtfds_shed_pending_rows").value == 0
    assert reg.get("rtfds_rows_total").value == stats["rows"] == N_ROWS
    assert reg.family_total("rtfds_source_rows_total") == N_ROWS
    rows = read_dead_letter(str(tmp / "spill"))
    assert len(rows) == shed and {r["reason"] for r in rows} == {"shed"}
    # every degrade reverted
    assert eng._shed_features is False and eng.shadow_paused is False
    # replay is FIFO: the spill's sequence in order
    replays = _events(tmp / "port.jsonl", "replay")
    assert [e["seq"] for e in replays] == sorted(e["seq"] for e in replays)
    # every row scored exactly once
    assert len(np.unique(sink.concat()["tx_id"])) == N_ROWS


def test_overloaded_run_equals_a_never_overloaded_run(ladder_runs):
    _, _, _, sink = ladder_runs["port"]
    _, _, _, ctrl = ladder_runs["control"]
    a, b = sink.concat(), ctrl.concat()
    oa, ob = np.argsort(a["tx_id"]), np.argsort(b["tx_id"])
    np.testing.assert_array_equal(a["tx_id"][oa], b["tx_id"][ob])
    np.testing.assert_array_equal(a["prediction"][oa], b["prediction"][ob])
    # rung 2's alerts-only batches carry zero windows; the control's
    # count every row at least once
    col = "customer_id_nb_tx_1day_window"
    assert int((b[col] == 0).sum()) == 0
    assert int((a[col] == 0).sum()) > 0


def test_overloaded_run_equals_the_jax_engines(ladder_runs):
    teng, treg, _, tsink = ladder_runs["port"]
    jeng, jreg, _, jsink = ladder_runs["jax"]
    for name in ("rtfds_shed_rows_total", "rtfds_shed_replayed_rows_total",
                 "rtfds_rows_total", "rtfds_overload_rung"):
        assert treg.get(name).value == jreg.get(name).value, name
    for d in ("climb", "descend"):
        assert treg.get("rtfds_overload_transitions_total",
                        direction=d).value == jreg.get(
            "rtfds_overload_transitions_total", direction=d).value
    t, j = tsink.concat(), jsink.concat()
    ot, oj = np.argsort(t["tx_id"]), np.argsort(j["tx_id"])
    np.testing.assert_array_equal(t["tx_id"][ot], j["tx_id"][oj])
    np.testing.assert_allclose(t["prediction"][ot], j["prediction"][oj],
                               rtol=0, atol=ATOL_PROB)
    # the same batches were served alerts-only
    col = "terminal_id_nb_tx_7day_window"
    np.testing.assert_array_equal(t[col][ot] == 0, j[col][oj] == 0)
