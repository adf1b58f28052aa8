"""Port parity: the dispatch inventory and ``precompile`` against the JAX
engine's, and what the precompiled step must leave alone on the CPU.

``dispatch_inventory()`` lists the JAX engine's keys, variants, buckets,
z modes and emission facts for the same config (direct forest, logreg,
the tiered store with compaction and with a cold tier, the sequence
kind); ``precompile()`` returns the JAX manifest's buckets and variants
(idempotent in both) and, on the CPU, captures nothing and changes no
state. The captures themselves run on the card
(``tests/test_torch_gpu.py``, ``chip_smoke.py`` phase ``precompile``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    OverloadConfig as JOverloadConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    OverloadConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble,
)
from real_time_fraud_detection_system_tpu_torch.ops.forest_kernels import (
    to_kernel_tables,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)
from test_torch_online_sgd import (  # pytest adds tests/
    START,
    configs,
    logreg_pair,
    port_txs,
)

torch.set_num_threads(1)

EXTRA_FIELDS = ("precompile", "autobatch", "latency_slo_ms", "emit_dtype",
                "emit_threshold", "emit_cap_fraction", "nan_guard")


def test_serving_extras_config_matches_the_jax_defaults_and_checks():
    t, j = RuntimeConfig(), JRuntimeConfig()
    for name in EXTRA_FIELDS:
        assert getattr(t, name) == getattr(j, name), name
    for f in dataclasses.fields(OverloadConfig):
        assert getattr(t.overload, f.name) == getattr(j.overload, f.name), \
            f.name
    assert {f.name for f in dataclasses.fields(OverloadConfig)} <= \
        {f.name for f in dataclasses.fields(JOverloadConfig)}
    for bad in (dict(descend_pressure=1.0), dict(climb_pressure=0.5),
                dict(climb_dwell_batches=0), dict(descend_dwell_batches=0),
                dict(max_deferred_batches=0)):
        with pytest.raises(ValueError) as jerr:
            JOverloadConfig(**bad)
        with pytest.raises(ValueError) as terr:
            OverloadConfig(**bad)
        assert str(terr.value) == str(jerr.value), bad


def _forest_pair(seed=3):
    f = jforest.synthetic_ensemble(6, 4, 15, seed=seed)
    return f, weights.from_numpy(jax.tree.map(np.asarray, f), "cpu")


def _engines(case: str, tmp_path):
    """(JAX engine, port engine) of one inventory case."""
    buckets = (64, 256)
    features = {}
    if case.startswith("exact"):
        features = dict(key_mode="exact", compact_every=4)
        if case == "exact-cold":
            features.update(cold_store=str(tmp_path / "cold"),
                            cold_demote_slots=8)
    jcfg, tcfg = configs(buckets=buckets, **features)
    if case == "forest-selective":
        jcfg = jcfg.replace(runtime=dataclasses.replace(
            jcfg.runtime, emit_threshold=0.5))
        tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
            tcfg.runtime, emit_threshold=0.5))
    jp, js, tp, ts = logreg_pair()
    kind = "logreg"
    if case.startswith("forest") or case.startswith("exact"):
        kind = "forest"
        jp, tp = _forest_pair()
    elif case == "sequence":
        kind = "sequence"
        jp = jseq.init_transformer(d_model=16, n_heads=2, n_layers=1,
                                   d_ff=32, seed=1)
        tp = weights.from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    if case == "exact-cold":
        # each package keeps its own cold store
        jcfg = jcfg.replace(features=dataclasses.replace(
            jcfg.features, cold_store=str(tmp_path / "jcold")))
    jeng = JScoringEngine(jcfg, kind=kind, params=jp, scaler=js,
                          metrics=JMetricsRegistry())
    teng = ScoringEngine(tcfg, kind, tp, ts, device="cpu",
                         metrics=MetricsRegistry())
    return jeng, teng


CASES = ["forest-direct", "forest-selective", "logreg", "exact-compact",
         "exact-cold", "sequence"]


@pytest.mark.parametrize("case", CASES)
def test_inventory_and_precompile_manifest_match_jax(case, tmp_path):
    jeng, teng = _engines(case, tmp_path)
    try:
        jinv, tinv = jeng.dispatch_inventory(), teng.dispatch_inventory()
        for field in ("key", "variant", "kind", "z_mode", "bucket",
                      "selective", "emit_dtype"):
            assert [getattr(s, field) for s in tinv] == \
                [getattr(s, field) for s in jinv], field
        jman, tman = jeng.precompile(), teng.precompile()
        assert tman["buckets"] == jman["buckets"]
        assert tman["variants"] == jman["variants"]
        # the CPU captures nothing
        assert tman["graphs"] == 0 and tman["pool_bytes"] == 0
        # idempotent in both: a second call does nothing
        assert teng.precompile()["buckets"] == \
            jeng.precompile()["buckets"] == []
    finally:
        for eng in (jeng, teng):
            if eng._promoter is not None:
                eng._promoter.close()


def _tensors(obj) -> list:
    return [t.clone() for t in tree.leaves(obj)
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("case", ["forest-direct", "logreg-sgd",
                                  "exact-compact", "sequence"])
def test_precompile_on_the_cpu_changes_no_state(case, small_dataset,
                                                tmp_path):
    _, teng = _engines(case.replace("-sgd", ""), tmp_path)
    if case == "logreg-sgd":
        teng.online_lr = 0.05
    txs = port_txs(small_dataset[3].slice(slice(0, 600)))
    teng.run(ReplaySource(txs, START, batch_rows=200, with_labels=True))
    before = (_tensors(teng.state.feature_state),
              _tensors(teng.state.params), _tensors(teng.state.scaler))
    counters = (teng.state.batches_done, teng.state.rows_done,
                teng.state.params_epoch, list(teng.state.offsets))
    teng.precompile()
    after = (_tensors(teng.state.feature_state),
             _tensors(teng.state.params), _tensors(teng.state.scaler))
    for xs, ys in zip(before, after):
        assert len(xs) == len(ys)
        for x, y in zip(xs, ys):
            assert torch.equal(x, y)
    assert counters == (teng.state.batches_done, teng.state.rows_done,
                        teng.state.params_epoch, list(teng.state.offsets))


def test_every_dispatch_key_is_in_the_inventory(small_dataset, tmp_path):
    """The keys the engine dispatches under are the inventory's: batches
    of both buckets and the compaction pass, through ``_dispatch_step``
    (the key a graph is captured and replayed under on the card)."""
    _, teng = _engines("exact-compact", tmp_path)
    keys = []
    orig = teng._dispatch_step

    def record(key, fn, *args):
        keys.append(key)
        return orig(key, fn, *args)

    teng._dispatch_step = record
    txs = port_txs(small_dataset[3].slice(slice(0, 1200)))
    teng.precompile()
    teng.run(ReplaySource(txs, START, batch_rows=50))
    teng.run(ReplaySource(txs, START, batch_rows=200))
    inv = {s.key for s in teng.dispatch_inventory()}
    assert set(keys) == inv == {("step", 7, 64), ("step", 7, 256),
                                ("compact",)}


def test_a_same_form_swap_copies_the_kernel_tables_in_place():
    """The graphs read the kernel tables by pointer: a swap to a forest
    of the same form copies the new tables into the old ones; another
    form (a deeper forest) derives new ones."""
    _, tcfg = configs(buckets=(64,))
    _, _, _, ts = logreg_pair()
    eng = ScoringEngine(tcfg, "forest", synthetic_ensemble(
        6, 4, 15, seed=1, device="cpu"), ts, device="cpu")
    old = eng.tables
    nodes_ptr = old.nodes.data_ptr()
    new = synthetic_ensemble(6, 4, 15, seed=2, device="cpu")
    eng.swap_params(new)
    eng._note_params_swap()
    assert eng.tables is old and eng.tables.nodes.data_ptr() == nodes_ptr
    want = to_kernel_tables(eng.state.params, eng.z_mode)
    assert torch.equal(eng.tables.nodes, want.nodes)
    assert torch.equal(eng.tables.depth, want.depth)
    eng.swap_params(synthetic_ensemble(6, 6, 15, seed=2, device="cpu"))
    eng._note_params_swap()
    assert eng.tables is not old
    want = to_kernel_tables(eng.state.params, eng.z_mode)
    assert torch.equal(eng.tables.nodes, want.nodes)


def test_precompile_flag_runs_precompile_before_the_first_poll(
        small_dataset):
    _, tcfg = configs(buckets=(64, 256))
    tcfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, precompile=True))
    _, _, tp, ts = logreg_pair()
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    txs = port_txs(small_dataset[3].slice(slice(0, 300)))
    stats = eng.run(ReplaySource(txs, START, batch_rows=100))
    assert stats["rows"] == 300
    assert eng._precompiled == {("step", 7, 64), ("step", 7, 256)}
    assert eng._graphs == {}
    assert eng.precompile()["buckets"] == []


def test_run_counts_rows_in_the_registry(small_dataset):
    """``rtfds_rows_total``, the JAX engine's series (the overload
    ledger's scored side)."""
    _, tcfg = configs(buckets=(256,))
    _, _, tp, ts = logreg_pair()
    reg = MetricsRegistry()
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu", metrics=reg)
    txs = port_txs(small_dataset[3].slice(slice(0, 500)))
    eng.run(ReplaySource(txs, START, batch_rows=200))
    assert reg.get("rtfds_rows_total").value == 500
    # the CPU samples no device memory
    assert reg.family_total("rtfds_device_memory_bytes") is None


def test_device_memory_gauges_sample_on_a_cadence(monkeypatch):
    """A sample builds the allocator's whole statistics dict, so the
    loop takes one at the first batch and every ``EVERY``-th after it.
    The allocator is stubbed: nothing here touches a card."""
    from real_time_fraud_detection_system_tpu_torch.utils.graph_telemetry \
        import DeviceMemoryTelemetry

    calls = []

    def stats(device):
        calls.append(device)
        n = len(calls)
        return {"allocated_bytes": {"all": {"current": 100 * n,
                                            "peak": 1000 * n}}}

    monkeypatch.setattr(torch.cuda, "memory_stats_as_nested_dict", stats)
    reg = MetricsRegistry()
    mem = DeviceMemoryTelemetry(torch.device("cuda", 0), reg)
    for _ in range(2 * mem.EVERY + 1):
        mem.tick()
    # batches 1, EVERY + 1 and 2 * EVERY + 1
    assert mem.samples == len(calls) == 3
    got = {k: reg.get("rtfds_device_memory_bytes", device="0",
                      kind=k).value for k in ("in_use", "peak")}
    assert got == {"in_use": 300.0, "peak": 3000.0}

