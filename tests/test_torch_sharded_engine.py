"""Port parity: the sharded serving engine (``runtime/sharded_engine.py``)
against the JAX package's ``ShardedScoringEngine`` — the JAX mesh of 4
and 8 virtual CPU devices against 4 and 8 shards co-located on the CPU —
and against the port's own single engine, on the same streams.

Tolerances: on whole-dollar streams every state leaf and every feature
column bit for bit (float32 sums of whole dollars are exact in any order;
counts and fraud sums are whole numbers); on cent amounts the amount sums
and averages within ``rtol=1e-6`` (``index_add_`` against XLA's
scatter-add). Probabilities within ``atol=1e-6`` for logreg and the
forest (the dot product and the tree sum in another order: the port's
tree kinds score through the leaf-sum kernel's plain version), and
``rtol=1e-5, atol=1e-6`` for gbt (a sigmoid of such a sum); in-step SGD
params within ``atol=1e-6`` (each step's gradient differs by ulps: the
shards' losses summed in another order, times ``lr``), and the
probabilities served after them within ``atol=2e-5``: those param ulps
reach the logit multiplied by the scaled features, whose whole-dollar
amount column runs to ~1e2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io.checkpoint import (
    Checkpointer as JCheckpointer,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.parallel import mesh as jmesh
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ShardedScoringEngine as JShardedScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    Checkpointer,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels
from real_time_fraud_detection_system_tpu_torch.parallel import mesh as tmesh
from real_time_fraud_detection_system_tpu_torch.runtime.distributed import (
    ProcessTopology,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine import (
    ShardedScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

torch.set_num_threads(1)

CPU = torch.device("cpu")
EPOCH0 = 1_743_465_600
RTOL_SUM_ORDER = 1e-6
TOL_PROB = {"logreg": dict(rtol=0.0, atol=1e-6),
            "forest": dict(rtol=0.0, atol=1e-6),
            "gbt": dict(rtol=1e-5, atol=1e-6),
            "logreg-sgd": dict(rtol=0.0, atol=2e-5)}
FEATURES = dict(customer_capacity=512, terminal_capacity=1024,
                cms_width=1 << 10)


def _whole(txs):
    """The same table with every amount rounded to whole dollars."""
    w = txs.slice(slice(None))
    w.amount_cents = np.round(txs.amount_cents / 100).astype(np.int64) * 100
    return w


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _hot(txs, share=0.4, customer=3):
    """``share`` of the rows moved to one customer: its shard overflows
    and spills into routed chunks."""
    h = txs.slice(slice(None))
    rng = np.random.default_rng(11)
    h.customer_id = np.where(rng.random(txs.n) < share, customer,
                             txs.customer_id).astype(np.int64)
    return h


@pytest.fixture(scope="module")
def stream(small_dataset):
    return _whole(small_dataset[3].slice(slice(0, 3072)))


def _cfgs(max_rows=1024, runtime=None, **features):
    f = dict(FEATURES, **features)
    rt = dict(batch_buckets=(max_rows,), max_batch_rows=max_rows,
              trigger_seconds=0.0, **(runtime or {}))
    return (Config(features=FeatureConfig(**f), runtime=RuntimeConfig(**rt)),
            JConfig(features=JFeatureConfig(**f),
                    runtime=JRuntimeConfig(**rt)))


def _models(kind):
    """(JAX params, JAX scaler, port params, port scaler), seeded."""
    rng = np.random.default_rng(3)
    mean = rng.normal(3, 1, 15).astype(np.float32)
    scale = rng.uniform(0.5, 3, 15).astype(np.float32)
    if kind == "logreg":
        jp = JLogRegParams(
            w=jnp.asarray(rng.normal(0, 0.8, 15).astype(np.float32)),
            b=jnp.float32(-1.0))
    elif kind == "gbt":
        jp = jgbt.synthetic_gbt(8, 4, 15, seed=3)
    else:
        jp = jforest.synthetic_ensemble(10, 5, 15, seed=3)
    js = JScaler(jnp.asarray(mean), jnp.asarray(scale))
    return (jp, js, weights.from_numpy(jax.tree.map(np.asarray, jp), CPU),
            weights.from_numpy(jax.tree.map(np.asarray, js), CPU))


def _assert_state(tfs, jfs, amounts_exact=True):
    jleaves = jax.tree_util.tree_leaves_with_path(jfs)
    tleaves = tree.leaves_with_path(tfs)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, path
        if "amount" in path and not amounts_exact:
            np.testing.assert_allclose(t, j, rtol=RTOL_SUM_ORDER,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(t, j, err_msg=path)


def _assert_outputs(tout, jout, kind, amounts_exact=True):
    """Sink columns of the port against the JAX package's."""
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col],
                                       **TOL_PROB[kind])
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col and not amounts_exact:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


def _serve_both(kind, n_dev, txs, tcfg, jcfg, online_lr=0.0,
                with_labels=False, batch_rows=1024, rows_per_shard=0):
    jp, js, tp, ts = _models(kind)
    jeng = JShardedScoringEngine(jcfg, kind=kind, params=jp, scaler=js,
                                 n_devices=n_dev, online_lr=online_lr,
                                 rows_per_shard=rows_per_shard)
    jsink = JMemorySink()
    jeng.run(JReplaySource(txs, EPOCH0, batch_rows=batch_rows,
                           with_labels=with_labels), sink=jsink)
    teng = ShardedScoringEngine(tcfg, kind, tp, ts, n_devices=n_dev,
                                device="cpu", online_lr=online_lr,
                                rows_per_shard=rows_per_shard)
    tsink = MemorySink()
    stats = teng.run(ReplaySource(_port_txs(txs), EPOCH0,
                                  batch_rows=batch_rows,
                                  with_labels=with_labels), tsink)
    return teng, jeng, tsink.concat(), jsink.concat(), stats


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("kind,online_lr", [
    ("logreg", 0.0), ("logreg", 0.05), ("forest", 0.0), ("gbt", 0.0)],
    ids=["logreg", "logreg-sgd", "forest", "gbt"])
def test_sharded_engine_matches_jax(stream, monkeypatch, n_dev, kind,
                                    online_lr):
    """Three batches of 1024 rows; the tree kinds score every chunk
    through the leaf-sum kernel's wrapper (its plain version here), once
    per chunk, and never through the fused kernels."""
    calls = {}
    for name in ("leaf_sum_plain", "fused_forest_leaf_sum_plain"):
        orig = getattr(forest_kernels, name)

        def counted(*a, _orig=orig, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(forest_kernels, name, counted)
    tcfg, jcfg = _cfgs()
    teng, jeng, tout, jout, stats = _serve_both(
        kind, n_dev, stream, tcfg, jcfg, online_lr=online_lr,
        with_labels=online_lr > 0)
    assert stats["batches"] == 3 and stats["rows"] == 3072
    want = {"leaf_sum_plain": 3} if kind != "logreg" else {}
    assert calls == want
    assert (teng.leaf_tables is not None) == (kind != "logreg")
    assert teng.tables is None  # the fused forest kernel is off this path
    _assert_outputs(tout, jout, "logreg-sgd" if online_lr else kind)
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    for a, b in zip(tree.leaves(teng.state.params),
                    jax.tree.leaves(jeng.state.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.0,
                                   atol=1e-6)
    if online_lr:
        w0 = _models(kind)[2].w.numpy()
        assert not np.allclose(teng.state.params.w.numpy(), w0)


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("source", ["table", "cms"])
def test_hot_key_spill_matches_jax(stream, n_dev, source):
    """40% of the rows on one customer, 64 rows per shard: its shard
    overflows into densely packed routed chunks, whose customer exchange
    needs the full bucket (run eagerly, ``full_exchange_chunks``) but for
    a short tail chunk."""
    tcfg, jcfg = _cfgs(customer_source=source)
    teng, jeng, tout, jout, stats = _serve_both(
        "forest", n_dev, _hot(stream), tcfg, jcfg, rows_per_shard=64)
    assert jeng._sharded_step_routed is not None
    assert stats["full_exchange_chunks"] > 0
    _assert_outputs(tout, jout, "forest")
    _assert_state(teng.state.feature_state, jeng.state.feature_state)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_cent_amounts_match_jax_within_order_tolerance(small_dataset,
                                                       n_dev):
    txs = _hot(small_dataset[3].slice(slice(0, 2048)))
    tcfg, jcfg = _cfgs()
    teng, jeng, tout, jout, _ = _serve_both("logreg", n_dev, txs, tcfg,
                                            jcfg)
    _assert_outputs(tout, jout, "logreg", amounts_exact=False)
    _assert_state(teng.state.feature_state, jeng.state.feature_state,
                  amounts_exact=False)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_state_feedback_matches_jax(stream, n_dev):
    """Delayed labels land at the owner-layout rows of both engines; the
    next batches read them through the delayed risk windows alike."""
    tcfg, jcfg = _cfgs()
    warm, rest = stream.slice(slice(0, 2048)), stream.slice(slice(2048, None))
    teng, jeng, _, _, _ = _serve_both("logreg", n_dev, warm, tcfg, jcfg)
    rng = np.random.default_rng(5)
    pick = rng.choice(warm.n, 300, replace=False)
    terms = warm.terminal_id[pick]
    days = (EPOCH0 // 86400 + warm.tx_time_days[pick]).astype(np.int32)
    labels = np.where(rng.random(300) < 0.2, -1,
                      rng.integers(0, 2, 300)).astype(np.int32)
    teng.apply_state_feedback(terms, days, labels)
    jeng.apply_state_feedback(terms, days, labels)
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    assert teng.state.feature_state.terminal.fraud.sum() > 0
    tsink, jsink = MemorySink(), JMemorySink()
    teng.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), tsink)
    jeng.run(JReplaySource(rest, EPOCH0, batch_rows=1024), sink=jsink)
    _assert_outputs(tsink.concat(), jsink.concat(), "logreg")


@pytest.mark.parametrize("mode", ["alerts-only", "bf16", "selective"])
def test_emission_modes_match_jax(stream, mode):
    runtime = {"alerts-only": dict(emit_features=False),
               "bf16": dict(emit_dtype="bfloat16"),
               "selective": dict(emit_threshold=0.3,
                                 emit_cap_fraction=1 / 16)}[mode]
    tcfg, jcfg = _cfgs(runtime=runtime)
    teng, jeng, tout, jout, stats = _serve_both("forest", 4, _hot(stream),
                                                tcfg, jcfg)
    _assert_outputs(tout, jout, "forest")
    if mode == "selective":
        assert stats["selective_overflows"] == jeng.selective_overflows
        assert (tout["prediction"] >= 0.3).any()


def test_precompile_lists_the_jax_signatures_and_serves_as_eager(stream):
    """``dispatch_inventory`` is the JAX engine's (keys, variants, the
    chunk bucket); ``precompile`` (on the CPU: the keys, no graphs) then
    serves every batch as the eager engine does."""
    tcfg, jcfg = _cfgs()
    jp, js, tp, ts = _models("forest")
    jeng = JShardedScoringEngine(jcfg, kind="forest", params=jp, scaler=js,
                                 n_devices=4)
    teng = ShardedScoringEngine(tcfg, "forest", tp, ts, n_devices=4,
                                device="cpu")
    tsig, jsig = teng.dispatch_inventory(), jeng.dispatch_inventory()
    assert [(s.key, s.variant, s.bucket, s.z_mode) for s in tsig] \
        == [(s.key, s.variant, s.bucket, s.z_mode) for s in jsig]
    manifest = teng.precompile()
    assert manifest["buckets"] == [2048, 2048] and manifest["graphs"] == 0
    eager = ShardedScoringEngine(tcfg, "forest", tp, ts, n_devices=4,
                                 device="cpu")
    a, b = MemorySink(), MemorySink()
    src = _port_txs(_hot(stream))
    teng.run(ReplaySource(src, EPOCH0, batch_rows=1024), a)
    eager.run(ReplaySource(src, EPOCH0, batch_rows=1024), b)
    for col, v in a.concat().items():
        if col != "processed_at_us":
            np.testing.assert_array_equal(v, b.concat()[col], err_msg=col)


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("kind", ["logreg", "forest"])
def test_sharded_engine_matches_the_single_engine(stream, n_dev, kind):
    """The port's sharded engine against its own single engine on the
    same whole-dollar stream (every batch one owner-local chunk: a spill
    chunk's rows are a later step, which the single engine's batch-mates
    are not): the features bit for bit, the probabilities within 1e-6
    (the fused kernels' plain versions against the leaf sum's and the
    plain predict)."""
    tcfg, _ = _cfgs()
    _, _, tp, ts = _models(kind)
    src = _port_txs(stream)
    outs = []
    for eng in (ScoringEngine(tcfg, kind, tp, ts, device="cpu"),
                ShardedScoringEngine(tcfg, kind, tp, ts, n_devices=n_dev,
                                     device="cpu")):
        sink = MemorySink()
        eng.run(ReplaySource(src, EPOCH0, batch_rows=1024), sink)
        outs.append(sink.concat())
    single, sharded = outs
    for col in single:
        if col == "prediction":
            np.testing.assert_allclose(sharded[col], single[col], rtol=0.0,
                                       atol=1e-6)
        elif col != "processed_at_us":
            np.testing.assert_array_equal(sharded[col], single[col],
                                          err_msg=col)


# -- checkpoints and widths ------------------------------------------------


def test_jax_checkpoint_resumes_in_the_port_and_back(stream, tmp_path):
    """Width 4 both ways: a JAX sharded checkpoint restores into the port's
    sharded engine, a port checkpoint into the JAX engine; every resumed
    run equals the uninterrupted one."""
    tcfg, jcfg = _cfgs(customer_source="cms")
    warm, rest = stream.slice(slice(0, 2048)), stream.slice(slice(2048, None))
    jp, js, tp, ts = _models("forest")
    # the uninterrupted run (JAX)
    jeng = JShardedScoringEngine(jcfg, kind="forest", params=jp, scaler=js,
                                 n_devices=4)
    jeng.run(JReplaySource(warm, EPOCH0, batch_rows=1024))
    jck = JCheckpointer(str(tmp_path / "jax"))
    jck.save(jeng.state)
    ref = JMemorySink()
    jeng.run(JReplaySource(rest, EPOCH0, batch_rows=1024), sink=ref)
    # JAX → port
    teng = ShardedScoringEngine(tcfg, "forest", tp, ts, n_devices=4,
                                device="cpu")
    assert Checkpointer(str(tmp_path / "jax")).restore(teng.state) \
        is not None
    assert teng.state.batches_done == 2 and teng.state.layout_devices == 4
    got = MemorySink()
    teng.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), got)
    _assert_outputs(got.concat(), ref.concat(), "forest")
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    # port → JAX
    teng2 = ShardedScoringEngine(tcfg, "forest", tp, ts, n_devices=4,
                                 device="cpu")
    teng2.run(ReplaySource(_port_txs(warm), EPOCH0, batch_rows=1024))
    Checkpointer(str(tmp_path / "port")).save(teng2.state)
    jeng2 = JShardedScoringEngine(jcfg, kind="forest", params=jp,
                                  scaler=js, n_devices=4)
    assert JCheckpointer(str(tmp_path / "port")).restore(jeng2.state) \
        is not None
    got2 = JMemorySink()
    jeng2.run(JReplaySource(rest, EPOCH0, batch_rows=1024), sink=got2)
    _assert_outputs(got2.concat(), ref.concat(), "forest")


def _fs_np(fs):
    return [np.asarray(a) if not isinstance(a, torch.Tensor) else a.numpy()
            for a in tree.leaves(fs)]


@pytest.mark.parametrize("source", ["table", "cms"])
def test_reshard_feature_state_matches_jax(stream, source):
    """1→4→8→1 through ``reshard_feature_state`` on the JAX engine's
    state: the window tables identical to the JAX function's, the merged
    sketch identical, and 1→4→1 the identity on the tables."""
    tcfg, jcfg = _cfgs(customer_source=source)
    jp, js, _, _ = _models("logreg")
    jeng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js)
    jeng.run(JReplaySource(stream, EPOCH0, batch_rows=1024))
    state = jax.tree.map(np.asarray, jeng.state.feature_state)
    j_state = t_state = state
    for n_old, n_new in ((1, 4), (4, 8), (8, 1)):
        j_state = jmesh.reshard_feature_state(j_state, jcfg, n_old, n_new)
        t_state = tmesh.reshard_feature_state(t_state, tcfg, n_old, n_new)
        for a, b in zip(_fs_np(t_state), jax.tree.leaves(j_state)):
            np.testing.assert_array_equal(a, np.asarray(b))
    for a, b in zip(_fs_np(t_state), jax.tree.leaves(state)):
        np.testing.assert_array_equal(a, np.asarray(b))
    # a stacked sketch of 4 shards merges as the JAX merge does
    jeng4 = JShardedScoringEngine(jcfg, kind="logreg", params=jp,
                                  scaler=js, n_devices=4)
    jeng4.run(JReplaySource(stream, EPOCH0, batch_rows=1024))
    s4 = jax.tree.map(np.asarray, jeng4.state.feature_state)
    for a, b in zip(_fs_np(tmesh.reshard_feature_state(s4, tcfg, 4, 1)),
                    jax.tree.leaves(jmesh.reshard_feature_state(s4, jcfg,
                                                                4, 1))):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_cross_width_restores_continue_as_the_uninterrupted_run(stream,
                                                                tmp_path):
    """The port restores its own checkpoints across widths 1→4→8→1; each
    leg continues as the uninterrupted single engine does (features bit
    for bit, probabilities within 1e-6)."""
    tcfg, _ = _cfgs()
    _, _, tp, ts = _models("forest")
    src = _port_txs(stream)
    ref = MemorySink()
    ScoringEngine(tcfg, "forest", tp, ts, device="cpu").run(
        ReplaySource(src, EPOCH0, batch_rows=512), ref)
    legs = [ScoringEngine(tcfg, "forest", tp, ts, device="cpu"),
            ShardedScoringEngine(tcfg, "forest", tp, ts, n_devices=4,
                                 device="cpu"),
            ShardedScoringEngine(tcfg, "forest", tp, ts, n_devices=8,
                                 device="cpu"),
            ScoringEngine(tcfg, "forest", tp, ts, device="cpu")]
    got = MemorySink()
    for i, eng in enumerate(legs):
        if i:
            ck = Checkpointer(str(tmp_path / f"ck{i}"))
            ck.save(legs[i - 1].state)
            assert ck.restore(eng.state) is not None
            assert eng.state.layout_devices == legs[i - 1]._state_shards()
        source = ReplaySource(src, EPOCH0, batch_rows=512)
        if i:
            source.seek(eng.state.offsets)
        eng.run(source, got, max_batches=(2, 2, 1, 0)[i])
        assert eng.state.layout_devices == eng._state_shards()
    a, b = ref.concat(), got.concat()
    n = len(b["tx_id"])
    assert n == src.n
    for col in a:
        if col == "prediction":
            np.testing.assert_allclose(b[col], a[col][:n], atol=1e-6)
        elif col != "processed_at_us":
            np.testing.assert_array_equal(b[col], a[col][:n], err_msg=col)


def test_jax_cross_width_checkpoint_restores_in_the_port(stream, tmp_path):
    """A JAX checkpoint written at 8 shards, restored by the port at 4:
    the continuation equals the JAX engine's restored at 4."""
    tcfg, jcfg = _cfgs(customer_source="cms")
    warm, rest = stream.slice(slice(0, 2048)), stream.slice(slice(2048, None))
    jp, js, tp, ts = _models("gbt")
    jeng8 = JShardedScoringEngine(jcfg, kind="gbt", params=jp, scaler=js,
                                  n_devices=8)
    jeng8.run(JReplaySource(warm, EPOCH0, batch_rows=1024))
    JCheckpointer(str(tmp_path / "ck")).save(jeng8.state)
    jeng4 = JShardedScoringEngine(jcfg, kind="gbt", params=jp, scaler=js,
                                  n_devices=4)
    JCheckpointer(str(tmp_path / "ck")).restore(jeng4.state)
    want = JMemorySink()
    jeng4.run(JReplaySource(rest, EPOCH0, batch_rows=1024), sink=want)
    teng4 = ShardedScoringEngine(tcfg, "gbt", tp, ts, n_devices=4,
                                 device="cpu")
    Checkpointer(str(tmp_path / "ck")).restore(teng4.state)
    assert teng4.state.layout_devices == 8
    got = MemorySink()
    teng4.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), got)
    _assert_outputs(got.concat(), want.concat(), "gbt")
    _assert_state(teng4.state.feature_state, jeng4.state.feature_state)


def test_jax_sharded_exact_checkpoint_restores_in_the_port(stream,
                                                          tmp_path):
    """A JAX sharded exact checkpoint (per-shard key directories, 4
    shards) restored by the port at 4 shards (as it is), at 2 and at 1
    (the directory entries re-homed by ``key % n``): every continuation
    equals the JAX engine's restored at 4, and the same-width restore's
    state equals it bit for bit."""
    tcfg, jcfg = _cfgs(key_mode="exact", compact_every=2)
    warm, rest = stream.slice(slice(0, 2048)), stream.slice(slice(2048, None))
    jp, js, tp, ts = _models("logreg")
    jeng = JShardedScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                                 n_devices=4)
    jeng.run(JReplaySource(warm, EPOCH0, batch_rows=1024))
    JCheckpointer(str(tmp_path)).save(jeng.state)
    want = JMemorySink()
    jeng.run(JReplaySource(rest, EPOCH0, batch_rows=1024), sink=want)
    for n_dev in (4, 2, 1):
        eng = (ShardedScoringEngine(tcfg, "logreg", tp, ts,
                                    n_devices=n_dev, device="cpu")
               if n_dev > 1 else
               ScoringEngine(tcfg, "logreg", tp, ts, device="cpu"))
        assert Checkpointer(str(tmp_path)).restore(eng.state) is not None
        assert eng.state.layout_devices == 4
        got = MemorySink()
        eng.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), got)
        _assert_outputs(got.concat(), want.concat(), "logreg")
        if n_dev == 4:
            _assert_state(eng.state.feature_state, jeng.state.feature_state)


def test_feature_state_n_old_reshards_a_provided_state(stream):
    """A single-device state handed over with ``feature_state_n_old=1``
    serves on at 8 shards as the single engine does."""
    tcfg, _ = _cfgs()
    _, _, tp, ts = _models("logreg")
    warm, rest = stream.slice(slice(0, 2048)), stream.slice(slice(2048, None))
    one = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    one.run(ReplaySource(_port_txs(warm), EPOCH0, batch_rows=1024))
    eng8 = ShardedScoringEngine(
        tcfg, "logreg", tp, ts, n_devices=8, device="cpu",
        feature_state=tree.clone(one.state.feature_state),
        feature_state_n_old=1)
    a, b = MemorySink(), MemorySink()
    one.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), a)
    eng8.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), b)
    np.testing.assert_allclose(b.concat()["prediction"],
                               a.concat()["prediction"], atol=1e-6)


# -- refusals ------------------------------------------------------------------


def _engine(cfg, kind="logreg", **kw):
    _, _, tp, ts = _models(kind)
    return ShardedScoringEngine(cfg, kind, tp, ts, device="cpu", **kw)


def test_refusals_name_their_item():
    tcfg, jcfg = _cfgs()
    with pytest.raises(ValueError, match="must divide by n_devices"):
        _engine(dataclasses.replace(tcfg, features=dataclasses.replace(
            tcfg.features, customer_capacity=4)), n_devices=8)
    with pytest.raises(ValueError, match="must divide by n_devices"):
        _engine(tcfg, n_devices=3)
    with pytest.raises(ValueError, match="must divide"):
        tmesh.reshard_feature_state(None, tcfg, 1, 3)
    with pytest.raises(ValueError, match=">= 1"):
        tmesh.reshard_feature_state(None, tcfg, 0, 4)
    hcfg = dataclasses.replace(tcfg, features=dataclasses.replace(
        tcfg.features, key_mode="hash"))
    with pytest.raises(ValueError, match="hash mode"):
        tmesh.reshard_feature_state(None, hcfg, 1, 4)
    ecfg = dataclasses.replace(tcfg, features=dataclasses.replace(
        tcfg.features, key_mode="exact"))
    with pytest.raises(ValueError, match="feature_state_n_old"):
        _engine(ecfg, n_devices=4, feature_state=tmesh.reshard_feature_state(
            _engine(ecfg, n_devices=8).state.feature_state, ecfg, 8, 2))
    with pytest.raises(ValueError, match="served by the fleet"):
        _engine(tcfg, mesh=("cpu", "meta"))
    with pytest.raises(ValueError, match="served by the fleet"):
        tmesh.make_mesh(2, devices=["cpu", "meta"])
    with pytest.raises(ValueError, match="topology says"):
        _engine(tcfg, n_devices=4, topology=ProcessTopology(2, 0, 2))
    with pytest.raises(ValueError, match="not wired for kind='sequence'"):
        ShardedScoringEngine(tcfg, "sequence", None, None, n_devices=4,
                             device="cpu", topology=ProcessTopology(2, 0, 4))
    ncfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, nan_guard=True))
    with pytest.raises(ValueError, match="nan_guard"):
        _engine(ncfg, n_devices=4)
    scfg = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, scorer="cpu"))
    with pytest.raises(ValueError, match="scorer cpu"):
        _engine(scfg, n_devices=4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="visible"):
            tmesh.make_mesh(4)


@pytest.mark.parametrize("n_old,n_new", [(4, 2), (4, 1), (2, 8)])
def test_exact_state_reshards_as_the_jax_package(stream, n_old, n_new):
    """``reshard_feature_state`` of a JAX sharded exact state (served 2
    batches at ``n_old`` shards) to ``n_new``: every leaf — re-homed
    window rows, rebuilt directories, merged sketches — equals the JAX
    package's conversion bit for bit, and a port engine handed the state
    with ``feature_state_n_old`` serves on as the JAX engine restored at
    ``n_new``."""
    tcfg, jcfg = _cfgs(key_mode="exact")
    warm, rest = stream.slice(slice(0, 2048)), stream.slice(slice(2048, None))
    jp, js, tp, ts = _models("logreg")
    jeng = JShardedScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                                 n_devices=n_old)
    jeng.run(JReplaySource(warm, EPOCH0, batch_rows=1024))
    state = jax.tree.map(np.asarray, jeng.state.feature_state)
    want = jmesh.reshard_feature_state(state, jcfg, n_old, n_new)
    got = tmesh.reshard_feature_state(
        weights.from_numpy(state, device=CPU), tcfg, n_old, n_new)
    jleaves = jax.tree_util.tree_leaves_with_path(want)
    tleaves = tree.leaves_with_path(got)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        assert t.dtype == np.asarray(j).dtype, path
        np.testing.assert_array_equal(t, np.asarray(j), err_msg=path)
    eng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=n_new,
                               device="cpu", feature_state=weights.from_numpy(
                                   state, device=CPU),
                               feature_state_n_old=n_old) if n_new > 1 \
        else ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                           feature_state=weights.from_numpy(got, device=CPU))
    jnew = (JShardedScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                                  n_devices=n_new, feature_state=state,
                                  feature_state_n_old=n_old)
            if n_new > 1 else
            JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                           feature_state=jax.tree.map(jnp.asarray, want)))
    a, b = MemorySink(), JMemorySink()
    eng.run(ReplaySource(_port_txs(rest), EPOCH0, batch_rows=1024), a)
    jnew.run(JReplaySource(rest, EPOCH0, batch_rows=1024), sink=b)
    _assert_outputs(a.concat(), b.concat(), "logreg")


def test_capacity_mismatch_is_refused_on_reshard():
    tcfg, _ = _cfgs()
    small = dataclasses.replace(tcfg, features=dataclasses.replace(
        tcfg.features, terminal_capacity=512))
    state = ScoringEngine(small, "logreg", *_models("logreg")[2:],
                          device="cpu").state.feature_state
    with pytest.raises(ValueError, match="different capacity"):
        tmesh.reshard_feature_state(state, tcfg, 1, 4)
