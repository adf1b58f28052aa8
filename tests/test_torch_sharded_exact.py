"""Port parity: the tiered store across shards (``key_mode="exact"`` in
the sharded engine) against the JAX package's sharded exact engine —
``tests/test_sharded_exact.py``'s cases, the JAX mesh of 2 and 4 virtual
CPU devices against 2 and 4 shards co-located on the CPU, on the same
seeded streams — and the pieces under it: the stacked key directories
against the JAX ``init_stacked_keydir``, ``lookup_slots_stacked`` and
``admit_slots`` run per shard, the re-home between widths against the
JAX ``_reshard_exact``, the cold tier over the shards against
``tests/test_cold_store.py::test_sharded_cold_matches_single``.

Tolerances. The streams are whole-dollar (float32 sums of whole dollars
are exact in any order, counts and fraud sums are whole numbers), so
every state leaf — window tables, sketches, the directories' ``keys``,
``slots``, ``free`` and ``free_top`` — every feature, the per-shard tier
counts and the reclaims are compared bit for bit. Logistic probabilities
within ``atol=1e-6`` (the dot product in another order); the port's own
engines against each other (sharded against single, eager against
precompiled, restored against uninterrupted) bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.ops import keydir as jkeydir
from real_time_fraud_detection_system_tpu.parallel import mesh as jmesh
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ShardedScoringEngine as JShardedScoringEngine,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    MetricsRegistry as JMetricsRegistry,
)
from real_time_fraud_detection_system_tpu.utils.metrics import (
    MetricsServer as JMetricsServer,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core.batch import fold_key
from real_time_fraud_detection_system_tpu_torch.features.online import (
    init_feature_state,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    Checkpointer,
    feature_state_report,
)
from real_time_fraud_detection_system_tpu_torch.ops import keydir as tkeydir
from real_time_fraud_detection_system_tpu_torch.parallel import mesh as tmesh
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine import (
    ShardedScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
    MetricsServer,
    get_registry,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
DAY0 = 20200
ATOL_PROB = 1e-6  # logistic probabilities: the dot product in another order


# -- configs, models, streams (tests/test_sharded_exact.py's) -----------------


def _cfgs(key_mode="exact", cust_cap=512, term_cap=512, rows=256,
          runtime=None, **feat_kw):
    f = dict(key_mode=key_mode, customer_capacity=cust_cap,
             terminal_capacity=term_cap, cms_width=1 << 10, **feat_kw)
    rt = {**dict(batch_buckets=(rows,), max_batch_rows=rows,
                 trigger_seconds=0.0), **(runtime or {})}
    return (Config(features=FeatureConfig(**f), runtime=RuntimeConfig(**rt)),
            JConfig(features=JFeatureConfig(**f),
                    runtime=JRuntimeConfig(**rt)))


def _model():
    """(JAX params, JAX scaler, port params, port scaler), seeded."""
    rng = np.random.default_rng(4)
    w = rng.normal(0, 0.5, 15).astype(np.float32)
    mean = rng.normal(2, 1, 15).astype(np.float32)
    scale = rng.uniform(0.5, 3, 15).astype(np.float32)
    jp = JLogRegParams(w=jnp.asarray(w), b=jnp.float32(-0.5))
    js = JScaler(jnp.asarray(mean), jnp.asarray(scale))
    tp = weights.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    ts = weights.from_numpy(jax.tree.map(np.asarray, js), device=CPU)
    return jp, js, tp, ts


def _cols(rng, n=256, tx0=0, day=DAY0, n_cust=100, n_term=200):
    """Whole-dollar amounts: every window sum is exact in any order."""
    return {
        "tx_id": np.arange(tx0, tx0 + n, dtype=np.int64),
        "tx_datetime_us": (day * 86400
                           + rng.integers(0, 86400, n)).astype(np.int64)
        * 1_000_000,
        "customer_id": rng.integers(0, n_cust, n).astype(np.int64),
        "terminal_id": rng.integers(0, n_term, n).astype(np.int64),
        "tx_amount_cents": (rng.integers(1, 500, n) * 100).astype(
            np.int64),
        "kafka_ts_ms": np.zeros(n, dtype=np.int64),
    }


def _batches(n_batches, rows=256, seed=3, day_step=1, n_cust=100,
             n_term=200):
    rng = np.random.default_rng(seed)
    return [_cols(rng, n=rows, tx0=i * rows, day=DAY0 + i * day_step,
                  n_cust=n_cust, n_term=n_term)
            for i in range(n_batches)]


class _Src:
    def __init__(self, batches):
        self._b = [dict(b) for b in batches]
        self._i = 0

    def poll_batch(self):
        if self._i >= len(self._b):
            return None
        self._i += 1
        return dict(self._b[self._i - 1])

    @property
    def offsets(self):
        return [self._i]

    def seek(self, offsets):
        self._i = int(offsets[0])


def _serve(eng, batches):
    """(probs, features) of ``batches`` served one by one."""
    res = [eng.process_batch(dict(b)) for b in batches]
    return (np.concatenate([np.asarray(r.probs) for r in res]),
            np.concatenate([np.asarray(r.features) for r in res]))


def _assert_state(tfs, jfs):
    """Every leaf of the port's state against the JAX state's, by path,
    bit for bit (whole-dollar streams)."""
    jleaves = jax.tree_util.tree_leaves_with_path(jfs)
    tleaves = tree.leaves_with_path(tfs)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, path
        np.testing.assert_array_equal(t, j, err_msg=path)


def _assert_served(t_out, j_out):
    """Features bit for bit, probabilities within ATOL_PROB."""
    np.testing.assert_array_equal(t_out[1], j_out[1])
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=0.0, atol=ATOL_PROB)


def _engines(n_dev, tcfg=None, jcfg=None, **kw):
    """The port's and the JAX package's sharded engines, same config."""
    if tcfg is None:
        tcfg, jcfg = _cfgs()
    jp, js, tp, ts = _model()
    jreg = kw.pop("jax_metrics", None)
    jeng = JShardedScoringEngine(jcfg, "logreg", jp, js, n_devices=n_dev,
                                 metrics=jreg, **kw)
    teng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=n_dev,
                                device="cpu", **kw)
    return teng, jeng


@pytest.fixture(scope="module")
def served():
    """The JAX sharded exact engine at 2 and 4 shards over the 4-batch
    stream (the jit compiles once per width for the module)."""
    out = {}
    for n_dev in (2, 4):
        teng, jeng = _engines(n_dev)
        out[n_dev] = (teng, _serve(teng, _batches(4)),
                      jeng, _serve(jeng, _batches(4)))
    return out


# -- the stacked key directories ----------------------------------------------


_jit_admit = jax.jit(jkeydir.admit_slots, static_argnums=3)
_jit_reclaim = jax.jit(jkeydir.reclaim_entries)


def _same_dir(tkd, jkd, what=""):
    for name in ("keys", "slots", "free", "free_top"):
        t, j = getattr(tkd, name).numpy(), np.asarray(getattr(jkd, name))
        assert t.dtype == j.dtype and t.shape == j.shape, (what, name)
        np.testing.assert_array_equal(t, j, err_msg=f"{what} {name}")


def test_init_stacked_keydir_and_lookup_match_jax():
    """The stacked layout's leaves, and a lookup into it after both
    packages admitted the same keys shard by shard."""
    n, dir_cap, slot_cap = 4, 64, 32
    tkd = tkeydir.init_stacked_keydir(dir_cap, slot_cap, n, CPU)
    jkd = jkeydir.init_stacked_keydir(dir_cap, slot_cap, n)
    _same_dir(tkd, jkd, "init")
    rng = np.random.default_rng(0)
    keys = fold_key(rng.integers(0, 400, 200))
    owner = (keys % n).astype(np.int64)
    valid = np.ones(200, bool)
    for s in range(n):
        ks = keys[owner == s]
        tkeydir.admit_slots(tkeydir.KeyDirectory(*[x[s] for x in tkd]),
                            torch.from_numpy(ks), torch.ones(len(ks),
                                                             dtype=bool))
        one = jkeydir.KeyDirectory(*[x[s] for x in jkd])
        one, _, _ = _jit_admit(one, jnp.asarray(ks),
                               jnp.ones(len(ks), bool), 8)
        jkd = jkeydir.KeyDirectory(*[x.at[s].set(y)
                                     for x, y in zip(jkd, one)])
    _same_dir(tkd, jkd, "admitted")
    probe = fold_key(np.concatenate([rng.integers(0, 400, 64),
                                     rng.integers(10 ** 6, 10 ** 7, 16)]))
    p_owner = (probe % n).astype(np.int64)
    p_valid = rng.random(len(probe)) < 0.9
    ts, th = tkeydir.lookup_slots_stacked(
        tkd, torch.from_numpy(p_owner), torch.from_numpy(probe),
        torch.from_numpy(p_valid))
    js, jh = jkeydir.lookup_slots_stacked(
        jkd, jnp.asarray(p_owner.astype(np.int32)), jnp.asarray(probe),
        jnp.asarray(p_valid))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert th.any() and not th.all()


@settings(max_examples=24, deadline=None, derandomize=True)
@given(n=st.sampled_from([1, 2, 4]),
       dir_cap=st.sampled_from([16, 64]),
       slot_frac=st.sampled_from([2, 4]),
       n_probes=st.sampled_from([1, 2, 8]),
       seed=st.integers(0, 2 ** 16))
def test_admit_slots_stacked_equals_jax_admit_slots_per_shard(
        n, dir_cap, slot_frac, n_probes, seed):
    """One pass over every shard's rows equals the JAX ``admit_slots`` run
    on each shard's own directory: slots, admitted masks and every leaf,
    through batch duplicates, uint32 edge keys, probe overflow (1 probe),
    a free stack that runs dry, and reclaims between rounds."""
    rng = np.random.default_rng(seed)
    slot_cap = dir_cap // slot_frac
    width = 48
    tkd = tkeydir.init_stacked_keydir(dir_cap, slot_cap, n, CPU)
    jdirs = [jkeydir.init_keydir(dir_cap, slot_cap) for _ in range(n)]
    for _ in range(3):
        keys = rng.integers(0, 2 ** 32, (n, width),
                            dtype=np.uint64).astype(np.uint32)
        keys[:, :30] = rng.integers(0, 3 * slot_cap, (n, 30))  # duplicates
        keys[0, 30:34] = [2 ** 31 - 1, 2 ** 31, 0xFFFFFFFE, 0xFFFFFFFF]
        valid = rng.random((n, width)) < 0.9
        _, slot, adm = tkeydir.admit_slots_stacked(
            tkd, torch.from_numpy(keys), torch.from_numpy(valid), n_probes)
        for s in range(n):
            jdirs[s], js, ja = _jit_admit(jdirs[s], jnp.asarray(keys[s]),
                                          jnp.asarray(valid[s]), n_probes)
            np.testing.assert_array_equal(adm[s].numpy(), np.asarray(ja))
            np.testing.assert_array_equal(slot[s].numpy(), np.asarray(js))
            _same_dir(tkeydir.KeyDirectory(*[x[s] for x in tkd]),
                      jdirs[s], f"shard {s}")
        dead = rng.random((n, dir_cap)) < 0.3
        for s in range(n):
            tkeydir.reclaim_entries(
                tkeydir.KeyDirectory(*[x[s] for x in tkd]),
                torch.from_numpy(dead[s]))
            jdirs[s], _, _ = _jit_reclaim(jdirs[s], jnp.asarray(dead[s]))


# -- serving: sharded exact against JAX, the single engine and direct --------


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_exact_matches_jax_single_and_direct(served, n_dev):
    """With every shard's hot tier holding its keys, the port's sharded
    exact engine serves as the JAX one (state bit for bit) and as its own
    single exact and direct engines (bit for bit)."""
    teng, t_out, jeng, j_out = served[n_dev]
    _assert_served(t_out, j_out)
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    tcfg, _ = _cfgs()
    dcfg, _ = _cfgs("direct")
    _, _, tp, ts = _model()
    for cfg in (tcfg, dcfg):
        ref = _serve(ScoringEngine(cfg, "logreg", tp, ts, device="cpu"),
                     _batches(4))
        np.testing.assert_array_equal(t_out[0], ref[0])
        np.testing.assert_array_equal(t_out[1], ref[1])


def test_sharded_exact_inventory_and_precompile_equal_eager(served):
    """The inventory is the JAX engine's (both step variants and
    ``("compact",)``); a precompiled engine (on the CPU it lists the
    signatures and captures none) serves as the eager one, compaction
    firing."""
    tcfg, jcfg = _cfgs(compact_every=2)
    _, _, tp, ts = _model()
    keys = {}
    for pre in (False, True):
        eng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                                   device="cpu",
                                   metrics=MetricsRegistry())
        if pre:
            man = eng.precompile()
            assert man["graphs"] == 0
        keys[pre] = (_serve(eng, _batches(6, day_step=10)),
                     sorted(s.key for s in eng.dispatch_inventory()))
    jeng = served[4][2]
    jkeys = JShardedScoringEngine(
        jcfg, "logreg", *_model()[:2], n_devices=4,
        mesh=jeng.mesh).dispatch_inventory()
    assert keys[True][1] == keys[False][1] == sorted(
        s.key for s in jkeys) == sorted(
        [("sharded", False), ("sharded", True), ("compact",)])
    for a, b in zip(keys[True][0], keys[False][0]):
        np.testing.assert_array_equal(a, b)


def test_sharded_exact_routed_spill_matches_jax_and_single_chunks():
    """One hot customer: the routed (dense-spill) chunks admit over the
    exchange; the port equals the JAX engine (state bit for bit) and the
    single exact engine fed the same chunks one by one."""
    n, rps = 128, 16
    total = 4 * rps
    tcfg, jcfg = _cfgs(rows=n, runtime=dict(batch_buckets=(rps, total)))
    rng = np.random.default_rng(11)
    cols = _cols(rng, n=n, n_term=13)
    cols["customer_id"] = np.full(n, 3, dtype=np.int64)
    teng, jeng = _engines(4, tcfg, jcfg, rows_per_shard=rps)
    t_out = _serve(teng, [cols])
    j_out = _serve(jeng, [cols])
    assert teng.chunks_done > 1
    _assert_served(t_out, j_out)
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    single = ScoringEngine(tcfg, "logreg", *_model()[2:], device="cpu")
    bounds = [0, rps] + list(range(rps + total, n + 1, total))
    if bounds[-1] != n:
        bounds.append(n)
    refs = [single.process_batch({k: v[a:b] for k, v in cols.items()})
            for a, b in zip(bounds, bounds[1:])]
    np.testing.assert_array_equal(
        t_out[0], np.concatenate([r.probs for r in refs]))
    np.testing.assert_array_equal(
        t_out[1], np.concatenate([r.features for r in refs]))


# -- the sketch tier and the per-shard series -------------------------------


def test_sharded_exact_overflow_counts_per_shard_and_healthz():
    """A 64-slot hot tier under 5,000 keys overflows into each shard's
    sketch replica: the per-shard tier counters equal the JAX engine's,
    sum to the table-level ones (dense + cms = rows × 2), and /healthz
    carries the JAX per-shard breakdown."""
    tcfg, jcfg = _cfgs(cust_cap=64, term_cap=64)
    treg, jreg = MetricsRegistry(), JMetricsRegistry()
    jp, js, tp, ts = _model()
    teng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                                device="cpu", metrics=treg)
    jeng = JShardedScoringEngine(jcfg, "logreg", jp, js, n_devices=4,
                                 metrics=jreg)
    batches = _batches(4, n_cust=5000, n_term=5000)
    t_stats = teng.run(_Src(batches))
    jeng.run(_Src(batches))
    assert t_stats["rows"] == 4 * 256
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    dense = treg.get("rtfds_feature_tier_rows_total", tier="dense").value
    cms = treg.get("rtfds_feature_tier_rows_total", tier="cms").value
    assert dense + cms == 4 * 256 * 2 and cms > 0 and dense > 0
    for tier, total in (("dense", dense), ("cms", cms)):
        shard = [treg.get("rtfds_feature_tier_rows_total", tier=tier,
                          shard=str(s)).value for s in range(4)]
        assert shard == [jreg.get("rtfds_feature_tier_rows_total",
                                  tier=tier, shard=str(s)).value
                         for s in range(4)]
        assert sum(shard) == total
    teng._record_compaction(torch.zeros((4, 2), dtype=torch.int32))
    jeng._record_compaction(jeng.state.feature_state,
                            np.zeros((4, 2), np.int32))
    t_fs = MetricsServer(registry=treg).health()[1]["feature_state"]
    j_fs = JMetricsServer(registry=jreg).health()[1]["feature_state"]
    for key in ("slots_occupied", "slots_occupied_per_shard", "worst_shard",
                "tier_rows", "tier_rows_per_shard", "dense_hit_rate"):
        assert t_fs[key] == j_fs[key], key


def test_sharded_exact_compaction_reclaims_on_every_shard():
    """A drifting working set with the day marching 10 a batch past the
    horizon: every shard reclaims, the per-shard reclaims and occupancy
    equal the JAX engine's, the table totals are the shard sums, and the
    compacted state equals JAX's bit for bit."""
    tcfg, jcfg = _cfgs(compact_every=3)
    treg, jreg = MetricsRegistry(), JMetricsRegistry()
    jp, js, tp, ts = _model()
    teng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                                device="cpu", metrics=treg)
    jeng = JShardedScoringEngine(jcfg, "logreg", jp, js, n_devices=4,
                                 metrics=jreg)
    rng = np.random.default_rng(3)
    batches = []
    for i in range(9):
        c = _cols(rng, n=256, tx0=i * 256, day=DAY0 + i * 10)
        c["customer_id"] = (i * 64 + rng.integers(0, 64, 256)).astype(
            np.int64)
        c["terminal_id"] = (i * 64 + rng.integers(0, 64, 256)).astype(
            np.int64)
        batches.append(c)
    teng.run(_Src(batches))
    jeng.run(_Src(batches))
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    for table in ("customer", "terminal"):
        rec = [treg.get("rtfds_feature_slots_reclaimed_total", table=table,
                        shard=str(s)).value for s in range(4)]
        assert rec == [jreg.get("rtfds_feature_slots_reclaimed_total",
                                table=table, shard=str(s)).value
                       for s in range(4)], table
        assert all(r > 0 for r in rec), table
        assert treg.get("rtfds_feature_slots_reclaimed_total",
                        table=table).value == sum(rec)
        occ = [treg.get("rtfds_feature_slots_occupied", table=table,
                        shard=str(s)).value for s in range(4)]
        assert occ == [jreg.get("rtfds_feature_slots_occupied",
                                table=table, shard=str(s)).value
                       for s in range(4)], table


def test_sharded_compact_pass_returns_the_jax_reclaims():
    """The ``("compact",)`` pass on its own: ``[n, 2]`` reclaims (and,
    with demotion, the stacked payloads) equal the JAX
    ``make_sharded_compact``'s on the same state."""
    from real_time_fraud_detection_system_tpu.parallel import step as jstep
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        step as tstep,
    )

    tcfg, jcfg = _cfgs(cust_cap=64, term_cap=64, cold_highwater=0.25)
    teng, jeng = _engines(4, tcfg, jcfg)
    batches = _batches(3, day_step=2, n_cust=300, n_term=300)
    _serve(teng, batches)
    _serve(jeng, batches)
    for demote in (0, 8):
        tfs = tree.clone(teng.state.feature_state)
        jout = jstep.make_sharded_compact(jcfg, jeng.mesh,
                                          demote_slots=demote)(
            jax.tree.map(jnp.copy, jeng.state.feature_state),
            jnp.int32(DAY0 + 40))
        tout = tstep.make_sharded_compact(
            tcfg, teng.mesh, demote_slots=demote)(tfs, DAY0 + 40)
        np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))
        _assert_state(tout[0], jout[0])
        if demote:
            for table in ("customer", "terminal"):
                for t, j in zip(tout[2][table], jout[2][table]):
                    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert int(tout[1].sum()) > 0


# -- labels ------------------------------------------------------------------


def test_sharded_exact_feedback_hits_dense_misses_sketch_as_jax():
    """Labels for an admitted terminal land in its owner's window rows
    (the risk feature rises), a never-admitted terminal's in its owner's
    sketch fraud column, never inserted — the state equal to the JAX
    engine's after each step."""
    from real_time_fraud_detection_system_tpu.features.spec import (
        FEATURE_NAMES,
    )

    teng, jeng = _engines(4)
    delay = teng.cfg.features.delay_days
    rng = np.random.default_rng(2)

    def cols_for(day, tx0):
        c = _cols(rng, n=8, tx0=tx0, day=day)
        c["terminal_id"] = np.full(8, 7, dtype=np.int64)
        return c

    first = cols_for(DAY0, 0)
    _serve(teng, [first])
    _serve(jeng, [first])
    for eng in (teng, jeng):
        eng.apply_state_feedback(np.full(8, 7, np.int64),
                                 np.full(8, DAY0, np.int32),
                                 np.ones(8, np.int32))
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    later = cols_for(DAY0 + delay + 1, 100)
    t_out, j_out = _serve(teng, [later]), _serve(jeng, [later])
    _assert_served(t_out, j_out)
    risk = [i for i, nm in enumerate(FEATURE_NAMES) if "RISK" in nm]
    assert 0 < t_out[1][:, risk].max() <= 1.0
    # a miss (never admitted; owned by terminal 7's shard, whose sketch
    # holds the label's day): the sketch's fraud column, no insert
    miss = 424243
    assert miss % 4 == 7 % 4
    sk0 = teng.state.feature_state.terminal_cms.fraud.sum()
    for eng in (teng, jeng):
        eng.apply_state_feedback(np.full(2, miss, np.int64),
                                 np.full(2, DAY0 + delay + 1, np.int32),
                                 np.ones(2, np.int32))
    assert teng.state.feature_state.terminal_cms.fraud.sum() > sk0
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    key = torch.from_numpy(fold_key(np.asarray([miss])))
    _, hit = tkeydir.lookup_slots_stacked(
        teng.state.feature_state.terminal_dir, key.long() % 4, key,
        torch.ones(1, dtype=torch.bool))
    assert not bool(hit[0])


# -- the cold tier over the shards ---------------------------------------------


def _cold_cols(cust, term, day):
    cust = np.asarray(cust, np.int64)
    n = len(cust)
    us = (day * 86400 + np.arange(n) % 86400).astype(np.int64) * 1_000_000
    return {"tx_id": np.arange(n, dtype=np.int64), "tx_datetime_us": us,
            "customer_id": cust,
            "terminal_id": np.asarray(term, np.int64),
            "tx_amount_cents": np.full(n, 1200, np.int64),
            "kafka_ts_ms": us // 1000}


def test_sharded_cold_matches_jax_and_a_never_evicted_single(tmp_path):
    """``tests/test_cold_store.py::test_sharded_cold_matches_single``:
    per-shard demotions, owner-grouped promotions, then the returning
    keys' scores equal a single never-evicted engine bit for bit and the
    JAX sharded engine's (state bit for bit after the promotions)."""
    a = np.arange(0, 48)
    b = np.arange(1000, 1032)
    batches = [_cold_cols(a, a + 10000, DAY0),
               _cold_cols(a, a + 10000, DAY0),
               _cold_cols(b, b + 10000, DAY0 + 2),
               _cold_cols(b, b + 10000, DAY0 + 3),
               _cold_cols(b, b + 10000, DAY0 + 4),
               _cold_cols(a[:16], a[:16] + 10000, DAY0 + 5)]
    fkw = dict(cust_cap=128, term_cap=128, rows=64, compact_every=2,
               cold_demote_slots=16, cold_highwater=0.25,
               cold_promote_queue=64)
    tcfg, _ = _cfgs(cold_store=str(tmp_path / "tcold"), **fkw)
    _, jcfg = _cfgs(cold_store=str(tmp_path / "jcold"), **fkw)
    treg, jreg = MetricsRegistry(), JMetricsRegistry()
    jp, js, tp, ts = _model()
    teng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                                device="cpu", metrics=treg)
    jeng = JShardedScoringEngine(jcfg, "logreg", jp, js, n_devices=4,
                                 metrics=jreg)
    assert ("promote",) in [s.key for s in teng.dispatch_inventory()]
    ccfg, _ = _cfgs(cust_cap=4096, term_cap=4096, rows=64)
    ctrl = ScoringEngine(ccfg, "logreg", tp, ts, device="cpu",
                         metrics=MetricsRegistry())
    for cols in batches:
        for eng in (teng, jeng, ctrl):
            eng.process_batch({k: v.copy() for k, v in cols.items()})
    assert treg.get("rtfds_feature_cold_demotions_total").value == \
        jreg.get("rtfds_feature_cold_demotions_total").value > 0
    assert teng.drain_promotions(timeout_s=30.0)
    assert jeng.drain_promotions(timeout_s=30.0)
    assert treg.get("rtfds_feature_cold_promotions_total").value == \
        jreg.get("rtfds_feature_cold_promotions_total").value > 0
    _assert_state(teng.state.feature_state, jeng.state.feature_state)
    ping = _cold_cols(a[:16], a[:16] + 10000, DAY0 + 5)
    t_out = _serve(teng, [ping])
    j_out = _serve(jeng, [ping])
    c_out = _serve(ctrl, [ping])
    np.testing.assert_array_equal(t_out[0], c_out[0])
    np.testing.assert_array_equal(t_out[1], c_out[1])
    _assert_served(t_out, j_out)
    teng.fence_cold()


# -- durable state -----------------------------------------------------------


def test_sharded_exact_checkpoint_restore_bit_identical(tmp_path):
    """A crash-resume at the same width: the continuation of a restored
    4-shard engine equals the uninterrupted run bit for bit, and the
    manifest's per-shard occupancy is the state's."""
    tcfg, _ = _cfgs()
    _, _, tp, ts = _model()
    batches = _batches(5)

    def eng():
        return ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                                    device="cpu")

    ref = _serve(eng(), batches)
    first = eng()
    _serve(first, batches[:2])
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(first.state)
    fs = feature_state_report(ck.manifest(ck.latest()))
    assert fs["layout_devices"] == 4
    tops = first.state.feature_state.terminal_dir.free_top.numpy()
    assert fs["occupancy_per_shard"]["terminal"] == (
        tcfg.features.terminal_capacity // 4 - tops).tolist()
    second = eng()
    assert ck.restore(second.state) is not None
    out = _serve(second, batches[2:])
    n = 2 * 256
    np.testing.assert_array_equal(out[0], ref[0][n:])
    np.testing.assert_array_equal(out[1], ref[1][n:])


def test_sharded_exact_restored_2_to_4_and_to_1(tmp_path):
    """A 2-shard exact checkpoint restores into a 4-shard engine (the
    directory entries re-homed) and into the single exact engine: both
    continuations equal the uninterrupted 2-shard run bit for bit, and the
    4-shard engine's state equals the JAX engine's restored the same
    way."""
    from real_time_fraud_detection_system_tpu.io.checkpoint import (
        Checkpointer as JCheckpointer,
    )

    tcfg, jcfg = _cfgs()
    jp, js, tp, ts = _model()
    batches, tail = _batches(4), _batches(2, seed=23)
    e2 = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=2,
                              device="cpu")
    _serve(e2, batches)
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(e2.state)
    ref = _serve(e2, tail)
    e4 = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                              device="cpu")
    assert ck.restore(e4.state).layout_devices == 2
    out4 = _serve(e4, tail)
    assert e4.state.layout_devices == 4
    e1 = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    assert ck.restore(e1.state) is not None
    out1 = _serve(e1, tail)
    for out in (out4, out1):
        np.testing.assert_array_equal(out[0], ref[0])
        np.testing.assert_array_equal(out[1], ref[1])
    # the JAX engine restores the port's checkpoint the same way
    j4 = JShardedScoringEngine(jcfg, "logreg", jp, js, n_devices=4)
    assert JCheckpointer(str(tmp_path / "ck")).restore(j4.state) is not None
    _assert_served(out4, _serve(j4, tail))
    _assert_state(e4.state.feature_state, j4.state.feature_state)


def test_reshard_exact_roundtrip_matches_jax():
    """1→2→4→1 on a single exact engine's state: every leg's leaves equal
    the JAX ``reshard_feature_state``'s bit for bit (slots granted in
    sorted-key order), and the round trip keeps every admitted key's
    window row and the stack height."""
    tcfg, jcfg = _cfgs()
    jp, js, tp, ts = _model()
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    _serve(eng, _batches(3))
    jeng = JScoringEngine(jcfg, "logreg", jp, js)
    _serve(jeng, _batches(3))
    t = tree.clone(eng.state.feature_state)
    j = jax.tree.map(np.asarray, jeng.state.feature_state)
    _assert_state(t, j)
    for n_old, n_new in ((1, 2), (2, 4), (4, 1)):
        t = tmesh.reshard_feature_state(t, tcfg, n_old, n_new)
        j = jmesh.reshard_feature_state(j, jcfg, n_old, n_new)
        _assert_state(t, j)
    keys = torch.from_numpy(fold_key(np.arange(200)))
    ones = torch.ones(200, dtype=torch.bool)
    st0 = eng.state.feature_state
    back = weights.from_numpy(t, device=CPU)
    sa, ha = tkeydir.lookup_slots(st0.terminal_dir, keys, ones)
    sb, hb = tkeydir.lookup_slots(back.terminal_dir, keys, ones)
    assert torch.equal(ha, hb) and bool(ha.any())
    for leaf in ("bucket_day", "count", "fraud"):
        assert torch.equal(getattr(st0.terminal, leaf)[sa[ha]],
                           getattr(back.terminal, leaf)[sb[hb]]), leaf
    assert int(st0.terminal_dir.free_top) == int(back.terminal_dir.free_top)


def test_reshard_exact_overloaded_shard_raises_naming_the_fix():
    """Five live terminals of residue 0 cannot fit a 2-slot shard at
    width 4: raised, naming compaction, as the JAX package does."""
    tcfg, jcfg = _cfgs(cust_cap=8, term_cap=8, rows=64)
    _, _, tp, ts = _model()
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    c = _cols(np.random.default_rng(1), n=64)
    c["terminal_id"] = np.asarray([0, 4, 8, 12, 16] * 12 + [0] * 4,
                                  np.int64)
    eng.process_batch(c)
    with pytest.raises(ValueError, match="compaction"):
        tmesh.reshard_feature_state(eng.state.feature_state, tcfg, 1, 4)


def test_cross_width_restore_capacity_mismatch_still_quarantines(tmp_path):
    """Only the per-shard planes may change shape across widths: a
    checkpoint of another terminal capacity is incompatible (quarantined,
    counted), never re-homed."""
    wcfg, _ = _cfgs(term_cap=256)
    rcfg, _ = _cfgs(term_cap=512)
    _, _, tp, ts = _model()
    writer = ShardedScoringEngine(wcfg, "logreg", tp, ts, n_devices=2,
                                  device="cpu")
    _serve(writer, _batches(2))
    ck = Checkpointer(str(tmp_path / "ck"))
    ck.save(writer.state)
    reader = ShardedScoringEngine(rcfg, "logreg", tp, ts, n_devices=4,
                                  device="cpu")
    corrupt0 = get_registry().family_total(
        "rtfds_checkpoint_corrupt_total") or 0
    assert ck.restore(reader.state) is None
    assert (get_registry().family_total("rtfds_checkpoint_corrupt_total")
            or 0) > corrupt0


# -- refusals ------------------------------------------------------------------


def test_sharded_exact_refusals_match_jax():
    """The nan-guard, a state of another width without
    ``feature_state_n_old``, and a capacity whose share is not a power of
    two: refused by both packages with the same words; the state handed
    over with ``feature_state_n_old`` serves."""
    from real_time_fraud_detection_system_tpu.features.online import (
        init_feature_state as jinit_feature_state,
    )

    tcfg, jcfg = _cfgs()
    jp, js, tp, ts = _model()
    guard = dataclasses.replace(tcfg, runtime=dataclasses.replace(
        tcfg.runtime, nan_guard=True))
    jguard = jcfg.replace(runtime=dataclasses.replace(jcfg.runtime,
                                                      nan_guard=True))
    single = init_feature_state(tcfg.features, CPU)
    odd, jodd = _cfgs(cust_cap=4, term_cap=512)
    for cfg, jc, n_dev, kw, jkw, words in (
            (guard, jguard, 4, {}, {}, "nan_guard"),
            (tcfg, jcfg, 4, dict(feature_state=single),
             dict(feature_state=jinit_feature_state(jcfg.features)),
             "feature_state_n_old"),
            (odd, jodd, 8, {}, {}, "power of two")):
        with pytest.raises(ValueError, match=words):
            ShardedScoringEngine(cfg, "logreg", tp, ts, n_devices=n_dev,
                                 device="cpu", **kw)
        with pytest.raises(ValueError, match=words):
            JShardedScoringEngine(jc, "logreg", jp, js, n_devices=n_dev,
                                  **jkw)
    with pytest.raises(ValueError, match="divide by n_shards"):
        init_feature_state(tcfg.features, CPU, n_shards=3)
    eng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=4,
                               device="cpu", feature_state=single,
                               feature_state_n_old=1)
    assert tuple(eng.state.feature_state.terminal_dir.keys.shape) == (4, 256)
