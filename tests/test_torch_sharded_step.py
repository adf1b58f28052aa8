"""Port parity: the sharded step (``parallel/step.py``) against the JAX
package's on the same seeded chunks, the JAX mesh of 4 and 8 virtual CPU
devices against 4 and 8 shards co-located on the CPU.

What is compared and how closely:

- ``partition_batch_spill``: every chunk, row and position, equal;
- the step, on whole-dollar amounts: every state leaf (owner-major
  window tables, the per-shard sketch; under ``key_mode="exact"`` the
  per-shard directories and terminal sketch), the features, the exact
  step's per-shard tier counts and the probabilities bit for bit —
  float32 sums of whole dollars are exact in any order, and the counts
  and fraud sums are whole numbers;
- on cent amounts: amount sums and averages within ``rtol=1e-6`` (the
  same amounts added in another order: ``index_add_`` against XLA's
  scatter-add), the rest bit for bit;
- logistic probabilities within ``atol=1e-6`` (the dot product in another
  order), the in-step SGD's params within ``atol=1e-6`` (a gradient of
  such sums).
"""

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
from real_time_fraud_detection_system_tpu.core.batch import (
    make_batch as jmake_batch,
)
from real_time_fraud_detection_system_tpu.features.online import (
    init_feature_state as jinit_feature_state,
)
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.logreg import (
    logreg_loss as jlogreg_loss,
)
from real_time_fraud_detection_system_tpu.models.logreg import (
    logreg_predict_proba as jlogreg_predict_proba,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.parallel import mesh as jmesh
from real_time_fraud_detection_system_tpu.parallel import step as jstep
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
)
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    US_PER_DAY,
    make_batch,
    pack_batch,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    logreg_loss,
    logreg_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.parallel import mesh as tmesh
from real_time_fraud_detection_system_tpu_torch.parallel import step as tstep
from real_time_fraud_detection_system_tpu_torch.utils import tree

torch.set_num_threads(1)

CPU = torch.device("cpu")
DAY0 = 20200
RTOL_SUM_ORDER = 1e-6
ATOL_PROB = 1e-6


# -- the partitioner ---------------------------------------------------------


def _cols(cust):
    n = len(cust)
    return {"customer_id": np.asarray(cust, dtype=np.int64),
            "x": np.arange(n, dtype=np.int64)}


def _same_chunks(a, b):
    assert len(a) == len(b)
    for (ca, ra, pa), (cb, rb, pb) in zip(a, b):
        np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(pa, pb)
        assert ca.keys() == cb.keys()
        for k in ca:
            if k == "__routed__":
                assert ca[k] is cb[k]
            else:
                assert ca[k].dtype == cb[k].dtype
                np.testing.assert_array_equal(ca[k], cb[k])


@pytest.mark.parametrize("cust,n_dev,rps", [
    (np.arange(16), 4, 4),  # balanced: one owner-local chunk
    (np.full(10, 5), 4, 4),  # one hot customer: local 4 + a dense 6
    (np.full(100, 3), 8, 4),  # the spill fills several chunks
    (np.array([], dtype=np.int64), 4, 4),  # empty
    (np.arange(7), 1, 16),  # width 1: input order, no ranks
], ids=["balanced", "hot", "multi-spill", "empty", "width-1"])
def test_partition_batch_spill_matches_jax(cust, n_dev, rps):
    _same_chunks(tstep.partition_batch_spill(_cols(cust), n_dev, rps),
                 jstep.partition_batch_spill(_cols(cust), n_dev, rps))


@settings(max_examples=40, deadline=None, derandomize=True)
@given(cust=st.lists(st.integers(0, 2 ** 40), max_size=80),
       n_dev=st.sampled_from([1, 2, 4, 8]),
       rps=st.integers(1, 12))
def test_partition_batch_spill_matches_jax_on_random_inputs(cust, n_dev,
                                                            rps):
    _same_chunks(tstep.partition_batch_spill(_cols(cust), n_dev, rps),
                 jstep.partition_batch_spill(_cols(cust), n_dev, rps))


def test_partition_by_customer_matches_jax_and_refuses_overflow():
    out_t, pos_t = tstep.partition_batch_by_customer(
        _cols(np.arange(32) % 9), 4, 16)
    out_j, pos_j = jstep.partition_batch_by_customer(
        _cols(np.arange(32) % 9), 4, 16)
    np.testing.assert_array_equal(pos_t, pos_j)
    np.testing.assert_array_equal(out_t["x"], out_j["x"])
    with pytest.raises(ValueError, match="partition overflow"):
        tstep.partition_batch_by_customer(_cols(np.full(10, 1)), 4, 4)


def test_route_and_exchange_permute_rows_to_owners():
    """The exchange primitives: a row's rank counts the earlier rows of
    its (sender, owner) pair, and ``xchg`` is its own inverse."""
    dest = torch.tensor([[1, 0, 1, 2], [2, 2, 0, 1]])
    valid = torch.ones_like(dest, dtype=torch.bool)
    send_pos, rank = tstep._route(dest, valid, 2)
    np.testing.assert_array_equal(rank.numpy(), [[0, 0, 1, 0], [0, 1, 0, 0]])
    np.testing.assert_array_equal(send_pos.numpy(), dest.numpy() * 4 + rank.numpy())
    xchg = tstep._make_xchg(2, 3)
    x = torch.arange(2 * 6 * 2).view(2, 6, 2)
    assert torch.equal(xchg(xchg(x)), x)
    np.testing.assert_array_equal(xchg(x)[1, :3].numpy(), x[0, 3:].numpy())
    _, _, scatter = tstep.owner_route(dest[:, :2] % 2, valid[:, :2], 2, 2)
    buf = scatter(torch.tensor([[[10], [11]], [[12], [13]]]))
    np.testing.assert_array_equal(buf[:, :, 0].numpy(),
                                  [[11, 0, 10, 0], [12, 13, 0, 0]])


# -- the step ----------------------------------------------------------------


FEATURES = dict(customer_capacity=512, terminal_capacity=1024,
                cms_width=1 << 10)


def _chunk_cols(seed, n, hot_customer=False, hot_terminal=False,
                big_keys=False, whole_dollars=True):
    rng = np.random.default_rng(seed)
    base = 2 ** 31 + 12345 if big_keys else 0
    cust = (np.full(n, 7) if hot_customer
            else rng.integers(0, 300, n)).astype(np.int64) + base
    term = (np.full(n, 5) if hot_terminal
            else rng.integers(0, 700, n)).astype(np.int64) + base
    cents = rng.integers(100, 30000, n).astype(np.int64)
    if whole_dollars:
        cents = cents // 100 * 100
    return {
        "tx_id": np.arange(n, dtype=np.int64),
        "tx_datetime_us": ((DAY0 + rng.integers(0, 3, n)) * US_PER_DAY
                           + rng.integers(0, 86_400, n) * 1_000_000
                           ).astype(np.int64),
        "customer_id": cust,
        "terminal_id": term,
        "tx_amount_cents": cents,
        "label": np.where(rng.random(n) < 0.3,
                          (rng.random(n) < 0.4).astype(np.int64), -1),
    }


def _cfgs(**features):
    fields = dict(FEATURES, **features)
    return (Config(features=FeatureConfig(**fields)),
            JConfig(features=JFeatureConfig(**fields)))


def _packed_chunk(part):
    """A chunk of ``partition_batch_spill`` as the engine packs it."""
    return pack_batch(make_batch(
        customer_id=part["customer_id"], terminal_id=part["terminal_id"],
        tx_datetime_us=part["tx_datetime_us"],
        amount_cents=part["tx_amount_cents"],
        label=np.where(part["__valid__"], part["label"], -1),
    )._replace(valid=part["__valid__"]))


def _jax_batch(part):
    b = jmake_batch(
        customer_id=part["customer_id"], terminal_id=part["terminal_id"],
        tx_datetime_us=part["tx_datetime_us"],
        amount_cents=part["tx_amount_cents"],
        label=np.where(part["__valid__"], part["label"], -1))
    return jax.tree.map(jnp.asarray, b._replace(valid=part["__valid__"]))


def _logreg(seed=4):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.5, 15).astype(np.float32)
    mean = rng.normal(2, 1, 15).astype(np.float32)
    scale = rng.uniform(0.5, 3, 15).astype(np.float32)
    jp = JLogRegParams(w=jnp.asarray(w), b=jnp.float32(-0.5))
    js = JScaler(jnp.asarray(mean), jnp.asarray(scale))
    tp = weights.from_numpy(jax.tree.map(np.asarray, jp), device=CPU)
    ts = weights.from_numpy(jax.tree.map(np.asarray, js), device=CPU)
    return jp, js, tp, ts


def _assert_state(tfs, jfs, amounts_exact: bool):
    """Every leaf of the port's state against the JAX state's."""
    jleaves = jax.tree_util.tree_leaves_with_path(jfs)
    tleaves = tree.leaves_with_path(tfs)
    assert [jax.tree_util.keystr(p) for p, _ in jleaves] \
        == [p for p, _ in tleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        t, j = t.numpy(), np.asarray(j)
        assert t.shape == j.shape and t.dtype == j.dtype, path
        if "amount" in path and not amounts_exact:
            np.testing.assert_allclose(t, j, rtol=RTOL_SUM_ORDER, err_msg=path)
        else:
            np.testing.assert_array_equal(t, j, err_msg=path)


def _assert_outputs(t_probs, t_feats, j_probs, j_feats, valid,
                    amounts_exact: bool):
    """Probabilities and features of the chunk's valid rows."""
    tp, jp = t_probs.numpy()[valid], np.asarray(j_probs)[valid]
    tf, jf = t_feats.numpy()[valid], np.asarray(j_feats)[valid]
    np.testing.assert_allclose(tp, jp, rtol=0.0, atol=ATOL_PROB)
    if amounts_exact:
        np.testing.assert_array_equal(tf, jf)
    else:
        # the customer averages are ratios of amount sums (features 4,6,8)
        avg = [4, 6, 8]
        rest = [i for i in range(tf.shape[1]) if i not in avg]
        np.testing.assert_array_equal(tf[:, rest], jf[:, rest])
        np.testing.assert_allclose(tf[:, avg], jf[:, avg],
                                   rtol=RTOL_SUM_ORDER)


def _run_both(n_dev, cols_list, rps, features=None, online_lr=0.0,
              amounts_exact=True, force_full=None):
    """Serve ``cols_list`` (one batch each) chunk by chunk through both
    steps from the same fresh state; compare after every chunk. Returns
    the capacity choices the host made, per chunk."""
    tcfg, jcfg = _cfgs(**(features or {}))
    exact = tcfg.features.key_mode == "exact"
    jp, js, tp, ts = _logreg()
    jm = jmesh.make_mesh(n_dev)
    tm = tmesh.make_mesh(n_dev, devices=["cpu"] * n_dev)
    jfs = jmesh.shard_feature_state(jinit_feature_state(
        jcfg.features, n_shards=n_dev if exact else 1), jm)
    tfs = weights.from_numpy(jax.tree.map(np.asarray, jfs), device=CPU)
    loss = dict(loss_fn=jlogreg_loss, online_lr=online_lr)
    builds = {r: jstep.make_sharded_step(jcfg, jlogreg_predict_proba,
                                         mesh=jm, route_customers=r, **loss)
              for r in (False, True)}
    steps = {r: tstep.make_sharded_step(
        tcfg, logreg_predict_proba, loss_fn=logreg_loss,
        online_lr=online_lr, mesh=tm, route_customers=r, packed=True)
        for r in (False, True)}
    choices = []
    jfns = {}
    for cols in cols_list:
        for part, _, _ in tstep.partition_batch_spill(cols, n_dev, rps):
            routed = part["__routed__"]
            valid = part["__valid__"]
            full = (routed and tstep.exchange_overflows(
                        part["customer_id"], valid, n_dev),
                    tstep.exchange_overflows(part["terminal_id"], valid,
                                             n_dev))
            if force_full is not None:
                full = force_full
            choices.append((routed, full))
            jb = _jax_batch(part)
            if routed not in jfns:  # one jit per variant, as the engine
                jfns[routed] = builds[routed](jfs, jp, js, jb)
            jfs, jp, j_probs, j_feats, *j_tier = jfns[routed](jfs, jp, js,
                                                              jb)
            tfs, tp, t_probs, t_feats, *t_tier = steps[routed](
                tfs, tp, ts, torch.from_numpy(_packed_chunk(part)),
                full=full)
            # the tiered store's per-shard [dense, cms] reads, bit for bit
            assert len(t_tier) == len(j_tier) == int(exact)
            for t, j in zip(t_tier, j_tier):
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))
            _assert_state(tfs, jfs, amounts_exact)
            _assert_outputs(t_probs, t_feats, j_probs, j_feats, valid,
                            amounts_exact)
            for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           rtol=0.0, atol=1e-6)
    return choices


STEP_CASES = {
    "direct": dict(),
    "hash-big-keys": dict(features=dict(key_mode="hash"), big_keys=True),
    "direct-big-keys": dict(big_keys=True),
    "cms": dict(features=dict(customer_source="cms")),
    "cms-hash-big-keys": dict(features=dict(customer_source="cms",
                                            key_mode="hash"),
                              big_keys=True),
    # the tiered store: hot tiers of 64 slots under ~300 customers and
    # ~700 terminals, so both tiers serve
    "exact": dict(features=dict(key_mode="exact", customer_capacity=64,
                                terminal_capacity=64)),
    "exact-cms-big-keys": dict(features=dict(key_mode="exact",
                                             customer_source="cms",
                                             terminal_capacity=128),
                               big_keys=True),
}
EXACT_CASES = ("exact", "exact-cms-big-keys")


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("case", [c for c in STEP_CASES
                                  if c not in EXACT_CASES])
@pytest.mark.parametrize("routing", ["local", "routed"])
def test_sharded_step_matches_jax(n_dev, case, routing):
    """Two batches of 256 rows: balanced (one owner-local chunk) or one
    hot customer (a local chunk and dense routed chunks)."""
    spec = STEP_CASES[case]
    hot = routing == "routed"
    cols = [_chunk_cols(s, 256, hot_customer=hot,
                        big_keys=spec.get("big_keys", False))
            for s in (1, 2)]
    choices = _run_both(n_dev, cols, rps=512 // n_dev,
                        features=spec.get("features"))
    assert any(r for r, _ in choices) == hot


@pytest.mark.parametrize("n_dev,case,routing", [
    (4, "exact", "local"), (4, "exact", "routed"), (8, "exact", "routed"),
    (4, "exact-cms-big-keys", "routed")])
def test_sharded_exact_step_matches_jax(n_dev, case, routing):
    """The exact step (``key_mode="exact"``: per-shard directories, the
    stacked admission, sketch reads for the misses, the tier counts) on
    the same two batches; a routed case's batches also hold an
    owner-local chunk, so it drives both variants."""
    test_sharded_step_matches_jax(n_dev, case, routing)


@pytest.mark.parametrize("n_dev", [4, 8])
@pytest.mark.parametrize("skew", ["balanced", "hot_terminal"])
def test_exchange_capacity_branches_match_jax(n_dev, skew):
    """Balanced terminals take the compact bucket, a hot terminal the full
    one (the JAX step's lax.cond takes the same branch); both equal the
    JAX step, and forcing the full bucket on balanced traffic changes
    nothing."""
    cols = [_chunk_cols(7, 256, hot_terminal=skew == "hot_terminal")]
    rps = 512 // n_dev  # 2x the balanced load: one owner-local chunk
    choices = _run_both(n_dev, cols, rps)
    assert [full for _, full in choices] == [
        (False, skew == "hot_terminal")]
    if skew == "balanced":
        _run_both(n_dev, cols, rps, force_full=(False, True))


@pytest.mark.parametrize("n_dev", [4, 8])
def test_routed_customer_exchange_takes_both_buckets(n_dev):
    """A hot customer's spill: the full routed chunk overflows the
    compact customer bucket, the short tail chunk (10 rows) fits it."""
    cols = [_chunk_cols(3, 8 + 4 * n_dev * 8 + 10, hot_customer=True)]
    choices = _run_both(n_dev, cols, rps=8)
    assert {full[0] for routed, full in choices if routed} == {True, False}


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_step_cent_amounts_within_order_tolerance(n_dev):
    cols = [_chunk_cols(s, 256, hot_customer=s == 2, whole_dollars=False)
            for s in (1, 2)]
    _run_both(n_dev, cols, rps=512 // n_dev, amounts_exact=False)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_online_sgd_matches_jax(n_dev):
    """The in-step SGD: the mean of the shards' gradients of their own
    masked mean losses, applied in place; params within 1e-6."""
    cols = [_chunk_cols(s, 256, hot_customer=s == 2) for s in (1, 2, 3)]
    _run_both(n_dev, cols, rps=512 // n_dev, online_lr=0.05)


def test_step_refusals():
    tcfg, _ = _cfgs()
    with pytest.raises(ValueError, match="power of two"):
        tstep.make_sharded_step(  # 512 / 3 shards
            tcfg, logreg_predict_proba,
            mesh=tmesh.make_mesh(3, devices=["cpu"] * 3))
    tcfg, _ = _cfgs(key_mode="exact")
    with pytest.raises(ValueError, match="power of two"):  # 512 / 3 shards
        tstep.make_sharded_step(tcfg, logreg_predict_proba,
                                mesh=tmesh.make_mesh(3, devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="mesh"):
        tstep.make_sharded_step(tcfg, logreg_predict_proba)


def test_width_one_step_equals_the_single_device_features():
    """At width 1 the exchange is skipped and slots are the direct map:
    the step's features equal ``update_and_featurize``'s."""
    from real_time_fraud_detection_system_tpu_torch.core.batch import (
        unpack_batch,
    )
    from real_time_fraud_detection_system_tpu_torch.features.online import (
        init_feature_state,
        update_and_featurize,
    )

    tcfg, _ = _cfgs()
    _, _, tp, ts = _logreg()
    cols = _chunk_cols(9, 200)
    (part, _, _), = tstep.partition_batch_spill(cols, 1, 256)
    packed = torch.from_numpy(_packed_chunk(part))
    step = tstep.make_sharded_step(tcfg, logreg_predict_proba,
                                   mesh=tmesh.make_mesh(1, devices=["cpu"]),
                                   packed=True)
    s1 = init_feature_state(tcfg.features, CPU)
    _, _, _, feats = step(s1, tp, ts, packed)
    s2 = init_feature_state(tcfg.features, CPU)
    _, ref = update_and_featurize(s2, unpack_batch(packed), tcfg.features)
    assert torch.equal(feats, ref)
    for a, b in zip(tree.leaves(s1), tree.leaves(s2)):
        assert torch.equal(a, b)
