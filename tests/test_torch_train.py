"""Port parity: the offline trainers and the training pipeline against the
JAX package.

The same NumPy inputs, made from a seed, go through each JAX function and
its port counterpart on the CPU. ``jax.random`` cannot be reproduced
without jax, so the trainers start from the JAX package's own initial
parameters, carried into the port by ``weights.from_numpy`` through the
port's ``init_*`` monkeypatched inside the test; from there the minibatch
order (NumPy) and the arithmetic are the same.

Tolerances, and why they hold:

- splits, masks and day tuples exactly (the same integer logic);
- ``performance_assessment`` within 1e-12 (the same NumPy operations on
  the same scores);
- parameters after Adam within ``atol=1e-5`` (1e-4 for the transformer),
  ``err_scale`` within ``rtol=1e-5``: ``optax.adam`` and
  ``torch.optim.Adam`` compute the same update but round it differently,
  and XLA's dot and torch's matmul add a batch's gradient terms in other
  orders; the differences are ulps per step and add over the steps;
- gbt node tables and base score bit for bit (the same NumPy booster on
  bit-identical scaled features), sklearn tree and forest tables bit for
  bit (the same estimator compiled by the same code);
- the gbt artifact trained end to end on the whole-dollar copy of the
  table: the same ``content_sha256`` (replayed features are bit-identical
  there, since float32 sums of whole dollars are exact in any order).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    DataConfig as JDataConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    ModelConfig as JModelConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    TrainConfig as JTrainConfig,
)
from real_time_fraud_detection_system_tpu.data.generator import (
    Transactions as JTransactions,
)
from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.models import autoencoder as jae
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models import logreg as jlogreg
from real_time_fraud_detection_system_tpu.models import metrics as jmetrics
from real_time_fraud_detection_system_tpu.models import mlp as jmlp
from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu.models import train as jtrain
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    DataConfig,
    FeatureConfig,
    ModelConfig,
    TrainConfig,
)
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.io import artifacts as tart
from real_time_fraud_detection_system_tpu_torch.models import autoencoder as tae
from real_time_fraud_detection_system_tpu_torch.models import forest as tforest
from real_time_fraud_detection_system_tpu_torch.models import gbt as tgbt
from real_time_fraud_detection_system_tpu_torch.models import logreg as tlogreg
from real_time_fraud_detection_system_tpu_torch.models import metrics as tmetrics
from real_time_fraud_detection_system_tpu_torch.models import mlp as tmlp
from real_time_fraud_detection_system_tpu_torch.models import sequence as tseq
from real_time_fraud_detection_system_tpu_torch.models import train as ttrain
from real_time_fraud_detection_system_tpu_torch.utils import tree

ATOL_ADAM = 1e-5
ATOL_ADAM_TRANSFORMER = 1e-4
RTOL_ERR_SCALE = 1e-5
TOL_METRICS = 1e-12

_TX_FIELDS = ("tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
              "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")

DATA = dict(n_customers=100, n_terminals=200, n_days=60)
FEATURES = dict(customer_capacity=128, terminal_capacity=256)
TRAIN = dict(delta_train_days=30, delta_delay_days=7, delta_test_days=15,
             epochs=2, batch_size=512)


def jtxs_of(txs) -> JTransactions:
    return JTransactions(*[getattr(txs, f) for f in _TX_FIELDS])


def whole_dollars(txs):
    out = txs.slice(slice(None))
    out.amount_cents = np.round(txs.amount_cents / 100).astype(np.int64) * 100
    return out


@pytest.fixture(scope="module")
def txs():
    _, _, t = generate_dataset(DataConfig(**DATA))
    return t


def configs(**model):
    """(port Config, JAX Config) with the same small values."""
    return (Config(data=DataConfig(**DATA), features=FeatureConfig(**FEATURES),
                   model=ModelConfig(**model), train=TrainConfig(**TRAIN)),
            JConfig(data=JDataConfig(**DATA),
                    features=JFeatureConfig(**FEATURES),
                    model=JModelConfig(**model), train=JTrainConfig(**TRAIN)))


def to_np(obj):
    return jax.tree.map(np.asarray, obj)


@pytest.fixture
def carried_inits(monkeypatch):
    """The port's inits return the JAX package's initial parameters (the
    same arguments through ``jax.random``), so both trainers start alike."""
    monkeypatch.setattr(tlogreg, "init_logreg", lambda f, seed=0, device=None:
                        weights.from_numpy(to_np(jlogreg.init_logreg(f, seed)),
                                           device))
    monkeypatch.setattr(tmlp, "init_mlp", lambda f, hidden=(64, 32), seed=0,
                        device=None: weights.from_numpy(
                            to_np(jmlp.init_mlp(f, hidden, seed)), device))
    monkeypatch.setattr(
        tae, "init_autoencoder", lambda f, hidden=(32, 8), seed=0, device=None:
        weights.from_numpy(to_np(jae.init_autoencoder(f, hidden, seed)),
                           device))

    def init_transformer(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                         n_in=tseq.N_EVENT_FEATURES, seed=0, device=None):
        return weights.from_numpy(to_np(jseq.init_transformer(
            d_model, n_heads, n_layers, d_ff, n_in=n_in, seed=seed)), device)

    monkeypatch.setattr(tseq, "init_transformer", init_transformer)


def assert_trees_close(port, jax_tree, atol, rtol=0.0):
    tl = [t.detach().cpu().numpy() for t in tree.leaves(port)]
    jl = [np.asarray(a) for a in jax.tree.leaves(jax_tree)]
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, atol=atol, rtol=rtol)


# ---------------------------------------------------------------- splits


@pytest.mark.parametrize("start_day,spans", [
    (0, (30, 7, 15)), (5, (30, 7, 15)), (0, (153, 30, 30)), (20, (10, 0, 30)),
])
def test_train_delay_test_split_equals_jax(txs, start_day, spans):
    got = ttrain.train_delay_test_split(txs, start_day, *spans)
    want = jtrain.train_delay_test_split(jtxs_of(txs), start_day, *spans)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].any() and got[0].dtype == bool
    assert ttrain.scale_split_to_txs(txs, *spans, start_day=start_day) == \
        jtrain.scale_split_to_txs(jtxs_of(txs), *spans, start_day=start_day)


@pytest.mark.parametrize("n_days", [0, 1, 2, 7, 60, 212, 213, 245, 400])
def test_fit_split_to_days_equals_jax(n_days):
    for spans in ((153, 30, 30), (10, 0, 5), (0, 0, 0)):
        assert ttrain.fit_split_to_days(n_days, *spans) == \
            jtrain.fit_split_to_days(n_days, *spans)


# ---------------------------------------------------------------- metrics


@pytest.mark.parametrize("ties", [False, True])
def test_performance_assessment_equals_jax(ties):
    rng = np.random.default_rng(7)
    n = 3000
    y = (rng.random(n) < 0.08).astype(np.int8)
    s = rng.random(n)
    if ties:
        s = np.round(s, 2)
    days = rng.integers(0, 20, n)
    cust = rng.integers(0, 300, n)
    got = tmetrics.performance_assessment(y, s, days, cust)
    want = jmetrics.performance_assessment(y, s, days, cust)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_METRICS, k
    assert tmetrics.threshold_based_metrics(y, s) == \
        jmetrics.threshold_based_metrics(y, s)
    assert tmetrics.rebalance_pos_weight(y) == jmetrics.rebalance_pos_weight(y)


# ---------------------------------------------------------------- trainers


def _xy(n=3000, f=15, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    logit = x[:, 0] - 0.5 * x[:, 1] + 0.3 * x[:, 2] - 2.0
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return x, y


def test_train_logreg_equals_jax_from_a_carried_init(carried_inits):
    x, y = _xy()
    kw = dict(learning_rate=1e-2, batch_size=256, epochs=3, pos_weight=2.5,
              seed=3)
    got = tlogreg.train_logreg(x, y, device="cpu", **kw)
    want = jlogreg.train_logreg(x, y, **kw)
    assert_trees_close(got, want, ATOL_ADAM)


def test_train_mlp_equals_jax_from_a_carried_init(carried_inits):
    x, y = _xy()
    kw = dict(hidden=(16, 8), learning_rate=1e-3, batch_size=256, epochs=3,
              pos_weight=2.5, seed=1)
    got = tmlp.train_mlp(x, y, device="cpu", **kw)
    want = jmlp.train_mlp(x, y, **kw)
    assert_trees_close(got, want, ATOL_ADAM)


@pytest.mark.parametrize("batch_size", [256, 100000])
def test_train_autoencoder_equals_jax_from_a_carried_init(carried_inits,
                                                          batch_size):
    x, y = _xy()
    kw = dict(hidden=(8, 4), learning_rate=1e-3, batch_size=batch_size,
              epochs=3, seed=2)
    got = tae.train_autoencoder(x, y, device="cpu", **kw)
    want = jae.train_autoencoder(x, y, **kw)
    assert_trees_close(got.layers, want.layers, ATOL_ADAM)
    np.testing.assert_allclose(float(got.err_scale), float(want.err_scale),
                               rtol=RTOL_ERR_SCALE)


def test_train_autoencoder_refuses_an_all_fraud_table():
    x, _ = _xy(n=10)
    with pytest.raises(ValueError, match="no legitimate rows"):
        tae.train_autoencoder(x, np.ones(10), device="cpu")


@pytest.mark.parametrize("attn", ["naive", "blockwise"])
def test_train_transformer_equals_jax_from_a_carried_init(txs, carried_inits,
                                                          attn):
    seqs = tseq.build_sequences(txs, max_len=24, start_epoch_s=1_743_465_600)
    jseqs = jseq.build_sequences(jtxs_of(txs), max_len=24,
                                 start_epoch_s=1_743_465_600)
    for a, b in zip(seqs, jseqs):
        np.testing.assert_array_equal(a, b)
    kw = dict(d_model=16, n_heads=2, n_layers=1, d_ff=32, batch_size=16,
              epochs=2, seed=4, attn=attn)
    got = tseq.train_transformer(seqs, device="cpu", **kw)
    want = jseq.train_transformer(jseqs, **kw)
    assert_trees_close(got, want, ATOL_ADAM_TRANSFORMER)
    gi, gp = tseq.sequence_scores(got, seqs)
    wi, wp = jseq.sequence_scores(want, jseqs)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_allclose(gp, wp, atol=ATOL_ADAM_TRANSFORMER)


def test_train_transformer_refuses_other_attention():
    seqs = tseq.build_sequences(generate_dataset(DataConfig(
        n_customers=5, n_terminals=10, n_days=3))[2], max_len=8)
    with pytest.raises(ValueError, match="unknown attn 'ring'"):
        tseq.train_transformer(seqs, attn="ring", device="cpu")


@pytest.mark.parametrize("n_trees,max_depth", [(3, 3), (4, 6)])
def test_train_gbt_tables_are_bit_identical_to_jax(n_trees, max_depth):
    x, y = _xy(n=4000)
    got = tgbt.train_gbt(x, y, n_trees=n_trees, max_depth=max_depth,
                         device="cpu")
    want = jgbt.train_gbt(x, y, n_trees=n_trees, max_depth=max_depth)
    for f in ("feat", "thresh", "left", "right", "prob"):
        np.testing.assert_array_equal(getattr(got.trees, f).numpy(),
                                      np.asarray(getattr(want.trees, f)))
    assert got.trees.max_depth == want.trees.max_depth
    assert got.base_score.dtype == torch.float32
    assert got.base_score.numpy().tobytes() == \
        np.asarray(want.base_score).tobytes()


@pytest.mark.parametrize("kind", ["tree", "forest"])
def test_fit_forest_tables_are_bit_identical_to_jax(kind):
    pytest.importorskip("sklearn", reason="fit_forest needs sklearn")
    x, y = _xy(n=2000)
    got = tforest.fit_forest(x, y, n_trees=5, max_depth=4, seed=0, kind=kind,
                             device="cpu")
    want = jforest.fit_forest(x, y, n_trees=5, max_depth=4, seed=0, kind=kind)
    for f in ("feat", "thresh", "left", "right", "prob"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.max_depth == want.max_depth


def test_ensemble_from_sklearn_is_bit_identical_to_jax():
    pytest.importorskip("sklearn", reason="the sklearn estimators")
    from sklearn.ensemble import ExtraTreesClassifier

    x, y = _xy(n=1500)
    clf = ExtraTreesClassifier(n_estimators=4, max_depth=5,
                               random_state=0).fit(x, y)
    got = tforest.ensemble_from_sklearn(clf, 15, device="cpu")
    want = jforest.ensemble_from_sklearn(clf, 15)
    for f in ("feat", "thresh", "left", "right", "prob"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    t64 = np.array([0.1, -0.3, 1e-40, 2.0 ** -149, 5.0])
    np.testing.assert_array_equal(tforest._f32_round_down(t64),
                                  jforest._f32_round_down(t64))


_DUMP = [
    {"nodeid": 0, "depth": 0, "split": "f3", "split_condition": 0.5,
     "yes": 1, "no": 2, "missing": 1, "children": [
         {"nodeid": 1, "depth": 1, "split": "f0", "split_condition": 0.0,
          "yes": 3, "no": 4, "missing": 3, "children": [
              {"nodeid": 3, "leaf": 0.125},
              {"nodeid": 4, "leaf": -0.25}]},
         {"nodeid": 2, "leaf": 0.3}]},
    '{"nodeid": 0, "leaf": -0.0625}',
    {"nodeid": 0, "split": "f14", "split_condition": -1.75, "yes": 2,
     "no": 5, "children": [{"nodeid": 2, "leaf": 0.5},
                           {"nodeid": 5, "leaf": -0.5}]},
]


def test_trees_from_xgb_dump_equal_jax():
    got = tgbt._trees_from_xgb_dump(_DUMP, 15, device="cpu")
    want = jgbt._trees_from_xgb_dump(_DUMP, 15)
    for f in ("feat", "thresh", "left", "right", "prob"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    assert got.max_depth == want.max_depth == 2
    with pytest.raises(ValueError, match="unsupported split name"):
        tgbt._trees_from_xgb_dump([{"nodeid": 0, "split": "amount",
                                    "split_condition": 1.0, "yes": 1,
                                    "no": 2}], 15, device="cpu")


def test_gbt_from_xgboost_needs_xgboost():
    try:
        import xgboost
    except ImportError:
        with pytest.raises(ImportError, match="xgboost"):
            tgbt.gbt_from_xgboost(object(), 15, device="cpu")
        return
    x, y = _xy(n=1000)
    clf = xgboost.XGBClassifier(n_estimators=3, max_depth=3).fit(x, y)
    got = tgbt.gbt_from_xgboost(clf, 15, device="cpu")
    want = jgbt.gbt_from_xgboost(clf, 15)
    np.testing.assert_array_equal(got.trees.thresh.numpy(),
                                  np.asarray(want.trees.thresh))


# ---------------------------------------------------------------- pipeline


@pytest.mark.parametrize("kind", ["logreg", "mlp", "autoencoder"])
def test_train_model_equals_jax_from_a_carried_init(txs, carried_inits, kind):
    cfg, jcfg = configs(mlp_hidden=(16, 8), autoencoder_hidden=(8, 4))
    wtxs = whole_dollars(txs)
    got, gm = ttrain.train_model(wtxs, cfg, kind=kind, device="cpu")
    want, wm = jtrain.train_model(jtxs_of(wtxs), jcfg, kind=kind)
    assert gm.keys() == wm.keys()
    for k in wm:
        assert abs(gm[k] - wm[k]) <= 1e-4, (k, gm[k], wm[k])
    np.testing.assert_array_equal(got.scaler.mean.numpy(),
                                  np.asarray(want.scaler.mean))
    params = got.params.layers if kind == "autoencoder" else got.params
    wparams = want.params.layers if kind == "autoencoder" else want.params
    assert_trees_close(params, wparams, ATOL_ADAM)


def test_train_model_sequence_equals_jax_from_a_carried_init(txs,
                                                             carried_inits):
    cfg, jcfg = configs(seq_d_model=16, seq_n_layers=1, seq_d_ff=32)
    cfg = cfg.replace(features=dataclasses.replace(cfg.features,
                                                   history_len=16))
    jcfg = jcfg.replace(features=dataclasses.replace(jcfg.features,
                                                     history_len=16))
    got, gm = ttrain.train_model(txs, cfg, kind="sequence", device="cpu")
    want, wm = jtrain.train_model(jtxs_of(txs), jcfg, kind="sequence")
    assert got.kind == "sequence"
    for k in wm:
        assert abs(gm[k] - wm[k]) <= 1e-4, (k, gm[k], wm[k])
    assert_trees_close(got.params, want.params, ATOL_ADAM_TRANSFORMER)


@pytest.mark.parametrize("kind", ["gbt", "tree"])
def test_trained_artifact_hash_equals_jax_on_whole_dollars(txs, tmp_path,
                                                           kind):
    if kind == "tree":
        pytest.importorskip("sklearn", reason="the tree kind needs sklearn")
    cfg, jcfg = configs(forest_n_trees=4, forest_max_depth=5)
    wtxs = whole_dollars(txs)
    got, gm = ttrain.train_model(wtxs, cfg, kind=kind, device="cpu")
    want, wm = jtrain.train_model(jtxs_of(wtxs), jcfg, kind=kind)
    tart.save_model(str(tmp_path / "t.npz"), got)
    jart.save_model(str(tmp_path / "j.npz"), want)
    t = tart.load_model(str(tmp_path / "t.npz"), device="cpu")
    with np.load(tmp_path / "j.npz", allow_pickle=False) as z:
        jhash = json.loads(str(z["__meta__"]))["content_sha256"]
    assert t.content_sha256 == jhash is not None
    jart.load_model(str(tmp_path / "t.npz"))  # verifies the port's hash
    for k in wm:
        assert abs(gm[k] - wm[k]) <= 1e-6, (k, gm[k], wm[k])


@pytest.mark.parametrize("kind", ["logreg", "mlp", "autoencoder", "gbt",
                                  "forest"])
def test_predict_proba_equals_jax_and_the_host_scorer(kind):
    """The same trained params predict alike on the port's device path
    (tree kinds through the leaf-sum wrapper's plain version on the CPU),
    the JAX package and the port's NumPy scorer."""
    if kind == "forest":
        pytest.importorskip("sklearn", reason="the forest needs sklearn")
    x, y = _xy(n=2000)
    if kind == "logreg":
        jp = jlogreg.train_logreg(x, y, batch_size=256, epochs=1)
    elif kind == "mlp":
        jp = jmlp.train_mlp(x, y, hidden=(8,), batch_size=256, epochs=1)
    elif kind == "autoencoder":
        jp = jae.train_autoencoder(x, y, hidden=(8, 4), batch_size=256,
                                   epochs=1)
    elif kind == "gbt":
        jp = jgbt.train_gbt(x, y, n_trees=5, max_depth=4)
    else:
        jp = jforest.fit_forest(x, y, n_trees=6, max_depth=5)
    from real_time_fraud_detection_system_tpu.models.scaler import fit_scaler
    js = fit_scaler(x)
    want = jtrain.TrainedModel(kind=kind, scaler=js, params=jp)
    got = ttrain.TrainedModel(kind=kind, scaler=weights.from_numpy(
        to_np(js), "cpu"), params=weights.from_numpy(to_np(jp), "cpu"))
    rows = np.random.default_rng(9).normal(size=(700, 15)).astype(np.float32)
    p = got.predict_proba(rows)
    assert p.shape == (700,) and p.dtype == np.float32
    np.testing.assert_allclose(p, want.predict_proba(rows), atol=1e-6)
    np.testing.assert_allclose(p, got.predict_proba_np(rows), atol=1e-6)


@pytest.mark.parametrize("kind", ["logreg", "tree", "forest"])
def test_cpu_oracle_equals_jax(kind):
    """The sklearn oracle is the same host code in both packages: equal
    probabilities, bit for bit."""
    pytest.importorskip("sklearn", reason="the oracle is sklearn")
    from real_time_fraud_detection_system_tpu.models import cpu_oracle as jco
    from real_time_fraud_detection_system_tpu_torch.models import (
        cpu_oracle as tco,
    )

    x, y = _xy(n=1500)
    got = tco.fit_cpu_scorer(x, y, kind=kind, n_trees=5, max_depth=4)
    want = jco.fit_cpu_scorer(x, y, kind=kind, n_trees=5, max_depth=4)
    rows = x[:300]
    np.testing.assert_array_equal(got.predict_proba(rows),
                                  want.predict_proba(rows))
