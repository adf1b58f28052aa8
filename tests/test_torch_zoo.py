"""Port parity: the mlp and autoencoder kinds, served and learning, against
the JAX package.

The weights are the JAX package's own inits (``jax.random`` from a seed),
carried to the port by ``weights.from_numpy``; the inputs are numpy from a
seed, or the small generated dataset served through both packages'
``ScoringEngine`` in 6 batches of 256 rows (in-band labels).

Tolerances, and why they hold:

- predict, loss and gradient within ``atol=1e-6`` (loss ``rtol=1e-6``):
  the products are XLA's dot on one side and torch's matmul on the other,
  which add the 15-64 terms of each output in other orders (a few f32
  ulps), and the batch mean adds the rows in another order;
- the autoencoder's ``err_scale`` gradient exactly 0 on both sides: the
  loss does not read it (``jax.grad`` gives a zero leaf, the port's
  ``loss_grad`` materializes one);
- engine probabilities within ``atol=1e-5``: the logits' ulps through two
  or three layers (the autoencoder's through ``1 - exp(-err/scale)``),
  plus, with ``online_lr``, the params' differences below;
- params after 6 in-step or feedback SGD steps within ``atol=1e-6``: each
  step moves a leaf by ``lr·g`` with the gradients' few ulps of
  difference; the differences add, they do not compound at these step
  sizes;
- window features, counts, bucket days and fraud sums bit for bit (the
  same featurize as every other unfused kind);
- artifacts and checkpoints bit for bit (the same bytes in both
  packages' formats).
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io.registry import (
    make_model_registry as jmake_model_registry,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.io.sink import ParquetSink
from real_time_fraud_detection_system_tpu.models import autoencoder as jae
from real_time_fraud_detection_system_tpu.models import mlp as jmlp
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime.learner import (
    ShadowScorer as JShadowScorer,
)
from real_time_fraud_detection_system_tpu.runtime.learner import (
    StreamingLearner as JStreamingLearner,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.features.spec import (
    FEATURE_NAMES,
)
from real_time_fraud_detection_system_tpu_torch.io import artifacts as tart
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io.registry import (
    make_model_registry,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models import (
    autoencoder as tae,
)
from real_time_fraud_detection_system_tpu_torch.models import mlp as tmlp
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    loss_grad,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
    loss_fn_for,
    predict_fn_for,
)
from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
    ShadowScorer,
    StreamingLearner,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from test_torch_online_sgd import (  # pytest adds tests/
    assert_state_equal,
    configs,
    port_txs,
)

torch.set_num_threads(1)

START = 1_743_465_600
ROWS = 1536
BATCH = 256
LR = 0.05
ATOL_GRAD = 1e-6
ATOL_PROB = 1e-5
ATOL_PARAMS = 1e-6
KINDS = ("mlp", "autoencoder")


def jax_params(kind: str, seed: int = 0):
    """The JAX package's init at small widths (the autoencoder with a
    calibrated ``err_scale``, as the offline fit leaves it)."""
    if kind == "mlp":
        return jmlp.init_mlp(15, (16, 8), seed=seed)
    p = jae.init_autoencoder(15, (8, 4), seed=seed)
    return p._replace(err_scale=jnp.asarray(0.6, jnp.float32))


# The small dataset's feature means and deviations, rounded: scaled rows
# are O(1), so an SGD step of LR keeps the autoencoder's weights O(1)
# (raw amounts in the hundreds would blow its reconstruction error up).
MEAN = [67, 0.2, 0.2, 3, 67, 12, 62, 12.5, 62, 0.5, 0, 0.7, 0, 0.7, 0]
SCALE = [80, 0.4, 0.4, 1.7, 66, 7.4, 41, 8.3, 40, 1.3, 0.05, 1.9, 0.05,
         1.9, 0.05]


def pair(kind: str, seed: int = 0):
    """(JAX params, JAX scaler, port params, port scaler)."""
    jp = jax_params(kind, seed)
    mean = np.asarray(MEAN, np.float32)
    scale = np.asarray(SCALE, np.float32)
    js = JScaler(mean=jnp.asarray(mean), scale=jnp.asarray(scale))
    return (jp, js, weights.from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
            weights.from_numpy(jax.tree.map(np.asarray, js), "cpu"))


def leaves_np(params) -> list:
    """The leaves of a port or JAX params tree (both walk in the same
    order) as numpy arrays."""
    return [t.detach().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t) for t in tree.leaves(params)]


def assert_params_close(tp, jp, atol=ATOL_PARAMS, what=""):
    a, b = leaves_np(tp), leaves_np(jp)
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_allclose(x, y, atol=atol, err_msg=f"{what} leaf {i}")


def features_of(out: dict) -> np.ndarray:
    """The raw [n, 15] feature rows of a sink's columns."""
    cols = [out["tx_amount"]] + [out[n.lower()] for n in FEATURE_NAMES[1:]]
    return np.stack(cols, axis=1).astype(np.float32)


def _jloss(kind):
    return jmlp.mlp_loss if kind == "mlp" else jae.autoencoder_loss


def _jpredict(kind):
    return (jmlp.mlp_predict_proba if kind == "mlp"
            else jae.autoencoder_predict_proba)


# -- the models -----------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_predict_loss_and_gradient_match_jax(kind, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1.5, (256, 15)).astype(np.float32)
    y = (rng.random(256) < 0.3).astype(np.int32)
    valid = rng.random(256) < 0.9
    jp, _, tp, _ = pair(kind, seed)
    args_j = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    args_t = (torch.tensor(x), torch.tensor(y), torch.tensor(valid))
    np.testing.assert_allclose(
        predict_fn_for(kind)(tp, args_t[0]).numpy(),
        np.asarray(_jpredict(kind)(jp, args_j[0])), atol=ATOL_GRAD)
    lj, gj = jax.value_and_grad(_jloss(kind))(jp, *args_j)
    lt, gt = loss_grad(loss_fn_for(kind), tp, *args_t)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    assert_params_close(gt, gj, ATOL_GRAD, "gradient")
    if kind == "autoencoder":
        # err_scale is not read by the loss: its gradient is exactly 0
        assert float(gt.err_scale) == 0.0 == float(gj.err_scale)
        # frauds and padded rows carry no weight
        _, g0 = loss_grad(tae.autoencoder_loss, tp, args_t[0],
                          torch.ones(256, dtype=torch.int32), args_t[2])
        assert all(float(t.abs().max()) == 0.0 for t in tree.leaves(g0))
    # the caller's leaves are never marked as requiring grad
    assert not any(t.requires_grad for t in tree.leaves(tp))


def test_mlp_pos_weight_matches_jax():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(128, 15)).astype(np.float32)
    y = (rng.random(128) < 0.2).astype(np.int32)
    jp, _, tp, _ = pair("mlp", 3)
    gj = jax.grad(jmlp.mlp_loss)(jp, jnp.asarray(x), jnp.asarray(y), None,
                                 7.0)
    _, gt = loss_grad(lambda p, *a: tmlp.mlp_loss(p, *a, pos_weight=7.0),
                      tp, torch.tensor(x), torch.tensor(y))
    assert_params_close(gt, gj, ATOL_GRAD)


@pytest.mark.parametrize("kind", KINDS)
def test_init_has_the_jax_shapes(kind):
    """The port's inits draw from a torch.Generator (not jax.random's
    stream): the shapes and dtypes are the JAX init's, the draw is
    seeded."""
    if kind == "mlp":
        tp = tmlp.init_mlp(15, (64, 32), seed=4, device="cpu")
        again = tmlp.init_mlp(15, (64, 32), seed=4, device="cpu")
        jp = jmlp.init_mlp(15, (64, 32), seed=4)
    else:
        tp = tae.init_autoencoder(15, (32, 8), seed=4, device="cpu")
        again = tae.init_autoencoder(15, (32, 8), seed=4, device="cpu")
        jp = jae.init_autoencoder(15, (32, 8), seed=4)
    tl, jl = tree.leaves(tp), jax.tree_util.tree_leaves(jp)
    assert [tuple(t.shape) for t in tl] == [tuple(x.shape) for x in jl]
    assert all(t.dtype == torch.float32 for t in tl)
    assert all(torch.equal(a, b) for a, b in zip(tl, tree.leaves(again)))
    assert tree.keystr(tp)[:2] == (["[0][0]", "[0][1]"] if kind == "mlp"
                                   else [".layers[0][0]", ".layers[0][1]"])


# -- the engine: serving, in-step SGD, feedback SGD -----------------------

def _serve(kind, jtxs, lr, stop=0, engine=None, source=None):
    jcfg, tcfg = configs(2)
    jp, js, tp, ts = pair(kind, 2)
    jeng = JScoringEngine(jcfg, kind=kind, params=jp, scaler=js,
                          online_lr=lr)
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=BATCH, with_labels=True),
             sink=jsink, max_batches=stop)
    teng = engine or ScoringEngine(tcfg, kind, tp, ts, device="cpu",
                                   online_lr=lr)
    tsink = MemorySink()
    teng.run(source or ReplaySource(port_txs(jtxs), START, batch_rows=BATCH,
                                    with_labels=True),
             tsink, max_batches=stop)
    return jeng, jsink.concat(), teng, tsink.concat()


@pytest.fixture(scope="module")
def jtxs(small_dataset):
    return small_dataset[3].slice(slice(0, ROWS))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("lr", [0.0, LR])
def test_engine_matches_the_jax_engine(jtxs, kind, lr):
    jeng, jout, teng, tout = _serve(kind, jtxs, lr)
    assert teng.state.batches_done == jeng.state.batches_done == 6
    np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                               atol=ATOL_PROB)
    assert tout["prediction"].std() > 0
    for col in tout:
        if col.endswith("_window") and "avg_amount" not in col:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    assert_state_equal(teng.state.feature_state, jeng.state.feature_state)
    assert_params_close(teng.state.params, jeng.state.params)
    _, _, tp0, _ = pair(kind, 2)
    moved = max(float((a - b).abs().max()) for a, b in zip(
        tree.leaves(teng.state.params), tree.leaves(tp0)))
    assert (moved > 1e-4) == (lr > 0)
    assert teng._online_dirty == (lr > 0)
    if kind == "autoencoder":
        # the in-step SGD never moves the calibration
        assert float(teng.state.params.err_scale) == pytest.approx(0.6)


@pytest.mark.parametrize("kind", KINDS)
def test_in_step_sgd_writes_every_leaf_in_place(jtxs, kind):
    _, tcfg = configs(1)
    _, _, tp, ts = pair(kind, 2)
    eng = ScoringEngine(tcfg, kind, tp, ts, device="cpu", online_lr=LR)
    before = [(t, t.data_ptr()) for t in tree.leaves(eng.state.params)]
    eng.run(ReplaySource(port_txs(jtxs), START, batch_rows=BATCH,
                         with_labels=True), max_batches=2)
    after = tree.leaves(eng.state.params)
    assert all(a is t and a.data_ptr() == p
               for a, (t, p) in zip(after, before))
    assert not torch.equal(after[0], tree.leaves(tp)[0])


@pytest.mark.parametrize("kind", KINDS)
def test_feedback_sgd_matches_the_jax_engine(jtxs, kind):
    jeng, jout, teng, tout = _serve(kind, jtxs, 0.0)
    feats = features_of(tout)
    labels = np.asarray(jtxs.tx_fraud, np.int32).copy()
    labels[::7] = -1  # pending labels are never trained on
    for _ in range(2):
        jeng.apply_feedback(feats, labels)
        teng.apply_feedback(feats, labels)
    assert_params_close(teng.state.params, jeng.state.params)
    _, _, tp0, _ = pair(kind, 2)
    assert not torch.equal(tree.leaves(teng.state.params)[0],
                           tree.leaves(tp0)[0])
    assert teng._online_dirty


# -- artifacts and checkpoints, both ways ---------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_artifacts_move_both_ways(kind):
    jp, js, tp, ts = pair(kind, 6)
    jbytes = jart.dump_model_bytes(JTrainedModel(kind=kind, scaler=js,
                                                 params=jp))
    got = tart.load_model_bytes(jbytes, device="cpu")
    assert got.kind == kind
    assert_params_close(got.params, jp, atol=0.0)
    assert tree.structure(got.params) == tree.structure(tp)
    tbytes = tart.dump_model_bytes(tart.TrainedModel(kind=kind, scaler=ts,
                                                     params=tp))
    back = jart.load_model_bytes(tbytes)
    assert back.kind == kind
    assert_params_close(back.params, jp, atol=0.0)
    # the same content hash both ways: a file moves between the packages
    with np.load(io.BytesIO(tbytes)) as z:
        assert json.loads(str(z["__meta__"]))["content_sha256"] \
            == got.content_sha256


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoints_move_both_ways(jtxs, tmp_path, kind, direction):
    jcfg, tcfg = configs(2)
    jp, js, tp, ts = pair(kind, 2)
    d = str(tmp_path / "ck")
    jeng, _, teng, _ = _serve(kind, jtxs, LR, stop=3)
    if direction == "jax_to_port":
        jckpt.Checkpointer(d).save(jeng.state)
        fresh = ScoringEngine(tcfg, kind, tp, ts, device="cpu",
                              online_lr=LR)
        held = tree.leaves(fresh.state.params)
        assert tckpt.Checkpointer(d).restore(fresh.state) is not None
        # restored in place, into the engine's own tensors
        assert all(a is b for a, b in zip(tree.leaves(fresh.state.params),
                                          held))
        assert_params_close(fresh.state.params, jeng.state.params, 0.0)
        assert_state_equal(fresh.state.feature_state,
                           jeng.state.feature_state)
    else:
        tckpt.Checkpointer(d).save(teng.checkpoint_state())
        fresh = JScoringEngine(jcfg, kind=kind, params=jp, scaler=js,
                               online_lr=LR)
        assert jckpt.Checkpointer(d).restore(fresh.state) is not None
        assert_params_close(teng.state.params, fresh.state.params, 0.0)
        assert fresh.state.batches_done == 3


# -- the streaming learner and the shadow ---------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_learner_and_shadow_take_the_kind(kind, tmp_path):
    """A StreamingLearner fits an mlp or autoencoder candidate as the JAX
    learner does (the same backtracking SGD over the same window) and
    publishes it; the ShadowScorer dual-scores it as the JAX scorer does."""
    _, tcfg = configs(2)
    jcfg, _ = configs(2)
    jp, js, tp, ts = pair(kind, 8)
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(256, 15)) * SCALE + MEAN).astype(np.float32)
    y = (rng.random(256) < 0.3).astype(np.int32)
    kw = dict(publish_every_labels=200, window_rows=512, epochs=2)
    tl = StreamingLearner(kind, tp, ts, tcfg,
                          make_model_registry(str(tmp_path / "t")),
                          device="cpu", **kw)
    jl = JStreamingLearner(kind, jp, js, jcfg,
                           jmake_model_registry(str(tmp_path / "j")), **kw)
    try:
        for learner in (tl, jl):
            learner.submit(x, y)
            assert learner.drain(60.0)
        assert_params_close(tl._params, jl._params)
        assert tl.registry.versions() and jl.registry.versions()
        v = tl.registry.versions()[-1]
        cand = tl.registry.get(v)
        assert cand.kind == kind
        assert_params_close(cand.params, jl._params)
    finally:
        tl.close()
        jl.close()
    ts_ = ShadowScorer(kind, tcfg, capacity=1 << 10, device="cpu")
    js_ = JShadowScorer(kind, jcfg, capacity=1 << 10)
    ts_.set_candidate(2, cand.params, cand.scaler)
    js_.set_candidate(2, jl._params, js)
    ids = np.arange(256)
    champ = np.full(256, 0.1, np.float32)
    ts_.score_batch(ids, x, champ)
    js_.score_batch(ids, x, champ)
    np.testing.assert_allclose(ts_._cand_p[ids], js_._cand_p[ids],
                               atol=ATOL_PROB)
    assert ts_._has_cand[ids].all()


# -- the score command against the JAX package's --------------------------

@pytest.mark.parametrize("kind,flags", [
    ("mlp", ()), ("autoencoder", ()), ("mlp", ("--online-lr", "0.05")),
    ("autoencoder", ("--online-lr", "0.05"))],
    ids=["mlp", "autoencoder", "mlp-online-lr", "autoencoder-online-lr"])
def test_score_cli_writes_the_parquet_of_the_jax_score(jtxs, tmp_path,
                                                       capsys, kind, flags):
    pytest.importorskip("pyarrow")
    from real_time_fraud_detection_system_tpu.io.artifacts import (
        save_transactions as jsave_transactions,
    )

    jsave_transactions(str(tmp_path / "txs.npz"), jtxs)
    jp, js, _, _ = pair(kind, 2)
    with open(tmp_path / "m.npz", "wb") as f:
        f.write(jart.dump_model_bytes(JTrainedModel(kind=kind, scaler=js,
                                                    params=jp)))
    common = ["--data", str(tmp_path / "txs.npz"), "--model-file",
              str(tmp_path / "m.npz"), "--batch-rows", "512", *flags]
    assert jcli_main(["score", "--out", str(tmp_path / "j"), *common]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out",
                      str(tmp_path / "t"), *common]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["rows"] == jstats["rows"] == ROWS
    assert tstats["kind"] == kind
    jout = ParquetSink(str(tmp_path / "j")).read_all()
    tout = ParquetSink(str(tmp_path / "t")).read_all()
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction" or "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       atol=ATOL_PROB, rtol=1e-6,
                                       err_msg=col)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


@pytest.mark.parametrize("kind", KINDS)
def test_score_cli_learn_registry_for_the_kind(jtxs, tmp_path, capsys,
                                               kind):
    """``--learn-registry`` with an mlp or autoencoder: the model
    bootstraps as v1 with the streaming learner attached, in a registry
    either package opens, and the port serves the JAX registry's
    champion as the JAX ``score`` does."""
    pytest.importorskip("pyarrow")
    from real_time_fraud_detection_system_tpu.io.artifacts import (
        save_transactions as jsave_transactions,
    )

    jsave_transactions(str(tmp_path / "txs.npz"), jtxs)
    jp, js, _, _ = pair(kind, 2)
    with open(tmp_path / "m.npz", "wb") as f:
        f.write(jart.dump_model_bytes(JTrainedModel(kind=kind, scaler=js,
                                                    params=jp)))
    common = ["--data", str(tmp_path / "txs.npz"), "--model-file",
              str(tmp_path / "m.npz"), "--batch-rows", "512"]
    jreg, treg = tmp_path / "jreg", tmp_path / "treg"
    assert jcli_main(["score", "--learn-registry", str(jreg), "--out",
                      str(tmp_path / "j"), *common]) == 0
    assert tcli.main(["score", "--device", "cpu", "--learn-registry",
                      str(treg), "--out", str(tmp_path / "t"),
                      *common]) == 0
    assert tcli.main(["score", "--device", "cpu", "--learn-registry",
                      str(jreg), "--out", str(tmp_path / "tj"),
                      *common]) == 0
    capsys.readouterr()
    for reg in (make_model_registry(str(treg)),
                jmake_model_registry(str(jreg))):
        assert reg.versions() == [1] and reg.champion_version() == 1
        assert reg.meta(1)["kind"] == kind
    want = ParquetSink(str(tmp_path / "j")).read_all()["prediction"]
    for out in ("t", "tj"):
        np.testing.assert_allclose(
            ParquetSink(str(tmp_path / out)).read_all()["prediction"],
            want, atol=ATOL_PROB)
