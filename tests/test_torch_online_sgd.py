"""Port parity: the logreg loss, its gradient and the engine's in-step
online SGD, against the JAX package.

The same numpy inputs (made from a seed) go through the JAX function and
the port's. The engine cells serve the same labeled ``ReplaySource``
slice of the small generated dataset (in-band labels, 8 batches of 256
rows) through the JAX ``ScoringEngine(online_lr=...)`` and the port's
``ScoringEngine(device="cpu", online_lr=...)``, whose logreg step is the
fused kernel's plain version.

Tolerances, and why they hold:

- the loss within ``rtol=1e-6`` and its gradient within ``atol=1e-6``: the
  JAX logit is ``x @ w`` (XLA's dot), the port's the in-order sum the fused
  kernel computes, so each logit differs by a few ulps, and the mean over
  the batch adds them in another order;
- params after 8 SGD steps within ``atol=2e-6``: each step moves ``w`` by
  ``lr·g`` with ``|g| ≲ 1`` and the per-step difference is the gradient's
  few ulps times ``lr``; the differences add, they do not compound (the
  next gradient depends on ``w`` through a sigmoid whose slope is ≤ 1/4);
- probabilities within ``atol=1e-6`` (the logit's ulps through the
  sigmoid, as in ``tests/test_torch_logreg_gbt_engine.py``); counts,
  bucket days and fraud sums bit for bit;
- the port at depth 1 against depth 2: bit for bit (the update is inside
  the step, on the step's stream, so the depth does not reorder it).
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
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import logreg as jlogreg
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models import logreg as tlogreg
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.ops import score_kernels
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)

torch.set_num_threads(1)

START = 1_743_465_600
ROWS = 2048
BATCH = 256
LR = 0.05
ATOL_PARAMS = 2e-6
ATOL_PROB = 1e-6


# -- shared by the learning tests (test_torch_feedback.py, ...) -----------

def port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def configs(depth: int = 2, buckets=(256,), **features):
    """The same feature and runtime knobs for both packages."""
    fkw = {**dict(customer_capacity=256, terminal_capacity=512,
                  cms_width=1 << 10), **features}
    jcfg = JConfig(features=JFeatureConfig(**fkw),
                   runtime=JRuntimeConfig(batch_buckets=buckets,
                                          max_batch_rows=max(buckets),
                                          pipeline_depth=depth))
    tcfg = Config(features=FeatureConfig(**fkw),
                  runtime=RuntimeConfig(batch_buckets=buckets,
                                        max_batch_rows=max(buckets),
                                        pipeline_depth=depth))
    return jcfg, tcfg


def logreg_pair(seed: int = 9, bias: float = -1.0, scale=None):
    """(JAX params, JAX scaler, port params, port scaler) from a seed.
    ``scale`` standardizes the raw features roughly (the amounts are in
    dollars, the counts up to tens)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, 15).astype(np.float32)
    b = np.float32(bias)
    mean = np.zeros(15, np.float32)
    sc = np.ones(15, np.float32) if scale is None else \
        np.asarray(scale, np.float32)
    return (jlogreg.LogRegParams(w=jnp.asarray(w), b=jnp.asarray(b)),
            JScaler(mean=jnp.asarray(mean), scale=jnp.asarray(sc)),
            tlogreg.LogRegParams(torch.tensor(w), torch.tensor(b)),
            Scaler(torch.tensor(mean), torch.tensor(sc)))


# amounts in dollars up to hundreds, counts up to tens, risks in [0, 1]
FEATURE_SCALE = [1, 1, 2, 50, 10, 60, 40, 100, 80, 2, 1, 5, 1, 20, 1]


def params_np(p) -> tuple:
    return tuple(np.asarray(t) if not isinstance(t, torch.Tensor)
                 else t.numpy() for t in p)


def assert_state_equal(tfs, jfs, what=""):
    for table in ("customer", "terminal"):
        for name in ("bucket_day", "count", "fraud"):
            np.testing.assert_array_equal(
                getattr(getattr(tfs, table), name).numpy(),
                np.asarray(getattr(getattr(jfs, table), name)),
                err_msg=f"{what} {table}.{name}")
        np.testing.assert_allclose(
            tfs.__getattribute__(table).amount.numpy(),
            np.asarray(getattr(jfs, table).amount), rtol=1e-6,
            err_msg=f"{what} {table}.amount")


# -- the loss and its gradient --------------------------------------------

@pytest.mark.parametrize("seed,pos_weight", [(0, 1.0), (1, 1.0), (2, 5.0)])
def test_logreg_loss_and_gradient_match_jax(seed, pos_weight):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 2, (256, 15)).astype(np.float32)
    y = (rng.random(256) < 0.3).astype(np.int32)
    valid = rng.random(256) < 0.9
    jp, _, tp, _ = logreg_pair(seed)
    args_j = (jnp.asarray(x), jnp.asarray(y), jnp.asarray(valid))
    args_t = (torch.tensor(x), torch.tensor(y), torch.tensor(valid))
    lj = jlogreg.logreg_loss(jp, *args_j, pos_weight)
    gj = jax.grad(jlogreg.logreg_loss)(jp, *args_j, pos_weight)
    lt, gt = tlogreg.loss_grad(
        lambda p, *a: tlogreg.logreg_loss(p, *a, pos_weight=pos_weight),
        tp, *args_t)
    np.testing.assert_allclose(float(lt), float(lj), rtol=1e-6)
    np.testing.assert_allclose(gt.w.numpy(), np.asarray(gj.w), atol=1e-6)
    np.testing.assert_allclose(float(gt.b), float(gj.b), atol=1e-6)
    # the step itself: sgd_update against the JAX one
    sj = jlogreg.sgd_update(jp, *args_j, LR, pos_weight)
    st = tlogreg.sgd_update(tp, *args_t, LR, pos_weight)
    for a, b in zip(params_np(st), params_np(sj)):
        np.testing.assert_allclose(a, b, atol=1e-7)
    # the caller's leaves are never marked as requiring grad
    assert not tp.w.requires_grad and not tp.b.requires_grad


def test_logreg_loss_masks_every_padded_row():
    jp, _, tp, _ = logreg_pair(3)
    x = torch.randn(64, 15, generator=torch.Generator().manual_seed(0))
    y = torch.ones(64, dtype=torch.int32)
    none = torch.zeros(64, dtype=torch.bool)
    _, g = tlogreg.loss_grad(tlogreg.logreg_loss, tp, x, y, none)
    assert float(g.w.abs().max()) == 0.0 and float(g.b) == 0.0


# -- the engine's in-step SGD ---------------------------------------------

def _serve_jax(jtxs, depth, lr, jp, js, checkpointer=None, stop=0):
    jcfg, _ = configs(depth)
    eng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                         online_lr=lr)
    sink = JMemorySink()
    eng.run(JReplaySource(jtxs, START, batch_rows=BATCH, with_labels=True),
            sink=sink, max_batches=stop)
    return eng, sink.concat()


def _serve_port(txs, depth, lr, tp, ts, max_batches=0, engine=None,
                source=None):
    _, tcfg = configs(depth)
    eng = engine or ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                                  online_lr=lr)
    sink = MemorySink()
    src = source or ReplaySource(txs, START, batch_rows=BATCH,
                                 with_labels=True)
    eng.run(src, sink, max_batches=max_batches)
    return eng, sink.concat(), src


@pytest.fixture(scope="module")
def sgd_runs(small_dataset):
    jtxs = small_dataset[3].slice(slice(0, ROWS))
    txs = port_txs(jtxs)
    jp, js, tp, ts = logreg_pair(9, scale=FEATURE_SCALE)
    out = {}
    for depth in (1, 2):
        jeng, jout = _serve_jax(jtxs, depth, LR, jp, js)
        before = score_kernels.fused_featurize_score.launches
        teng, tout, _ = _serve_port(txs, depth, LR, tp, ts)
        out[depth] = dict(
            jeng=jeng, jout=jout, teng=teng, tout=tout,
            launched=score_kernels.fused_featurize_score.launches - before)
    out["jtxs"], out["txs"] = jtxs, txs
    out["params"] = (jp, js, tp, ts)
    return out


@pytest.mark.parametrize("depth", [1, 2])
def test_in_step_sgd_matches_the_jax_engine(sgd_runs, depth):
    run = sgd_runs[depth]
    jeng, teng = run["jeng"], run["teng"]
    assert teng.state.batches_done == jeng.state.batches_done == ROWS // BATCH
    # the params moved, and moved as the JAX engine's did
    _, _, tp0, _ = sgd_runs["params"]
    assert np.abs(teng.state.params.w.numpy() - tp0.w.numpy()).max() > 1e-3
    for a, b in zip(params_np(teng.state.params),
                    params_np(jeng.state.params)):
        np.testing.assert_allclose(a, b, atol=ATOL_PARAMS)
    np.testing.assert_allclose(run["tout"]["prediction"],
                               run["jout"]["prediction"], atol=ATOL_PROB)
    assert_state_equal(teng.state.feature_state, jeng.state.feature_state,
                       f"depth {depth}")
    # in-band labels: the online updates lead the artifact now
    assert teng._online_dirty
    # the CPU engine runs the kernel's plain version (no launch counted)
    assert run["launched"] == 0


def test_in_step_sgd_depth_1_equals_depth_2_bit_for_bit(sgd_runs):
    a, b = sgd_runs[1], sgd_runs[2]
    for x, y in zip(params_np(a["teng"].state.params),
                    params_np(b["teng"].state.params)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(a["tout"]["prediction"],
                                  b["tout"]["prediction"])


def test_in_step_sgd_writes_the_params_in_place(sgd_runs):
    _, _, tp, ts = sgd_runs["params"]
    _, tcfg = configs(2)
    eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu", online_lr=LR)
    w, b = eng.state.params.w, eng.state.params.b
    ptr = w.data_ptr()
    eng.state.params_crcs = {"p_0": 0}
    _serve_port(sgd_runs["txs"], 2, LR, tp, ts, max_batches=2, engine=eng)
    assert eng.state.params.w is w and eng.state.params.b is b
    assert w.data_ptr() == ptr
    assert not torch.equal(w, tp.w)
    # stale checksums are dropped once the leaves change
    assert eng.state.params_crcs is None


def test_online_lr_zero_leaves_the_params_alone(sgd_runs):
    _, _, tp, ts = sgd_runs["params"]
    eng, _, _ = _serve_port(sgd_runs["txs"], 2, 0.0, tp, ts, max_batches=3)
    np.testing.assert_array_equal(eng.state.params.w.numpy(), tp.w.numpy())
    assert not eng._online_dirty


# -- checkpoints after SGD, and model_version across the packages ---------

def test_checkpoint_after_sgd_restores_the_updated_params(sgd_runs,
                                                          tmp_path):
    _, _, tp, ts = sgd_runs["params"]
    _, tcfg = configs(2)
    eng, _, src = _serve_port(sgd_runs["txs"], 2, LR, tp, ts, max_batches=4)
    eng.state.model_version = 5
    ck = tckpt.Checkpointer(str(tmp_path / "ck"))
    ck.save(eng.checkpoint_state())
    fresh = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu", online_lr=LR)
    w = fresh.state.params.w
    assert ck.restore(fresh.state) is not None
    assert fresh.state.params.w is w  # restored in place
    for a, b in zip(params_np(fresh.state.params),
                    params_np(eng.state.params)):
        np.testing.assert_array_equal(a, b)
    assert fresh.state.model_version == 5
    # the restored engine serves the rest exactly as the uninterrupted one
    _serve_port(None, 2, LR, tp, ts, engine=eng, source=src)
    src2 = ReplaySource(sgd_runs["txs"], START, batch_rows=BATCH,
                        with_labels=True)
    src2.seek(fresh.state.offsets)
    _serve_port(None, 2, LR, tp, ts, engine=fresh, source=src2)
    for a, b in zip(params_np(fresh.state.params),
                    params_np(eng.state.params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_model_version_moves_between_the_packages(sgd_runs, tmp_path,
                                                  direction):
    jp, js, tp, ts = sgd_runs["params"]
    jcfg, tcfg = configs(2)
    jtxs, txs = sgd_runs["jtxs"], sgd_runs["txs"]
    d = str(tmp_path / "ck")
    if direction == "jax_to_port":
        jeng, _ = _serve_jax(jtxs, 2, LR, jp, js, stop=3)
        jeng.state.model_version = 7
        jckpt.Checkpointer(d).save(jeng.state)
        eng = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu",
                            online_lr=LR)
        assert tckpt.Checkpointer(d).restore(eng.state) is not None
        assert eng.state.model_version == 7
        for a, b in zip(params_np(eng.state.params),
                        params_np(jeng.state.params)):
            np.testing.assert_array_equal(a, b)
    else:
        eng, _, _ = _serve_port(txs, 2, LR, tp, ts, max_batches=3)
        eng.state.model_version = 11
        tckpt.Checkpointer(d).save(eng.checkpoint_state())
        jeng = JScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                              online_lr=LR)
        assert jckpt.Checkpointer(d).restore(jeng.state) is not None
        assert jeng.state.model_version == 11
        for a, b in zip(params_np(jeng.state.params),
                        params_np(eng.state.params)):
            np.testing.assert_array_equal(a, b)
    # a checkpoint without a stamp keeps the template's value
    arrays, meta = tckpt._state_arrays(eng.state)
    meta = {k: v for k, v in meta.items() if k != "model_version"}
    fresh = ScoringEngine(tcfg, "logreg", tp, ts, device="cpu")
    fresh.state.model_version = 3
    tckpt._apply_arrays(fresh.state, meta, arrays)
    assert fresh.state.model_version == 3


def test_configs_match_the_jax_defaults():
    from real_time_fraud_detection_system_tpu.config import (
        LearnConfig as JLearnConfig,
    )
    from real_time_fraud_detection_system_tpu.config import (
        TrainConfig as JTrainConfig,
    )
    from real_time_fraud_detection_system_tpu_torch.config import (
        LearnConfig,
        TrainConfig,
    )

    assert dataclasses.asdict(LearnConfig()) == \
        dataclasses.asdict(JLearnConfig())
    assert TrainConfig().online_learning_rate == \
        JTrainConfig().online_learning_rate
    assert Config().learn == LearnConfig() and Config().train == TrainConfig()
