"""Port parity: the whole serving slice, engine against engine.

The port's ``ScoringEngine(device="cpu")`` and the JAX ``ScoringEngine``
with ``use_pallas`` on (its fused forest kernel in interpret mode) serve
the same ``ReplaySource`` slice of a small generated dataset, with the
same synthetic forest and scaler carried across by ``weights.from_numpy``.

Tolerances: counts, flags, bucket days and fraud sums bit-identical;
amount sums and averages within ``rtol=1e-6`` (float32 sums in another
order); probabilities within ``atol=1e-6`` (leaf sums over trees in
another order, divided by the tree count) with identical decisions.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.config import small_config
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ReplaySource as JReplaySource,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ScoringEngine as JScoringEngine,
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
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler,
)
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    PoisonRowError,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)

# Tiny shapes: one intra-op thread each keeps the parallel test workers'
# cores free for the timing-sensitive tests beside them.
torch.set_num_threads(1)

START = 1_743_465_600
ROWS = 600
RTOL_SUM_ORDER = 1e-6
ATOL_PROB = 1e-6
EXACT_FEATURE_COLS = ["tx_during_weekend", "tx_during_night"] + [
    f"{k}_id_nb_tx_{w}day_window" for k in ("customer", "terminal")
    for w in (1, 7, 30)] + [f"terminal_id_risk_{w}day_window"
                            for w in (1, 7, 30)]


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _configs():
    base = small_config()
    jcfg = dataclasses.replace(base, runtime=JRuntimeConfig(
        batch_buckets=(64, 256), max_batch_rows=256, use_pallas=True))
    assert isinstance(jcfg.features, JFeatureConfig)
    fields = {f.name: getattr(jcfg.features, f.name)
              for f in dataclasses.fields(FeatureConfig)}
    tcfg = Config(features=FeatureConfig(**fields),
                  runtime=RuntimeConfig(batch_buckets=(64, 256)))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def served(small_dataset):
    _, _, _, jtxs = small_dataset
    jtxs = jtxs.slice(slice(0, ROWS))
    txs = _port_txs(jtxs)
    jcfg, tcfg = _configs()
    ens = jforest.synthetic_ensemble(10, 5, 15, seed=3)
    tens = weights.from_numpy(jax.tree.map(np.asarray, ens), device="cpu")

    # a scaler fitted on this stream's own features (the features do not
    # depend on the scaler), so the random thresholds split real rows
    probe = ScoringEngine(tcfg, "forest", tens,
                          fit_scaler(np.zeros((2, 15)), device="cpu"),
                          device="cpu")
    src = ReplaySource(txs, START, batch_rows=256)
    feats = []
    while (cols := src.poll_batch()) is not None:
        feats.append(probe.process_batch(cols).features)
    scaler = fit_scaler(np.concatenate(feats), device="cpu")
    jscaler = JScaler(mean=jnp.asarray(scaler.mean.numpy()),
                      scale=jnp.asarray(scaler.scale.numpy()))

    jeng = JScoringEngine(jcfg, kind="forest", params=ens, scaler=jscaler)
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=256), sink=jsink)

    teng = ScoringEngine(tcfg, "forest", tens, scaler, device="cpu")
    tsink = MemorySink()
    stats = teng.run(ReplaySource(txs, START, batch_rows=256), tsink)
    return jeng, jsink.concat(), teng, tsink.concat(), stats


def test_engine_outputs_match_jax_engine(served):
    _, jout, teng, tout, stats = served
    assert stats["rows"] == ROWS and stats["batches"] == 3
    assert teng.tables is not None  # the fused step served
    for col in ("tx_id", "tx_datetime_us", "customer_id", "terminal_id",
                "tx_amount", *EXACT_FEATURE_COLS):
        np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    for w in (1, 7, 30):
        col = f"customer_id_avg_amount_{w}day_window"
        np.testing.assert_allclose(tout[col], jout[col], rtol=RTOL_SUM_ORDER)
    np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                               atol=ATOL_PROB)
    assert np.array_equal(tout["prediction"] >= 0.5,
                          jout["prediction"] >= 0.5)
    assert tout["prediction"].std() > 0  # the thresholds split the rows


def test_engine_final_state_matches_jax_engine(served):
    jeng, _, teng, _, _ = served
    for table in ("customer", "terminal"):
        jws = getattr(jeng.state.feature_state, table)
        tws = getattr(teng.state.feature_state, table)
        for name in ("bucket_day", "count", "fraud"):
            np.testing.assert_array_equal(
                getattr(tws, name).numpy(), np.asarray(getattr(jws, name)),
                err_msg=f"{table}.{name}")
        np.testing.assert_allclose(tws.amount.numpy(),
                                   np.asarray(jws.amount),
                                   rtol=RTOL_SUM_ORDER)
    assert teng.state.rows_done == jeng.state.rows_done
    assert teng.state.batches_done == jeng.state.batches_done


def test_feature_state_carries_across_from_jax(served):
    jeng, _, teng, _, _ = served
    moved = weights.from_numpy(
        jax.tree.map(np.asarray, jeng.state.feature_state), device="cpu")
    np.testing.assert_array_equal(moved.terminal.count.numpy(),
                                  teng.state.feature_state.terminal.count
                                  .numpy())


def test_engine_cpu_path_never_counts_a_launch(small_dataset):
    _, tcfg = _configs()
    ens = weights.from_numpy(jax.tree.map(
        np.asarray, jforest.synthetic_ensemble(4, 3, 15, seed=1)),
        device="cpu")
    eng = ScoringEngine(tcfg, "forest", ens,
                        fit_scaler(np.ones((2, 15)), device="cpu"),
                        device="cpu")
    before = forest_kernels.fused_forest_leaf_sum.launches
    eng.run(ReplaySource(_port_txs(small_dataset[3]).slice(slice(0, 100)),
                         START, batch_rows=64))
    assert forest_kernels.fused_forest_leaf_sum.launches == before


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    _, tcfg = _configs()
    ens = weights.from_numpy(jax.tree.map(
        np.asarray, jforest.synthetic_ensemble(2, 2, 15)), device="cpu")
    scaler = fit_scaler(np.ones((2, 15)), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ScoringEngine(tcfg, "forest", ens, scaler)
    with pytest.raises(RuntimeError, match="CUDA"):
        fit_scaler(np.ones((2, 15)))


def test_engine_refuses_bad_rows_and_unported_kinds():
    _, tcfg = _configs()
    ens = weights.from_numpy(jax.tree.map(
        np.asarray, jforest.synthetic_ensemble(2, 2, 15)), device="cpu")
    scaler = fit_scaler(np.ones((2, 15)), device="cpu")
    # every kind of the zoo is served; an unknown one is refused
    with pytest.raises(ValueError, match="unknown model kind"):
        ScoringEngine(tcfg, "lstm", ens, scaler, device="cpu")
    eng = ScoringEngine(tcfg, "forest", ens, scaler, device="cpu")
    cols = {"tx_id": np.arange(3), "kafka_ts_ms": np.arange(3),
            "tx_datetime_us": np.full(3, START * 10 ** 6),
            "customer_id": np.arange(3), "terminal_id": np.arange(3),
            "tx_amount_cents": np.asarray([5, -1, 7])}
    with pytest.raises(PoisonRowError, match="negative"):
        eng.process_batch(cols)
    assert eng.state.batches_done == 0
