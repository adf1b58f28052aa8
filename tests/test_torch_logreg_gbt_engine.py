"""Port parity: the logreg and gbt serving paths, engine against engine.

The port's ``ScoringEngine(device="cpu")`` and the JAX ``ScoringEngine``
serve the same ``ReplaySource`` slice of a small generated dataset, with
``use_pallas`` off (the JAX composition) and on (its Pallas kernels in
interpret mode: ``fused_featurize_score`` for logreg, ``pallas_leaf_sum``
for gbt). The weights travel as the JAX package's ``.npz`` artifact, read
by the port's ``io/artifacts.py``, so the port serves the artifact the
JAX package wrote.

Tolerances: counts, flags, bucket days and fraud sums bit-identical;
amount sums and averages within ``rtol=1e-6`` (float32 sums in another
order); logreg probabilities within ``atol=1e-6`` (the dot in another
order, the sigmoids by ulps), gbt probabilities within ``rtol=1e-5,
atol=1e-6`` (leaf sums over trees in another order), decisions identical.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.config import small_config
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
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
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    load_model_bytes,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble,
)
from real_time_fraud_detection_system_tpu_torch.models.gbt import (
    synthetic_gbt,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler,
)
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels
from real_time_fraud_detection_system_tpu_torch.ops import score_kernels
from real_time_fraud_detection_system_tpu_torch.runtime import engine
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
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
TOL_PROB = {"logreg": dict(rtol=0.0, atol=1e-6),
            "gbt": dict(rtol=1e-5, atol=1e-6)}
EXACT_FEATURE_COLS = ["tx_during_weekend", "tx_during_night"] + [
    f"{k}_id_nb_tx_{w}day_window" for k in ("customer", "terminal")
    for w in (1, 7, 30)] + [f"terminal_id_risk_{w}day_window"
                            for w in (1, 7, 30)]


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _configs(use_pallas: bool):
    base = small_config()
    jcfg = dataclasses.replace(base, runtime=JRuntimeConfig(
        batch_buckets=(64, 256), max_batch_rows=256, use_pallas=use_pallas))
    fields = {f.name: getattr(jcfg.features, f.name)
              for f in dataclasses.fields(FeatureConfig)}
    tcfg = Config(features=FeatureConfig(**fields),
                  runtime=RuntimeConfig(batch_buckets=(64, 256)))
    return jcfg, tcfg


def _stream_scaler(tcfg, txs):
    """A scaler fitted on the stream's own features (the features do not
    depend on the scaler), so the weights see realistic inputs."""
    probe = ScoringEngine(tcfg, "logreg",
                          LogRegParams(torch.zeros(15), torch.tensor(0.0)),
                          fit_scaler(np.zeros((2, 15)), device="cpu"),
                          device="cpu")
    src = ReplaySource(txs, START, batch_rows=256)
    feats = []
    while (cols := src.poll_batch()) is not None:
        feats.append(probe.process_batch(cols).features)
    return fit_scaler(np.concatenate(feats), device="cpu")


def _jax_params(kind):
    if kind == "logreg":
        rng = np.random.default_rng(9)
        return JLogRegParams(
            w=jnp.asarray(rng.normal(0, 0.8, 15).astype(np.float32)),
            b=jnp.float32(-1.0))
    return jgbt.synthetic_gbt(8, 4, 15, seed=3)


@pytest.fixture(scope="module", params=[
    ("logreg", False), ("logreg", True), ("gbt", False), ("gbt", True)],
    ids=["logreg-plain", "logreg-pallas", "gbt-plain", "gbt-pallas"])
def served(request, small_dataset):
    kind, use_pallas = request.param
    jtxs = small_dataset[3].slice(slice(0, ROWS))
    txs = _port_txs(jtxs)
    jcfg, tcfg = _configs(use_pallas)
    scaler = _stream_scaler(tcfg, txs)
    jscaler = JScaler(mean=jnp.asarray(scaler.mean.numpy()),
                      scale=jnp.asarray(scaler.scale.numpy()))
    jmodel = JTrainedModel(kind=kind, scaler=jscaler,
                           params=_jax_params(kind))

    jeng = JScoringEngine(jcfg, kind=kind, params=jmodel.params,
                          scaler=jscaler)
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=256), sink=jsink)

    # the JAX package's artifact, read by the port
    model = load_model_bytes(jdump_model_bytes(jmodel), device="cpu")
    teng = ScoringEngine(tcfg, model.kind, model.params, model.scaler,
                         device="cpu")
    tsink = MemorySink()
    launches = (score_kernels.fused_featurize_score.launches,
                forest_kernels.leaf_sum.launches,
                forest_kernels.fused_forest_leaf_sum.launches)
    stats = teng.run(ReplaySource(txs, START, batch_rows=256), tsink)
    after = (score_kernels.fused_featurize_score.launches,
             forest_kernels.leaf_sum.launches,
             forest_kernels.fused_forest_leaf_sum.launches)
    return dict(kind=kind, jeng=jeng, jout=jsink.concat(), teng=teng,
                tout=tsink.concat(), stats=stats,
                launched=np.subtract(after, launches))


def test_engine_outputs_match_jax_engine(served):
    kind, jout, tout = served["kind"], served["jout"], served["tout"]
    assert served["stats"]["rows"] == ROWS
    assert served["stats"]["batches"] == 3
    for col in ("tx_id", "tx_datetime_us", "customer_id", "terminal_id",
                "tx_amount", *EXACT_FEATURE_COLS):
        np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    for w in (1, 7, 30):
        col = f"customer_id_avg_amount_{w}day_window"
        np.testing.assert_allclose(tout[col], jout[col], rtol=RTOL_SUM_ORDER)
    np.testing.assert_allclose(tout["prediction"], jout["prediction"],
                               **TOL_PROB[kind])
    assert np.array_equal(tout["prediction"] >= 0.5,
                          jout["prediction"] >= 0.5)
    assert tout["prediction"].std() > 0  # the weights split the rows


def test_engine_final_state_matches_jax_engine(served):
    jeng, teng = served["jeng"], served["teng"]
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


def test_engine_takes_its_kernel_branch_and_counts_no_cpu_launch(served):
    teng = served["teng"]
    assert teng.tables is None  # never the fused forest kernel
    if served["kind"] == "gbt":
        assert teng.leaf_tables is not None  # the leaf-sum kernel's branch
    else:
        assert teng.leaf_tables is None  # the fused logreg kernel's branch
    # a CPU-device engine runs every kernel's plain version
    np.testing.assert_array_equal(served["launched"], [0, 0, 0])


@pytest.mark.parametrize("branch", ["fused", "leaf_sum", "plain"])
def test_forest_branches_agree(branch, small_dataset, monkeypatch):
    """The tree steps' branches, in the JAX order: forest takes the fused
    kernel and gbt the leaf-sum kernel when admit_tables holds, else the
    plain predict ("plain": a forest refused admission). Each is held
    against its kind's plain predict, forced by refusing admission; on the
    CPU they give the same probabilities, bit for bit (one matched leaf
    per tree; padded trees add 0)."""
    _, tcfg = _configs(False)
    txs = _port_txs(small_dataset[3]).slice(slice(0, 300))
    kind = "gbt" if branch == "leaf_sum" else "forest"
    model = (synthetic_gbt if kind == "gbt" else synthetic_ensemble)(
        6, 4, 15, seed=5, device="cpu")
    scaler = _stream_scaler(tcfg, txs)

    def serve():
        eng = ScoringEngine(tcfg, kind, model, scaler, device="cpu")
        sink = MemorySink()
        eng.run(ReplaySource(txs, START, batch_rows=128), sink)
        return eng, sink.concat()

    got_eng, got = serve()
    if branch == "plain":
        monkeypatch.setattr(engine, "admit_tables",
                            lambda g: forest_kernels.admit_tables(g, 0))
        got_eng, got = serve()
    assert (got_eng.tables is not None) == (branch == "fused")
    assert (got_eng.leaf_tables is not None) == (branch == "leaf_sum")
    monkeypatch.setattr(engine, "admit_tables",
                        lambda g: forest_kernels.admit_tables(g, 0))
    plain_eng, want = serve()
    assert plain_eng.tables is None and plain_eng.leaf_tables is None
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    assert got["prediction"].std() > 0
