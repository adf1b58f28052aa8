"""Port parity: the CPU oracle — ``TrainedModel.predict_proba_np`` of both
packages on the same artifact and rows, and the port's ``score --scorer
cpu`` against the JAX ``score --scorer cpu``, column by column, for
logreg, mlp, forest and gbt, with the JAX refusals (exit 2).

Tolerances: ``predict_proba_np`` bit-identical (the same NumPy operations
in the same order on the same float32 inputs); the ``score`` outputs'
ids, counts, flags and risks bit-identical, customer amount averages
within ``rtol=1e-6`` (float32 window sums in another order) and
probabilities within ``atol=1e-7`` for the forest (leaf means: only a
feature on the other side of a split could move one) and ``1e-6`` for
the others (a sigmoid of features that differ in their last bits).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    load_model as jload_model,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.models import autoencoder as jae
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models import mlp as jmlp
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    load_model,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    MemorySink,
    ParquetSink,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
    check_sequence_serving,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)

torch.set_num_threads(1)

EPOCH0 = 1_743_465_600
RTOL_SUM_ORDER = 1e-6
ATOL_PROB = {"forest": 1e-7, "logreg": 1e-6, "mlp": 1e-6, "gbt": 1e-6}
# The small dataset's feature means and deviations, rounded, so scaled
# rows are O(1) for every kind.
MEAN = np.array([55, 0.3, 0.2, 1.5, 55, 8, 55, 30, 55, 1.5, 0.05, 8, 0.05,
                 30, 0.05], np.float32)
SCALE = np.array([45, 0.45, 0.4, 1.0, 35, 3, 25, 8, 20, 1.2, 0.2, 3, 0.1,
                  8, 0.05], np.float32)


def _jax_model(kind: str):
    scaler = JScaler(jnp.asarray(MEAN), jnp.asarray(SCALE))
    rng = np.random.default_rng(9)
    if kind == "logreg":
        params = JLogRegParams(
            w=jnp.asarray(rng.normal(0, 0.8, 15).astype(np.float32)),
            b=jnp.float32(-1.0))
    elif kind == "mlp":
        params = jmlp.init_mlp(15, (16, 8), seed=3)
    elif kind == "autoencoder":
        params = jae.init_autoencoder(15, (8, 4), seed=3)._replace(
            err_scale=jnp.asarray(0.6, jnp.float32))
    elif kind in ("forest", "tree"):
        params = jforest.synthetic_ensemble(10 if kind == "forest" else 1,
                                            5, 15, seed=3)
    else:
        g = jgbt.synthetic_gbt(8, 4, 15, seed=3)
        params = g._replace(trees=g.trees._replace(
            prob=0.1 * (g.trees.prob - 0.5)))
    return JTrainedModel(kind=kind, scaler=scaler, params=params)


@pytest.fixture(scope="module")
def files(small_dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("cpu_scorer")
    jsave_transactions(str(d / "txs.npz"), small_dataset[3].slice(
        slice(0, 3000)))
    for kind in ("logreg", "mlp", "autoencoder", "tree", "forest", "gbt"):
        with open(d / f"{kind}.npz", "wb") as f:
            f.write(jdump_model_bytes(_jax_model(kind)))
    return d


@pytest.mark.parametrize("kind", ["logreg", "mlp", "autoencoder", "tree",
                                  "forest", "gbt"])
def test_predict_proba_np_is_the_jax_packages(files, kind):
    """One artifact, loaded by each package: the host scorer's outputs on
    the same raw rows are bit-identical."""
    rng = np.random.default_rng(4)
    rows = (MEAN + SCALE * rng.normal(size=(777, 15))).astype(np.float32)
    rows[::7] = MEAN  # rows sitting on the scaler's centre
    jm = jload_model(str(files / f"{kind}.npz"))
    tm = load_model(str(files / f"{kind}.npz"), device="cpu")
    want = jm.predict_proba_np(rows.astype(np.float64))
    got = tm.predict_proba_np(rows.astype(np.float64))
    assert got.dtype == want.dtype and got.shape == (777,)
    np.testing.assert_array_equal(got, want)
    # cached host params: a second call reads no tensor again
    assert tm._np_cache is not None
    np.testing.assert_array_equal(tm.predict_proba_np(rows), got)


def _score(d, kind, flags, capsys, tmp):
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / f"{kind}.npz"), "--batch-rows", "1024", *flags]
    jdir, tdir = tmp / f"jax-{kind}", tmp / f"port-{kind}"
    assert jcli_main(["score", "--out", str(jdir), *common]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out", str(tdir),
                      *common]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return (jstats, tstats, ParquetSink(str(jdir)).read_all(),
            ParquetSink(str(tdir)).read_all())


@pytest.mark.parametrize("kind", ["logreg", "mlp", "forest", "gbt"])
def test_score_cpu_scorer_writes_the_parquet_of_the_jax_score(
        files, capsys, tmp_path, kind):
    jstats, tstats, jout, tout = _score(files, kind, ["--scorer", "cpu"],
                                        capsys, tmp_path)
    assert tstats["rows"] == jstats["rows"] == 3000
    assert tstats["scorer"] == jstats["scorer"] == "cpu"
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], rtol=0.0,
                                       atol=ATOL_PROB[kind])
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)
    assert tout["prediction"].std() > 0


@pytest.mark.parametrize("flags", [
    ("--alerts-only",), ("--emit-bf16",), ("--emit-threshold", "0.5"),
    ("--reload-model-every", "2"), ("--learn-registry", "reg")],
    ids=["alerts-only", "bf16", "selective", "reload", "learn"])
def test_score_cpu_scorer_refusals_match_jax(files, capsys, tmp_path, flags):
    common = ["score", "--data", str(files / "txs.npz"), "--model-file",
              str(files / "forest.npz"), "--scorer", "cpu",
              "--out", str(tmp_path / "o"), *flags]
    assert jcli_main(common) == 2
    assert tcli.main(common + ["--device", "cpu"]) == 2
    capsys.readouterr()


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def test_engine_cpu_scorer_rescores_the_emitted_features(files,
                                                         small_dataset):
    """``scorer="cpu"``: the step runs as ever (the fused forest path,
    its kernel's plain version on the CPU), and every probability is
    ``predict_proba_np`` of the row's emitted features."""
    from real_time_fraud_detection_system_tpu_torch.ops import (
        forest_kernels,
    )

    model = load_model(str(files / "forest.npz"), device="cpu")
    cfg = Config(features=FeatureConfig(customer_capacity=256,
                                        terminal_capacity=512),
                 runtime=RuntimeConfig(batch_buckets=(256, 1024)))
    eng = ScoringEngine(cfg, "forest", model.params, model.scaler,
                        device="cpu", scorer="cpu", cpu_model=model)
    assert eng.tables is not None  # the fused branch
    sink = MemorySink()
    forest_kernels.fused_forest_leaf_sum.launches = 0
    stats = eng.run(ReplaySource(_port_txs(small_dataset[3].slice(
        slice(0, 2048))), EPOCH0, batch_rows=1024), sink)
    assert stats["batches"] == 2
    for b in sink.batches:
        feats = np.stack([b["tx_amount"]] + [
            b[k] for k in b if k.startswith(("tx_during", "customer_id_",
                                             "terminal_id_"))], axis=1)
        np.testing.assert_array_equal(
            b["prediction"],
            model.predict_proba_np(feats.astype(np.float32)
                                   .astype(np.float64)))


@pytest.mark.parametrize("what", ["no-model", "alerts-only", "bf16",
                                  "selective", "sequence", "unknown"])
def test_engine_cpu_scorer_refusals_match_jax(files, what):
    """The engine refuses what the JAX engine refuses with the CPU
    scorer, with its messages."""
    model = load_model(str(files / "forest.npz"), device="cpu")
    rt = {"alerts-only": {"emit_features": False},
          "bf16": {"emit_dtype": "bfloat16"},
          "selective": {"emit_threshold": 0.5}}.get(what, {})
    cfg = Config(features=FeatureConfig(customer_capacity=256,
                                        terminal_capacity=512),
                 runtime=RuntimeConfig(batch_buckets=(256,), **rt))
    kw = {"scorer": "gpu" if what == "unknown" else "cpu",
          "cpu_model": None if what == "no-model" else model}
    if what == "sequence":
        with pytest.raises(ValueError, match="--scorer cpu does not apply"):
            check_sequence_serving(cfg, scorer="cpu")
        return
    with pytest.raises(ValueError, match={
            "no-model": "cpu_model", "alerts-only": "alerts-only",
            "bf16": "bfloat16", "selective": "selective",
            "unknown": "scorer must be"}[what]):
        ScoringEngine(cfg, "forest", model.params, model.scaler,
                      device="cpu", **kw)
