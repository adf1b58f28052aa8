"""Port parity: ``score --devices N`` (the sharded engine, its N shards on
the one ``--device``; with ``--key-mode exact`` the tiered store per
shard) against the JAX package's ``score --devices N`` on the
8-virtual-device CPU mesh, and the flags the sharded ``score`` refuses.

Tolerances: the Parquet columns bit for bit (the forest's probabilities
within ``atol=1e-6``: the port's tree kinds score through the leaf-sum
kernel's plain version, which adds the trees in another order), amount
averages within ``rtol=1e-6`` (cent amounts added in another order).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.io.artifacts import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.io.sink import ParquetSink
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    TrainedModel,
    dump_model_bytes,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    init_transformer,
)

ATOL_PROB = 1e-6
RTOL_SUM_ORDER = 1e-6


@pytest.fixture(scope="module")
def files(small_dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("sharded_score")
    jsave_transactions(str(d / "txs.npz"),
                       small_dataset[3].slice(slice(0, 3000)))
    rng = np.random.default_rng(3)
    scaler = JScaler(jnp.asarray(rng.normal(3, 1, 15).astype(np.float32)),
                     jnp.asarray(rng.uniform(0.5, 3, 15)
                                 .astype(np.float32)))
    with open(d / "forest.npz", "wb") as f:
        f.write(jdump_model_bytes(JTrainedModel(
            kind="forest", scaler=scaler,
            params=jforest.synthetic_ensemble(10, 5, 15, seed=3))))
    import torch

    seq = TrainedModel("sequence", Scaler(torch.zeros(15), torch.ones(15)),
                       init_transformer(d_model=8, n_layers=1, d_ff=8,
                                        device="cpu"))
    with open(d / "sequence.npz", "wb") as f:
        f.write(dump_model_bytes(seq))
    return d


def _assert_outputs(tout: dict, jout: dict) -> None:
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], rtol=0.0,
                                       atol=ATOL_PROB)
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            assert tout[col].dtype == jout[col].dtype, col
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


@pytest.mark.parametrize("flags", [
    ("--devices", "4"),
    ("--devices", "8", "--max-batch-rows", "512"),
    ("--devices", "4", "--key-mode", "hash", "--alerts-only"),
    ("--devices", "4", "--key-mode", "exact", "--state-compact-every", "2"),
    ("--devices", "2", "--key-mode", "exact", "--state-compact-every", "1",
     "--cold-store", "COLD"),
], ids=["devices4", "devices8-max-rows", "devices4-hash-alerts",
        "devices4-exact-compact2", "devices2-exact-cold"])
def test_score_devices_writes_the_parquet_of_the_jax_score(files, capsys,
                                                           flags):
    d = files
    tag = "-".join(f.strip("-") for f in flags)

    def common(pkg):
        # each package its own cold store
        return ["--data", str(d / "txs.npz"), "--model-file",
                str(d / "forest.npz"), "--batch-rows", "1024",
                *[str(d / f"cold-{pkg}-{tag}") if f == "COLD" else f
                  for f in flags]]

    jdir, tdir = d / f"jax-{tag}", d / f"port-{tag}"
    assert jcli_main(["score", "--out", str(jdir), *common("jax")]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out", str(tdir),
                      *common("port")]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["rows"] == jstats["rows"] == 3000
    assert tstats["batches"] == jstats["batches"]
    assert "full_exchange_chunks" in tstats
    _assert_outputs(ParquetSink(str(tdir)).read_all(),
                    ParquetSink(str(jdir)).read_all())


@pytest.mark.parametrize("flags", [
    ("--nan-guard", "--dead-letter", "DLQ"),
    ("--max-batch-rows", "-1"),
    ("--learn-registry", "REG"),
    ("--scorer", "cpu"),
], ids=["nan-guard", "max-batch-rows", "learn-registry", "scorer-cpu"])
def test_sharded_score_refuses_what_the_jax_score_refuses(files, capsys,
                                                          tmp_path, flags):
    d = files
    flags = [str(tmp_path / f.lower()) if f in ("DLQ", "REG") else f
             for f in flags]
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), "--devices", "4", *flags]
    assert jcli_main(["score", *common]) == 2
    capsys.readouterr()
    assert tcli.main(["score", "--device", "cpu", *common]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("model,flags,item", [
    ("forest", ("--num-processes", "2"), "--process-id"),
    ("forest", ("--coordinator", "127.0.0.1:1", "--num-processes", "0"),
     "--num-processes must be >= 1"),
    ("forest", ("--devices", "4", "--resume-merge", "x"),
     "OLD_CKPT_ROOT:P:L:REASON"),
    ("sequence", ("--num-processes", "2", "--process-id", "0"),
     "not wired for kind='sequence'"),
], ids=["num-processes", "coordinator", "resume-merge", "sequence"])
def test_sharded_score_names_the_item_it_waits_for(files, caplog, model,
                                                   flags, item):
    """The fleet's flags exit 2 where the JAX ``score`` refuses them (a
    fleet member with no id, no processes, a malformed merge spec), with
    its message; so is the sequence kind in a fleet (the JAX ``score``
    serves it over shards, not over processes)."""
    d = files
    assert tcli.main(["score", "--device", "cpu", "--data",
                      str(d / "txs.npz"), "--model-file",
                      str(d / f"{model}.npz"), *flags]) == 2
    assert item in caplog.text
