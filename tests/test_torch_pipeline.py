"""The port's demo pipeline (``runtime/pipeline.py``) and profile envelopes
(``core/envelope.py``) against the JAX package's, on the CPU.

The envelopes are the JAX bytes, and decode to the same columns and
malformed-row mask. ``sink_dimension_topic`` MERGEs the same dimension
tables. ``run_demo`` at 80 customers and 160 terminals, with one forest
the JAX package trained (its artifact read by both), gives the JAX
summary: counts exact, ``stream_auc`` within 1e-6, and the analyzed
Parquet and the raw table equal column by column (``processed_at_us``
is a wall-clock stamp; the window amount averages within the float32
summation-order tolerance of the score parity tests, the probabilities
within theirs with the same decisions); the same on two shards, and for
a horizon that leaves nothing to stream.
"""

import numpy as np
import pytest

import real_time_fraud_detection_system_tpu.config as jconfig
import real_time_fraud_detection_system_tpu_torch.config as tconfig
from real_time_fraud_detection_system_tpu.core import envelope as jenv
from real_time_fraud_detection_system_tpu.core.schema import (
    CUSTOMERS as JCUSTOMERS,
)
from real_time_fraud_detection_system_tpu.runtime import pipeline as jpipe
from real_time_fraud_detection_system_tpu_torch.core import envelope as tenv
from real_time_fraud_detection_system_tpu_torch.core.schema import (
    CUSTOMERS,
    TERMINALS,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    load_model,
)
from real_time_fraud_detection_system_tpu_torch.runtime import (
    pipeline as tpipe,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    InProcBroker,
)
from test_torch_serving_loop import _assert_outputs  # pytest adds tests/

ATOL_AUC = 1e-6
TIMING_KEYS = ("rows_per_s", "latency_p50_ms", "latency_p99_ms", "wall_s")


def demo_config(C, n_days=40, **train):
    """The JAX pipeline test's demo size, with small batch buckets (the
    warm-up's one batch and the stream's 1,024-row batches fit them)."""
    train = {"delta_train_days": 15, "delta_delay_days": 5,
             "delta_test_days": 5, "epochs": 2, "batch_size": 512, **train}
    return C.Config(
        data=C.DataConfig(n_customers=80, n_terminals=160, n_days=n_days,
                          seed=3),
        features=C.FeatureConfig(customer_capacity=256,
                                 terminal_capacity=512, cms_width=1 << 10),
        train=C.TrainConfig(**train),
        runtime=C.RuntimeConfig(batch_buckets=(1024, 4096),
                                max_batch_rows=4096))


@pytest.fixture(scope="module")
def forest_file(tmp_path_factory):
    """One forest the JAX package trains on the demo's data; both packages
    read its artifact."""
    pytest.importorskip("sklearn", reason="training a forest needs sklearn")
    from real_time_fraud_detection_system_tpu.data import generate_dataset
    from real_time_fraud_detection_system_tpu.io.artifacts import save_model
    from real_time_fraud_detection_system_tpu.models.train import (
        train_model,
    )

    cfg = demo_config(jconfig)
    _, _, txs = generate_dataset(cfg.data)
    model, _ = train_model(txs, cfg, kind="forest")
    path = str(tmp_path_factory.mktemp("model") / "forest.npz")
    save_model(path, model)
    return path


@pytest.fixture(scope="module")
def demos(forest_file, tmp_path_factory):
    """Both packages' demos, single and on two shards, with ``out_dir``."""
    from real_time_fraud_detection_system_tpu.io.artifacts import (
        load_model as jload,
    )

    root = tmp_path_factory.mktemp("demo")
    out = {}
    for n in (1, 2):
        out[("jax", n)] = jpipe.run_demo(
            demo_config(jconfig), model=jload(forest_file),
            out_dir=str(root / f"jax{n}"), batch_rows=1024, n_devices=n)
        out[("port", n)] = tpipe.run_demo(
            demo_config(tconfig), model=load_model(forest_file,
                                                   device="cpu"),
            out_dir=str(root / f"port{n}"), batch_rows=1024, n_devices=n,
            device="cpu")
    return root, out


def _profile_cols():
    rng = np.random.default_rng(0)
    return {"customer_id": np.arange(1, 6, dtype=np.int64),
            "x_location": rng.uniform(0, 100, 5),
            "y_location": rng.uniform(0, 100, 5)}


def test_profile_envelopes_are_the_jax_bytes():
    cols = _profile_cols()
    want = jenv.encode_profile_envelopes("customers", cols, ts_ms=123)
    assert tenv.encode_profile_envelopes("customers", cols, ts_ms=123) \
        == want
    assert tenv.encode_profile_envelope(
        "terminals", {"terminal_id": 7, "x_location": 1.5}, op="u",
        ts_ms=9) == jenv.encode_profile_envelope(
        "terminals", {"terminal_id": 7, "x_location": 1.5}, op="u",
        ts_ms=9)


def test_profile_decode_and_malformed_mask_match_jax():
    cols = _profile_cols()
    good = jenv.encode_profile_envelopes("customers", cols)
    msgs = [b"not json", b'{"payload": null}', good[0],
            b'{"payload": {"after": {"customer_id": 9}}}',
            b'{"payload": {"op": "d", "before": {"customer_id": 4, '
            b'"x_location": 1.0, "y_location": 2.0}}}', *good[1:]]
    ts = list(range(len(msgs)))
    got, got_bad = tenv.decode_profile_envelopes(msgs, CUSTOMERS.fields, ts)
    want, want_bad = jenv.decode_profile_envelopes(msgs, JCUSTOMERS.fields,
                                                   ts)
    np.testing.assert_array_equal(got_bad, want_bad)
    np.testing.assert_array_equal(got_bad[:5], [True, True, False, True,
                                                False])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    got, _ = tenv.decode_profile_envelopes(msgs, CUSTOMERS.fields)
    assert (got["kafka_ts_ms"] == 0).all()


def test_sink_dimension_topic_merges_the_jax_tables():
    from real_time_fraud_detection_system_tpu.core.schema import (
        TERMINALS as JTERMINALS,
    )
    from real_time_fraud_detection_system_tpu.runtime.sources import (
        InProcBroker as JBroker,
    )

    rng = np.random.default_rng(1)
    ids = rng.integers(0, 40, 120)  # repeated keys: later versions win
    cols = {"terminal_id": ids, "x_location": rng.uniform(0, 100, 120),
            "y_location": rng.uniform(0, 100, 120)}
    ts = np.arange(120) * 10
    msgs = [jenv.encode_profile_envelope(
        "terminals", {k: v[i] for k, v in cols.items()}, ts_ms=int(ts[i]))
        for i in range(120)]
    keys = [str(int(k)).encode() for k in ids]
    tables = []
    for broker, sink, schema in (
            (InProcBroker(4), tpipe.sink_dimension_topic, TERMINALS),
            (JBroker(4), jpipe.sink_dimension_topic, JTERMINALS)):
        broker.produce_many("t", keys, msgs, ts_ms=list(map(int, ts)))
        tables.append(sink(broker, "t", schema, batch_rows=16))
    got, want = (t.to_columns() for t in tables)
    assert len(tables[0]) == len(tables[1]) == len(np.unique(ids))
    order_g = np.argsort(got["terminal_id"])
    order_w = np.argsort(want["terminal_id"])
    for k in want:
        np.testing.assert_array_equal(got[k][order_g], want[k][order_w],
                                      err_msg=k)


@pytest.mark.parametrize("n_devices", [1, 2])
def test_run_demo_gives_the_jax_summary(demos, n_devices):
    _, out = demos
    got, want = out[("port", n_devices)], out[("jax", n_devices)]
    assert got.keys() == want.keys()
    for k in want:
        if k in TIMING_KEYS:
            assert got[k] >= 0, k
        elif k == "stream_auc":
            assert got[k] == pytest.approx(want[k], abs=ATOL_AUC)
        else:
            assert got[k] == want[k], k
    assert got["customers"] == 80 and got["terminals"] == 160
    assert got["streamed_rows"] > 0 and got["warm_rows"] > 0
    assert got["raw_tx_rows"] == got["streamed_rows"]


@pytest.mark.parametrize("n_devices", [1, 2])
def test_run_demo_writes_the_jax_tables(demos, n_devices):
    from real_time_fraud_detection_system_tpu.io.query import (
        load_analyzed,
    )
    from real_time_fraud_detection_system_tpu.io.tables import (
        RawTransactionsTable,
    )

    root, _ = demos
    port, jax_ = root / f"port{n_devices}", root / f"jax{n_devices}"
    got, want = load_analyzed(str(port)), load_analyzed(str(jax_))
    order_g = np.argsort(got["tx_id"], kind="mergesort")
    order_w = np.argsort(want["tx_id"], kind="mergesort")
    _assert_outputs({k: v[order_g] for k, v in got.items()},
                    {k: v[order_w] for k, v in want.items()})
    raw_g = RawTransactionsTable(str(port / "transactions")).read_all()
    raw_w = RawTransactionsTable(str(jax_ / "transactions")).read_all()
    order_g = np.argsort(raw_g["tx_id"])
    order_w = np.argsort(raw_w["tx_id"])
    for k in raw_w:
        np.testing.assert_array_equal(raw_g[k][order_g], raw_w[k][order_w],
                                      err_msg=k)


def test_run_demo_with_nothing_to_stream(forest_file):
    """A horizon past the data (8 + 4 days of 10) streams nothing, in both
    packages alike."""
    from real_time_fraud_detection_system_tpu.io.artifacts import (
        load_model as jload,
    )

    small = dict(n_days=10, delta_train_days=8, delta_delay_days=4,
                 delta_test_days=2)
    got = tpipe.run_demo(demo_config(tconfig, **small),
                         model=load_model(forest_file, device="cpu"),
                         device="cpu")
    want = jpipe.run_demo(demo_config(jconfig, **small),
                          model=jload(forest_file))
    assert got["streamed_rows"] == want["streamed_rows"] == 0
    assert got["flagged_at_0.5"] == want["flagged_at_0.5"] == 0
    assert got["warm_rows"] == want["warm_rows"] > 0
    assert np.isnan(got["stream_auc"]) == np.isnan(want["stream_auc"])


def test_run_demo_defaults_to_the_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.run_demo(demo_config(tconfig), model_kind="logreg")
