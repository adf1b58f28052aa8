"""Port parity: window state, feature assembly and the host plane.

The same inputs, made from numpy seeds, go through the JAX package and the
PyTorch port (on the CPU). Tolerances:

- bucket days, counts, fraud sums, flags and ``TX_AMOUNT`` are
  bit-identical (integers, or copies of the input);
- amount sums and the averages built on them are bit-identical on
  whole-dollar amount streams (integer sums are exact in any order), and
  within ``rtol=1e-6`` otherwise, because the two packages add float32
  values in different orders.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu import config as jconfig
from real_time_fraud_detection_system_tpu.config import (
    DataConfig as JDataConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.core import batch as jbatch
from real_time_fraud_detection_system_tpu.data import (
    generate_dataset as j_generate_dataset,
)
from real_time_fraud_detection_system_tpu.features import online as jonline
from real_time_fraud_detection_system_tpu.models import scaler as jscaler
from real_time_fraud_detection_system_tpu.ops import dedup as jdedup
from real_time_fraud_detection_system_tpu.ops import windows as jwin
from real_time_fraud_detection_system_tpu_torch import config as tconfig
from real_time_fraud_detection_system_tpu_torch.config import (
    DataConfig,
    FeatureConfig,
)
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.models import scaler as tscaler
from real_time_fraud_detection_system_tpu_torch.ops import dedup as tdedup
from real_time_fraud_detection_system_tpu_torch.ops import windows as twin

# Tiny shapes: one intra-op thread each keeps the parallel test workers'
# cores free for the timing-sensitive tests beside them.
torch.set_num_threads(1)

CPU = torch.device("cpu")
RTOL_SUM_ORDER = 1e-6  # float32 sums taken in another order


def _assert_state(jstate, tstate, exact_amount):
    for name in ("bucket_day", "count", "fraud"):
        np.testing.assert_array_equal(
            getattr(tstate, name).numpy(), np.asarray(getattr(jstate, name)),
            err_msg=name)
    got, want = tstate.amount.numpy(), np.asarray(jstate.amount)
    if exact_amount:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL_SUM_ORDER)


def _amounts(rng, n, whole_dollar):
    if whole_dollar:
        return rng.integers(1, 300, n).astype(np.float32)
    return rng.uniform(1, 300, n).astype(np.float32)


def _random_updates(rng, whole_dollar):
    """Six batches over 8 keys: duplicate (slot, day) rows, days that jump
    past the ring (stale buckets), late rows older than their bucket, and
    invalid rows."""
    out = []
    day0 = 20000
    for step in range(6):
        b = 48
        days = day0 + step * 9 + rng.integers(-12, 2, b)
        out.append(dict(
            slot=rng.integers(0, 8, b),
            day=days.astype(np.int32),
            amount=_amounts(rng, b, whole_dollar),
            fraud=(rng.random(b) < 0.2).astype(np.float32),
            valid=rng.random(b) < 0.9,
        ))
    return out


def _ring_eviction_updates(_rng, _whole_dollar):
    one = np.ones(1, np.float32)
    row = lambda d, a: dict(slot=np.zeros(1, np.int64),  # noqa: E731
                            day=np.asarray([d], np.int32), amount=one * a,
                            fraud=one * 0, valid=np.ones(1, bool))
    # day 108 evicts day 100 (same bucket of 8); the late day-100 row drops
    return [row(100, 5), row(108, 7), row(100, 3), row(108, 2)]


@pytest.mark.parametrize("scenario", ["random", "ring_eviction"])
@pytest.mark.parametrize("whole_dollar", [True, False])
@pytest.mark.parametrize("track", [(True, True), (False, True),
                                   (True, False)])
def test_update_and_query_windows_match(scenario, whole_dollar, track):
    rng = np.random.default_rng(11)
    nb = 8 if scenario == "ring_eviction" else 40
    make = {"random": _random_updates,
            "ring_eviction": _ring_eviction_updates}[scenario]
    updates = make(rng, whole_dollar)
    track_amount, track_fraud = track
    js = jwin.init_window_state(16, nb)
    ts = twin.init_window_state(16, nb, CPU)
    for u in updates:
        js = jwin.update_windows(
            js, jnp.asarray(u["slot"], jnp.int32), jnp.asarray(u["day"]),
            jnp.asarray(u["amount"]), jnp.asarray(u["fraud"]),
            jnp.asarray(u["valid"]), track_amount=track_amount,
            track_fraud=track_fraud)
        out = twin.update_windows(
            ts, torch.as_tensor(u["slot"]), torch.as_tensor(u["day"]),
            torch.as_tensor(u["amount"]), torch.as_tensor(u["fraud"]),
            torch.as_tensor(u["valid"]), track_amount=track_amount,
            track_fraud=track_fraud)
        assert out is ts  # updated in place
        _assert_state(js, ts, whole_dollar)

    qslot = np.arange(8) % 16
    qday = np.full(8, updates[-1]["day"].max(), np.int32)
    for delay in (0, 7):
        jq = jwin.query_windows(js, jnp.asarray(qslot, jnp.int32),
                                jnp.asarray(qday), (1, 7, 30), delay=delay)
        tq = twin.query_windows(ts, torch.as_tensor(qslot),
                                torch.as_tensor(qday), (1, 7, 30),
                                delay=delay)
        for i, (j, t) in enumerate(zip(jq, tq)):
            if i == 1 and not whole_dollar:
                np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                           rtol=RTOL_SUM_ORDER)
            else:
                np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _cols(rng, n, whole_dollar, day0=20200):
    cents = rng.integers(1, 500, n) * 100 if whole_dollar \
        else rng.integers(100, 50000, n)
    return {
        "customer_id": rng.integers(0, 100, n).astype(np.int64),
        "terminal_id": rng.integers(0, 200, n).astype(np.int64),
        "tx_datetime_us": ((day0 * 86400 + rng.integers(-40 * 86400, 86400,
                                                        n))
                           .astype(np.int64) * 1_000_000),
        "amount_cents": cents.astype(np.int64),
        "label": rng.integers(-1, 2, n).astype(np.int32),
    }


def _to_device_batch(host_batch):
    return tbatch.unpack_batch(
        torch.from_numpy(tbatch.pack_batch(host_batch)))


@pytest.mark.parametrize("whole_dollar", [True, False])
def test_update_and_featurize_two_batches_match(whole_dollar):
    rng = np.random.default_rng(5)
    jcfg = JFeatureConfig(customer_capacity=128, terminal_capacity=256)
    tcfg = FeatureConfig(customer_capacity=128, terminal_capacity=256)
    js = jonline.init_feature_state(jcfg)
    ts = tonline.init_feature_state(tcfg, CPU)
    for step in range(2):
        cols = _cols(rng, 300, whole_dollar)
        hb = tbatch.make_batch(**cols, pad_to=320)
        js, jf = jonline.update_and_featurize(
            js, jax.tree.map(jnp.asarray, jbatch.make_batch(**cols,
                                                             pad_to=320)),
            jcfg)
        ts, tf = tonline.update_and_featurize(ts, _to_device_batch(hb), tcfg)
        jf, tf = np.asarray(jf), tf.numpy()
        exact = [0, 1, 2, 3, 5, 7, 9, 10, 11, 12, 13, 14]  # not amount avgs
        np.testing.assert_array_equal(tf[:, exact], jf[:, exact])
        if whole_dollar:
            np.testing.assert_array_equal(tf, jf)
        else:
            np.testing.assert_allclose(tf, jf, rtol=RTOL_SUM_ORDER)
        _assert_state(js.customer, ts.customer, whole_dollar)
        _assert_state(js.terminal, ts.terminal, True)


def test_unported_modes_raise_with_roadmap_item():
    for kw, item in (({"key_mode": "hash"}, "A1"),
                     ({"key_mode": "exact"}, "A5"),
                     ({"customer_source": "cms"}, "A5")):
        with pytest.raises(NotImplementedError, match=item):
            tonline.init_feature_state(FeatureConfig(**kw), CPU)


def test_state_bytes_matches_jax():
    cfg = FeatureConfig()
    assert tonline.state_bytes(cfg) == jonline.state_bytes(JFeatureConfig())


def test_pack_unpack_batch_matches_jax():
    rng = np.random.default_rng(3)
    cols = _cols(rng, 77, False)
    cols["customer_id"] = rng.integers(0, 2 ** 40, 77).astype(np.int64)
    hb = tbatch.make_batch(**cols, pad_to=128)
    packed = tbatch.pack_batch(hb)
    np.testing.assert_array_equal(
        packed, jbatch.pack_batch(jbatch.make_batch(**cols, pad_to=128)))
    jb = jbatch.unpack_batch(jnp.asarray(packed))
    tb = tbatch.unpack_batch(torch.from_numpy(packed))
    for name in tbatch.TxBatch._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert tbatch.bucket_size(77, (64, 128)) == jbatch.bucket_size(
        77, (64, 128))


def test_dedup_matches_jax():
    rng = np.random.default_rng(9)
    key = rng.integers(0, 50, 400).astype(np.int64)
    ts = rng.integers(0, 20, 400).astype(np.int64)
    valid = rng.random(400) < 0.9
    np.testing.assert_array_equal(
        tdedup.latest_wins_mask_np(key, ts, valid),
        jdedup.latest_wins_mask_np(key, ts, valid))


def test_generate_dataset_matches_jax():
    kw = dict(n_customers=60, n_terminals=120, n_days=20, seed=3)
    _, _, want = j_generate_dataset(JDataConfig(**kw))
    _, _, got = generate_dataset(DataConfig(**kw))
    for name in ("tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
                 "terminal_id", "amount_cents", "tx_fraud",
                 "tx_fraud_scenario"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)


@pytest.mark.parametrize("name", ["DataConfig", "FeatureConfig",
                                  "ModelConfig", "RuntimeConfig"])
def test_config_fields_and_defaults_match_jax(name):
    """Every field the port keeps has the JAX package's name and default,
    so one set of values configures both."""
    got, want = getattr(tconfig, name)(), getattr(jconfig, name)()
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_fit_scaler_and_transform_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(3.0, 2.0, size=(200, 15)).astype(np.float32)
    x[:, 4] = 1.0  # zero variance → scale 1
    js = jscaler.fit_scaler(x)
    ts = tscaler.fit_scaler(x, device="cpu")
    np.testing.assert_array_equal(ts.mean.numpy(), np.asarray(js.mean))
    np.testing.assert_array_equal(ts.scale.numpy(), np.asarray(js.scale))
    np.testing.assert_array_equal(
        tscaler.transform(ts, torch.as_tensor(x)).numpy(),
        np.asarray(jscaler.transform(js, jnp.asarray(x))))
