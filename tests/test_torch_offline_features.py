"""Port parity: the offline feature replay, the warm-start state and the
pandas rolling-window oracle against the JAX package.

The generated table (~7,700 rows, seeded) goes through the JAX package's
``features/offline.py`` (its jitted online step on the CPU) and the
port's on the CPU.

Tolerances, and why they hold:

- counts exactly, and the float columns within ``rtol=1e-6``: both
  packages add the same float32 terms per day bucket, but scatter-adds
  and window sums may add a bucket's amounts in other orders;
- on the whole-dollar copy of the table (every amount a whole number of
  dollars), the features bit for bit: float32 sums of whole dollars are
  exact in any order;
- the warm-start state's rings bit for bit on the whole-dollar copy, and
  equal to the final state of the port's own feature replay;
- ``pandas_rolling_features`` exactly (the same pandas calls).
"""

import jax
import numpy as np
import pytest

from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.data.generator import (
    Transactions as JTransactions,
)
from real_time_fraud_detection_system_tpu.features import offline as joff
from real_time_fraud_detection_system_tpu_torch.config import (
    DataConfig,
    FeatureConfig,
)
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.features import offline as toff
from real_time_fraud_detection_system_tpu_torch.features.spec import (
    FEATURE_NAMES,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

RTOL_FEATURE = 1e-6
COUNT_COLS = [i for i, n in enumerate(FEATURE_NAMES) if "_NB_TX_" in n]
FLOAT_COLS = [i for i in range(len(FEATURE_NAMES)) if i not in COUNT_COLS]
FEATURES = dict(customer_capacity=128, terminal_capacity=256)

_TX_FIELDS = ("tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
              "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")


def jtxs_of(txs) -> JTransactions:
    return JTransactions(*[getattr(txs, f) for f in _TX_FIELDS])


@pytest.fixture(scope="module")
def txs():
    _, _, t = generate_dataset(DataConfig(n_customers=100, n_terminals=200,
                                          n_days=60))
    return t


@pytest.fixture(scope="module")
def whole(txs):
    out = txs.slice(slice(None))
    out.amount_cents = np.round(txs.amount_cents / 100).astype(np.int64) * 100
    return out


@pytest.mark.parametrize("chunk", [256, 512])
@pytest.mark.parametrize("features", [{}, {"key_mode": "hash"},
                                      {"customer_source": "cms",
                                       "cms_width": 512}])
def test_replay_features_equal_jax(txs, chunk, features):
    with_cms = features.get("customer_source") == "cms"
    got = toff.compute_features_replay(
        txs, FeatureConfig(**FEATURES, **features), chunk=chunk,
        with_cms=with_cms, device="cpu")
    want = joff.compute_features_replay(
        jtxs_of(txs), JFeatureConfig(**FEATURES, **features), chunk=chunk,
        with_cms=with_cms)
    assert got.shape == want.shape == (txs.n, 15)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got[:, COUNT_COLS], want[:, COUNT_COLS])
    np.testing.assert_allclose(got[:, FLOAT_COLS], want[:, FLOAT_COLS],
                               rtol=RTOL_FEATURE)


@pytest.mark.parametrize("chunk", [256, 8192])
def test_replay_features_bit_identical_on_whole_dollars(whole, chunk):
    got = toff.compute_features_replay(whole, FeatureConfig(**FEATURES),
                                       chunk=chunk, device="cpu")
    want = joff.compute_features_replay(jtxs_of(whole),
                                        JFeatureConfig(**FEATURES),
                                        chunk=chunk)
    assert got.tobytes() == np.asarray(want, np.float32).tobytes()


@pytest.mark.parametrize("with_cms", [False, True])
def test_warm_start_state_equals_jax_and_the_replay(whole, with_cms):
    cfg = FeatureConfig(**FEATURES, cms_width=512)
    got = toff.warm_start_state(whole, cfg, chunk=512, with_cms=with_cms,
                                device="cpu")
    want = joff.warm_start_state(
        jtxs_of(whole), JFeatureConfig(**FEATURES, cms_width=512), chunk=512,
        with_cms=with_cms)
    assert (got.cms is not None) == with_cms
    gl = [t.numpy() for t in tree.leaves(got)]
    wl = [np.asarray(a) for a in jax.tree.leaves(want)]
    assert len(gl) == len(wl)
    for a, b in zip(gl, wl):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    _, replayed = toff._replay(whole, cfg, "2025-04-01", 512, with_cms,
                               collect_features=True, device="cpu")
    for a, b in zip(tree.leaves(got), tree.leaves(replayed)):
        assert a.numpy().tobytes() == b.numpy().tobytes()


def test_replay_refuses_an_unordered_table(txs):
    shuffled = txs.slice(np.r_[1, 0, 2:txs.n])
    with pytest.raises(ValueError, match="chronological"):
        toff.compute_features_replay(shuffled, FeatureConfig(**FEATURES),
                                     device="cpu")


def test_pandas_rolling_features_equal_jax(txs):
    pytest.importorskip("pandas", reason="the rolling oracle needs pandas")
    small = txs.slice(slice(0, 3000))
    got = toff.pandas_rolling_features(small)
    want = joff.pandas_rolling_features(jtxs_of(small))
    assert got.shape == (3000, 15) and got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # the replay tracks the wall-clock oracle on the flags and amounts
    feats = toff.compute_features_replay(small, FeatureConfig(**FEATURES),
                                         device="cpu")
    np.testing.assert_allclose(feats[:, :3], got[:, :3], rtol=1e-6)
