"""Port parity: the serving loop — native host prep and its loader, the
envelope codec and replay, the depth-N pipeline with coalescing and
pacing, the sinks and the ``score`` command — against the JAX package.

Tolerances: every id, count, flag, risk, slot, mask, packed word and
decoded column bit-identical; customer amount averages within
``rtol=1e-6`` (float32 window sums in another order); probabilities
within ``atol=1e-6`` (logreg: the dot in another order; forest: the leaf
sum in another order, divided by the tree count) with identical
decisions. The port's runs at different depths, and coalesced against
uncoalesced, are held bit for bit against each other.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.config import (
    Config as JConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.core import envelope as jenvelope
from real_time_fraud_detection_system_tpu.core import native as jnative
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
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
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.core import envelope
from real_time_fraud_detection_system_tpu_torch.core import native
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    load_transactions,
    save_transactions,
)
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    AsyncSink,
    ConsoleSink,
    FanoutSink,
    MemorySink,
    ParquetSink,
    make_parquet_sink,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.ops.dedup import (
    latest_wins_mask_host,
    latest_wins_mask_np,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    BatchResult,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    InProcBroker,
    ReplaySource,
    SyntheticSource,
)
from real_time_fraud_detection_system_tpu_torch.utils.timing import (
    LatencyTracker,
    date_to_epoch_s,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = 1_743_465_600  # 2025-04-01
RTOL_SUM_ORDER = 1e-6
ATOL_PROB = 1e-6


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _assert_outputs(tout: dict, jout: dict) -> None:
    """Sink columns of the port against the JAX package's."""
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


def _assert_same(a: dict, b: dict, what: str) -> None:
    for col in a:
        if col != "processed_at_us":
            np.testing.assert_array_equal(a[col], b[col],
                                          err_msg=f"{col}: {what}")


# ---------------------------------------------------------------------------
# native host prep and its loader
# ---------------------------------------------------------------------------


def _jax_native(unit: str) -> bool:
    """True when the JAX package's build of ``native/<unit>.cc`` is there
    and current, so loading it compiles nothing. The JAX loader compiles
    in place whenever the library is older than its source; these tests
    compare against it only where that cannot race with the JAX tests'
    own builds in other workers."""
    so = os.path.join(ROOT, "native", f"lib{unit}.so")
    src = os.path.join(ROOT, "native", f"{unit}.cc")
    if not (os.path.exists(so)
            and os.path.getmtime(so) >= os.path.getmtime(src)):
        return False
    return (jnative.hostprep_available() if unit == "hostprep"
            else jnative.native_available())


def test_native_units_build_and_load():
    assert native.hostprep_available() and native.native_available()


def test_hostprep_latest_wins_matches_numpy_and_jax_fuzz():
    """The C++ hash dedup ≡ the NumPy mask ≡ the JAX package's native
    pass (where it is built), with ts ties (the later position wins) and
    heavy duplication."""
    rng = np.random.default_rng(17)
    for _ in range(30):
        n = int(rng.integers(1, 4000))
        tx = rng.integers(0, max(1, n // 3), n)
        ts = rng.integers(0, 20, n)
        got = native.latest_wins_keep(tx, ts)
        np.testing.assert_array_equal(got, latest_wins_mask_np(tx, ts))
        np.testing.assert_array_equal(got, latest_wins_mask_host(tx, ts))
        if _jax_native("hostprep"):
            np.testing.assert_array_equal(got,
                                          jnative.latest_wins_keep(tx, ts))


def test_hostprep_sentinel_key_parity():
    """tx_id == INT64_MIN doubles as the NumPy mask's invalid sentinel and
    is dropped there; the native pass drops it too."""
    lo = np.iinfo(np.int64).min
    tx = np.array([5, lo, 5, lo, 7], dtype=np.int64)
    ts = np.array([1, 2, 3, 4, 5], dtype=np.int64)
    got = native.latest_wins_keep(tx, ts)
    np.testing.assert_array_equal(got, latest_wins_mask_np(tx, ts))
    if _jax_native("hostprep"):
        np.testing.assert_array_equal(got, jnative.latest_wins_keep(tx, ts))
    assert not got[1] and not got[3]
    assert native.latest_wins_keep(tx[:0], ts[:0]).shape == (0,)


def test_hostprep_pack_rows_bitexact_fuzz():
    """The fused C++ pack ≡ make_batch + pack_batch ≡ the JAX package's
    native pack, bit for bit; with ``out`` it writes in place."""
    rng = np.random.default_rng(23)
    for trial in range(20):
        n = int(rng.integers(1, 3000))
        dt = rng.integers(-2 ** 40, 2 ** 45, n)  # floor split below 0 too
        cu = rng.integers(0, 2 ** 63 - 1, n)
        te = rng.integers(0, 2 ** 63 - 1, n)
        am = rng.integers(0, 10 ** 9, n)
        lab = rng.integers(-1, 2, n) if trial % 2 else None
        pad = int(n + rng.integers(0, 64))
        ref = tbatch.pack_batch(tbatch.make_batch(cu, te, dt, am, label=lab,
                                                  pad_to=pad))
        got = native.pack_rows(dt, cu, te, am, lab, pad)
        np.testing.assert_array_equal(got, ref, err_msg=f"trial {trial}")
        if _jax_native("hostprep"):
            np.testing.assert_array_equal(
                got, jnative.pack_rows(dt, cu, te, am, lab, pad))
        out = np.full((7, pad), 7, dtype=np.int32)
        assert native.pack_rows(dt, cu, te, am, lab, pad, out=out) is out
        np.testing.assert_array_equal(out, ref)
    with pytest.raises(ValueError, match="pad"):
        native.pack_rows(dt, cu, te, am, None, n - 1)
    with pytest.raises(ValueError, match="out"):
        native.pack_rows(dt, cu, te, am, None, pad,
                         out=np.zeros((7, pad), np.int64))


def _engine_batch(n=200):
    rng = np.random.default_rng(3)
    return {
        "tx_id": np.concatenate([np.arange(n - 20), np.arange(20)]),
        "tx_datetime_us": np.sort(rng.integers(
            0, 5 * 86_400_000_000, n)).astype(np.int64),
        "customer_id": rng.integers(0, 60, n),
        "terminal_id": rng.integers(0, 90, n),
        "tx_amount_cents": rng.integers(100, 10 ** 6, n),
        "kafka_ts_ms": np.arange(n, dtype=np.int64),
        "label": rng.integers(-1, 2, n),
    }


def test_hostprep_engine_parity_native_vs_numpy(monkeypatch):
    """The engine gives identical results on the native and the NumPy
    host-prep routes, and names the route it took."""
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        LogRegParams,
    )

    cfg = Config(features=FeatureConfig(customer_capacity=128,
                                        terminal_capacity=256),
                 runtime=RuntimeConfig(batch_buckets=(256,)))
    params = LogRegParams(torch.linspace(-1, 1, 15), torch.tensor(-0.5))
    scaler = Scaler(torch.zeros(15), torch.ones(15))

    def run():
        eng = ScoringEngine(cfg, "logreg", params, scaler, device="cpu")
        res = eng.process_batch(_engine_batch())
        stats = eng.run(ReplaySource(
            Transactions(*[np.arange(300)] * 3 + [np.arange(300) % 7,
                                                  np.arange(300) % 11,
                                                  np.arange(300) * 50,
                                                  np.zeros(300, np.int8),
                                                  np.zeros(300, np.int8)]),
            START, batch_rows=100))
        return eng.host_prep, stats["host_prep_route"], res

    route, route_stats, r_nat = run()
    assert route == route_stats == "native"
    monkeypatch.setattr(native, "hostprep_available", lambda: False)
    route, route_stats, r_np = run()
    assert route == route_stats == "numpy"
    assert len(r_nat.tx_id) == 180  # 20 replayed tx_ids dedup'd
    np.testing.assert_array_equal(r_nat.tx_id, r_np.tx_id)
    np.testing.assert_array_equal(r_nat.probs, r_np.probs)
    np.testing.assert_array_equal(r_nat.features, r_np.features)


def test_loader_builds_into_its_own_directory_never_native(tmp_path,
                                                           monkeypatch):
    """A fresh build lands in the port's build directory under a name
    keyed on the source's hash, leaves no temporary file, and writes
    nothing under ``native/``: only the sources and the JAX package's own
    ``lib<name>.so`` builds (which its tests may make meanwhile) live
    there."""
    native_dir = os.path.join(ROOT, "native")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_libs", {})
    assert native.hostprep_available() and native.native_available()
    built = sorted(os.listdir(tmp_path))
    assert built == sorted([native.library_path("envelope").name,
                            native.library_path("hostprep").name])
    assert all(name.startswith(("libenvelope-", "libhostprep-"))
               for name in built)
    np.testing.assert_array_equal(
        native.latest_wins_keep(np.array([1, 1, 2]), np.array([0, 1, 0])),
        [False, True, True])
    assert set(os.listdir(native_dir)) <= {
        "envelope.cc", "hostprep.cc", "libenvelope.so", "libhostprep.so"}
    assert native.BUILD_DIR == tmp_path
    assert all(native.library_path(u).parent == tmp_path
               for u in ("envelope", "hostprep"))


_BUILD_IN = r"""
import sys
from pathlib import Path
import numpy as np
from real_time_fraud_detection_system_tpu_torch.core import native
native.BUILD_DIR = Path(sys.argv[1])
keep = native.latest_wins_keep(np.array([3, 3, 4]), np.array([1, 0, 0]))
assert keep.tolist() == [True, False, True], keep
print("ok")
"""


def test_loader_builds_race_free_across_processes(tmp_path):
    """Four processes build the same unit into one empty directory at
    once: each compiles to a temporary name and renames it into place,
    so every process loads a whole library and one file remains."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_IN,
                               str(tmp_path)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert all(o.strip() == "ok" for o, _ in outs)
    assert sorted(os.listdir(tmp_path)) == [
        native.library_path("hostprep").name]


# ---------------------------------------------------------------------------
# envelopes
# ---------------------------------------------------------------------------

MALFORMED = [
    jenvelope.encode_transaction_envelope(1, 2, 3, 4, 500),
    jenvelope.encode_transaction_envelope(7, 8, 9, 10, -12345, op="d"),
    jenvelope.encode_transaction_envelope(11, 12, 13, 14, 0, op="u"),
    b"junk",
    b"",
    b'{"payload": null}',
    b'{"payload": {"after": null, "before": null}}',
    b'{"no_payload": 1}',
    b'{ "payload" : { "after" : { "tx_id" : 5, "tx_datetime": 6,'
    b' "customer_id": 7, "terminal_id": 8, "tx_amount": "eA==" } } }',
]


def _corpus(rng, n):
    return (np.arange(n, dtype=np.int64),
            rng.integers(1_700_000_000, 1_800_000_000, n) * 1_000_000,
            rng.integers(0, 5000, n), rng.integers(0, 10000, n),
            rng.integers(-(10 ** 9), 10 ** 10, n))


def test_envelope_encode_matches_jax_byte_for_byte():
    cols = _corpus(np.random.default_rng(1), 300)
    assert envelope.encode_transaction_envelopes(*cols) \
        == jenvelope.encode_transaction_envelopes(*cols)
    for cents in (0, 1, -1, 127, 128, -128, -129, 2 ** 40, -(2 ** 40)):
        assert envelope.encode_decimal_cents(cents) \
            == jenvelope.encode_decimal_cents(cents)


@pytest.mark.parametrize("route", ["python", "native", "fast"])
def test_envelope_decode_matches_jax_with_malformed(route):
    """The port's Python decoder, its native scanner and its dispatcher
    against the JAX package's decoders on clean, delete, update and
    malformed messages: the same columns and tombstone masks."""
    decode = {"python": envelope.decode_transaction_envelopes,
              "native": native.decode_transaction_envelopes_native,
              "fast": envelope.decode_transaction_envelopes_fast}[route]
    msgs = MALFORMED + jenvelope.encode_transaction_envelopes(
        *_corpus(np.random.default_rng(2), 50))
    ts = list(range(len(msgs)))
    c_t, i_t = decode(msgs, ts)
    # the JAX scanner where it is built, else its Python decoder: the two
    # agree on these messages (its own malformed-parity test)
    c_j, i_j = (jnative.decode_transaction_envelopes_native(msgs, ts)
                if route != "python" and _jax_native("envelope")
                else jenvelope.decode_transaction_envelopes(msgs, ts))
    np.testing.assert_array_equal(i_t, i_j)
    assert i_t[3:8].all() and not i_t[:3].any() and not i_t[8]
    ok = ~i_t
    for k in c_j:
        np.testing.assert_array_equal(c_t[k][ok], c_j[k][ok], err_msg=k)


def test_decode_workers_bit_identical():
    """Slab-parallel native decode ≡ serial decode (the corpus exceeds
    the parallel threshold, so the pool runs)."""
    msgs = envelope.encode_transaction_envelopes(
        *_corpus(np.random.default_rng(3), 10000))
    ref, ref_inv = native.decode_transaction_envelopes_native(msgs,
                                                              workers=1)
    for w in (0, 2, 3, 8):
        cols, inv = native.decode_transaction_envelopes_native(msgs,
                                                               workers=w)
        np.testing.assert_array_equal(inv, ref_inv)
        for k in ref:
            np.testing.assert_array_equal(cols[k], ref[k], err_msg=(w, k))


# ---------------------------------------------------------------------------
# sources
# ---------------------------------------------------------------------------


def test_broker_partitioning_and_offsets():
    b = InProcBroker(n_partitions=4)
    for i in range(100):
        b.produce("t", str(i % 10).encode(), f"v{i}".encode(), ts_ms=i)
    assert sum(b.end_offsets("t")) == 100
    p0, _ = b.produce("t", b"5", b"x")
    p1, _ = b.produce("t", b"5", b"y")
    assert p0 == p1
    recs = b.poll("t", p0, 0, 1000)
    assert [r.offset for r in recs] == list(range(len(recs)))
    from real_time_fraud_detection_system_tpu.runtime import InProcBroker \
        as JInProcBroker

    jb = JInProcBroker(n_partitions=8)
    assert [InProcBroker(8).partition_of(str(k).encode())
            for k in range(200)] == [jb.partition_of(str(k).encode())
                                     for k in range(200)]


def _drain(src) -> list:
    out = []
    while (c := src.poll_batch()) is not None:
        out.append(c)
    return out


def test_replay_envelope_equals_columnar(small_dataset):
    txs = _port_txs(small_dataset[3].slice(slice(0, 500)))
    col = _drain(ReplaySource(txs, START, batch_rows=200, mode="columnar"))
    env = _drain(ReplaySource(txs, START, batch_rows=200, mode="envelope"))

    def cat(batches, k):
        return np.concatenate([b[k] for b in batches])

    order_c, order_e = np.argsort(cat(col, "tx_id")), np.argsort(
        cat(env, "tx_id"))
    for k in ("tx_id", "tx_datetime_us", "customer_id", "terminal_id",
              "tx_amount_cents", "kafka_ts_ms"):
        np.testing.assert_array_equal(cat(col, k)[order_c],
                                      cat(env, k)[order_e], err_msg=k)


@pytest.mark.parametrize("mode", ["columnar", "envelope"])
def test_replay_polls_match_jax_and_seek_resumes(small_dataset, mode):
    """Poll for poll the JAX package's batches (labels too, in columnar
    mode); ``seek`` to saved offsets resumes the same sequence."""
    jtxs = small_dataset[3].slice(slice(0, 700))
    kw = dict(batch_rows=160, mode=mode, n_partitions=4,
              with_labels=True)
    tb = _drain(ReplaySource(_port_txs(jtxs), START, **kw))
    jb = _drain(JReplaySource(jtxs, START, **kw))
    assert len(tb) == len(jb) > 2
    for t, j in zip(tb, jb):
        assert sorted(t) == sorted(j)
        for k in t:
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
    src = ReplaySource(_port_txs(jtxs), START, **kw)
    src.poll_batch()
    saved = src.offsets
    rest = _drain(src)
    again = ReplaySource(_port_txs(jtxs), START, **kw)
    again.seek(saved)
    for a, b in zip(_drain(again), rest):
        np.testing.assert_array_equal(a["tx_id"], b["tx_id"])


def test_synthetic_source_paces_and_replays(small_dataset):
    txs = _port_txs(small_dataset[3].slice(slice(0, 300)))
    src = SyntheticSource(txs, START, rate_tps=3000.0, batch_rows=100)
    t0 = time.perf_counter()
    got = _drain(src)
    assert time.perf_counter() - t0 >= 0.09  # 300 rows at 3000 rows/s
    np.testing.assert_array_equal(np.concatenate([b["tx_id"] for b in got]),
                                  txs.tx_id)
    assert src.offsets == [300]
    src.seek([100])
    assert src.poll_batch()["tx_id"][0] == txs.tx_id[100]


def test_transactions_npz_round_trip_both_ways(small_dataset, tmp_path):
    jtxs = small_dataset[3].slice(slice(0, 400))
    jsave_transactions(str(tmp_path / "j.npz"), jtxs)
    got = load_transactions(str(tmp_path / "j.npz"))
    save_transactions(str(tmp_path / "t.npz"), got)
    from real_time_fraud_detection_system_tpu.io.artifacts import (
        load_transactions as jload_transactions,
    )

    back = jload_transactions(str(tmp_path / "t.npz"))
    for f in ("tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
              "terminal_id", "amount_cents", "tx_fraud",
              "tx_fraud_scenario"):
        np.testing.assert_array_equal(getattr(got, f), getattr(jtxs, f))
        assert getattr(back, f).dtype == getattr(jtxs, f).dtype
        np.testing.assert_array_equal(getattr(back, f), getattr(jtxs, f))


def test_timing_helpers():
    assert date_to_epoch_s("2025-04-01") == START
    tr = LatencyTracker(window=4)
    assert tr.snapshot()["count"] == 0
    for s in (0.001, 0.002, 0.003, 0.004, 0.010):
        tr.record(s, rows=10)
    snap = tr.snapshot()
    assert snap["count"] == 5 and snap["rows"] == 50
    assert snap["max_ms"] == pytest.approx(10.0)  # the window keeps 4
    assert snap["p50_ms"] == pytest.approx(3.5)


# ---------------------------------------------------------------------------
# the engine's loop against the JAX engine's
# ---------------------------------------------------------------------------


def _logreg(rng_seed=9):
    rng = np.random.default_rng(rng_seed)
    return JLogRegParams(w=jnp.asarray(rng.normal(0, 0.8, 15)
                                       .astype(np.float32)),
                         b=jnp.float32(-1.0))


_SCALER = {}


def _scaler():
    """(mean, scale) fitted on the loop tests' stream's own features (the
    features do not depend on the scaler), so the weights see the
    standardized inputs a trained model sees."""
    if not _SCALER:
        from real_time_fraud_detection_system_tpu.config import DataConfig
        from real_time_fraud_detection_system_tpu.data import (
            generate_dataset,
        )
        from real_time_fraud_detection_system_tpu_torch.models.logreg import (
            LogRegParams,
        )
        from real_time_fraud_detection_system_tpu_torch.models.scaler import (
            fit_scaler,
        )

        # the conftest's small_dataset, rebuilt here for a plain function
        _, _, jtxs = generate_dataset(DataConfig(
            n_customers=120, n_terminals=240, n_days=45, seed=7))
        _, tcfg = _loop_configs()
        probe = ScoringEngine(tcfg, "logreg",
                              LogRegParams(torch.zeros(15),
                                           torch.tensor(0.0)),
                              Scaler(torch.zeros(15), torch.ones(15)),
                              device="cpu")
        src = ReplaySource(_port_txs(jtxs.slice(slice(0, 3000))), START,
                           batch_rows=1000)
        feats = [probe.process_batch(c).features
                 for c in iter(src.poll_batch, None)]
        fitted = fit_scaler(np.concatenate(feats), device="cpu")
        _SCALER["v"] = (fitted.mean.numpy(), fitted.scale.numpy())
    return _SCALER["v"]


def _loop_configs(**runtime):
    fields = dict(customer_capacity=256, terminal_capacity=512)
    jcfg = JConfig(features=JFeatureConfig(**fields),
                   runtime=JRuntimeConfig(batch_buckets=(256, 1024, 4096),
                                          **runtime))
    tcfg = Config(features=FeatureConfig(**fields),
                  runtime=RuntimeConfig(batch_buckets=(256, 1024, 4096),
                                        **runtime))
    return jcfg, tcfg


@pytest.fixture(scope="module")
def jax_run(small_dataset):
    """The JAX engine's run at its default depth 2: the reference for
    every depth and coalesce setting of the port's loop."""
    jtxs = small_dataset[3].slice(slice(0, 2000))
    jcfg, _ = _loop_configs()
    mean, scale = _scaler()
    eng = JScoringEngine(jcfg, kind="logreg", params=_logreg(),
                         scaler=JScaler(jnp.asarray(mean),
                                        jnp.asarray(scale)))
    sink = JMemorySink()
    stats = eng.run(JReplaySource(jtxs, START, batch_rows=250), sink=sink)
    return jtxs, stats, sink.concat()


def _port_run(jtxs, batch_rows=250, **runtime):
    _, tcfg = _loop_configs(**runtime)
    mean, scale = _scaler()
    params = weights.from_numpy(jax.tree.map(np.asarray, _logreg()),
                                device="cpu")
    eng = ScoringEngine(tcfg, "logreg", params,
                        Scaler(torch.from_numpy(mean),
                               torch.from_numpy(scale)), device="cpu")
    sink = MemorySink()
    stats = eng.run(ReplaySource(_port_txs(jtxs), START,
                                 batch_rows=batch_rows), sink)
    return stats, sink.concat(), sink


def test_pipeline_depth_equivalence_against_jax(jax_run):
    """Depth changes only the overlap: depths 1, 2 and 4 give the same
    sink rows, bit for bit, equal to the JAX engine's run."""
    jtxs, jstats, jout = jax_run
    s1, o1, _ = _port_run(jtxs, pipeline_depth=1)
    _assert_outputs(o1, jout)
    assert s1["batches"] == jstats["batches"] == 8
    for depth in (2, 4):
        s, o, _ = _port_run(jtxs, pipeline_depth=depth)
        assert s["pipeline_depth"] == depth == s["pipeline_depth"]
        assert s["batches"] == s1["batches"] and s["rows"] == 2000
        _assert_same(o1, o, f"depth {depth}")


def test_coalesce_equals_a_source_of_that_batch_size(jax_run):
    """Coalescing 250-row polls into 1000-row batches gives the bytes of a
    source that hands out 1000-row batches, on the port and on the JAX
    engine."""
    jtxs, _, _ = jax_run
    sc, oc, sink_c = _port_run(jtxs, pipeline_depth=2, coalesce_rows=1000)
    sn, on, _ = _port_run(jtxs, batch_rows=1000, pipeline_depth=2)
    assert sc["batches"] == sn["batches"] == 2
    assert [len(b["tx_id"]) for b in sink_c.batches] == [1000, 1000]
    _assert_same(on, oc, "coalesced against 1000-row polls")
    jcfg, _ = _loop_configs(coalesce_rows=1000)
    mean, scale = _scaler()
    jeng = JScoringEngine(jcfg, kind="logreg", params=_logreg(),
                          scaler=JScaler(jnp.asarray(mean),
                                         jnp.asarray(scale)))
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=250), sink=jsink)
    _assert_outputs(oc, jsink.concat())


def test_coalesce_never_exceeds_largest_bucket(jax_run):
    """A poll that would overflow the largest bucket is carried into the
    next batch: every row scored once, no oversized batch."""
    jtxs, _, _ = jax_run
    stats, out, sink = _port_run(jtxs.slice(slice(0, 2000)),
                                 batch_rows=900, coalesce_rows=8192)
    assert stats["rows"] == 2000
    assert max(len(b["tx_id"]) for b in sink.batches) <= 4096
    np.testing.assert_array_equal(np.sort(out["tx_id"]),
                                  np.sort(jtxs.tx_id))


def test_max_batches_counts_this_run(jax_run):
    jtxs, _, _ = jax_run
    _, tcfg = _loop_configs(pipeline_depth=3)
    mean, scale = _scaler()
    params = weights.from_numpy(jax.tree.map(np.asarray, _logreg()),
                                device="cpu")
    eng = ScoringEngine(tcfg, "logreg", params,
                        Scaler(torch.from_numpy(mean),
                               torch.from_numpy(scale)), device="cpu")
    src = ReplaySource(_port_txs(jtxs), START, batch_rows=250)
    assert eng.run(src, max_batches=3)["batches"] == 3
    assert eng.run(src, max_batches=2)["batches"] == 2
    assert eng.state.offsets == [1250] and eng.state.batches_done == 5


def test_trigger_pacing_once_per_pass_not_per_drained_handle(jax_run):
    """Pacing sleeps once per loop pass on the poll side and credits the
    sleep as wait: with a deep queue the batch starts space out by the
    trigger while the latencies stay far below it."""
    jtxs, _, _ = jax_run
    _, tcfg = _loop_configs(pipeline_depth=8)
    mean, scale = _scaler()
    params = weights.from_numpy(jax.tree.map(np.asarray, _logreg()),
                                device="cpu")
    eng = ScoringEngine(tcfg, "logreg", params,
                        Scaler(torch.from_numpy(mean),
                               torch.from_numpy(scale)), device="cpu")
    txs = _port_txs(jtxs)
    eng.run(ReplaySource(txs.slice(slice(0, 256)), START, batch_rows=256),
            trigger_seconds=0.0)
    src = ReplaySource(txs.slice(slice(256, 1536)), START, batch_rows=256)
    t0 = time.perf_counter()
    stats = eng.run(src, trigger_seconds=0.2)
    wall = time.perf_counter() - t0
    assert stats["batches"] == 5
    assert wall >= 0.6  # ≥ 4 gaps of ~0.2 s between batch starts
    assert stats["latency_p99_ms"] < 150.0


def test_run_stats_keys(jax_run):
    jtxs, jstats, _ = jax_run
    stats, _, _ = _port_run(jtxs)
    for k in ("rows", "batches", "wall_s", "cpu_s", "rows_per_s",
              "latency_p50_ms", "latency_p99_ms", "host_prep_p50_ms",
              "dispatch_p50_ms", "result_wait_p50_ms", "sink_write_p50_ms",
              "pipeline_depth", "z_mode"):
        assert k in jstats and k in stats, k
    assert sorted(stats["stage_ms_p50"]) == sorted(
        ["source_poll", "host_prep", "dispatch", "result_wait",
         "sink_write"])
    assert stats["host_prep_route"] in ("native", "numpy")
    assert stats["host_prep_p50_ms"] == stats["stage_ms_p50"]["host_prep"]


# ---------------------------------------------------------------------------
# sinks
# ---------------------------------------------------------------------------


def _res(i, n=4):
    ids = np.arange(n, dtype=np.int64) + i * n
    return BatchResult(tx_id=ids, tx_datetime_us=ids * 10 ** 6,
                       customer_id=ids % 7, terminal_id=ids % 5,
                       amount_cents=ids * 10 + 1,
                       features=np.zeros((n, 15), np.float32),
                       probs=np.zeros(n, np.float32), latency_s=0.0,
                       batch_index=i)


class _SlowSink(MemorySink):
    def __init__(self, delay_s=0.01):
        super().__init__()
        self.delay_s = delay_s
        self.order = []

    def append(self, res):
        time.sleep(self.delay_s)
        self.order.append(res.batch_index)
        super().append(res)


def test_async_sink_ordered_appends():
    inner = _SlowSink(delay_s=0.002)
    sink = AsyncSink(inner, max_queue=4)
    for i in range(1, 21):
        sink.append(_res(i))
    sink.drain()
    assert inner.order == list(range(1, 21))
    assert len(sink.concat()["tx_id"]) == 20 * 4
    sink.close()
    assert not sink._thread.is_alive()


def test_async_sink_backpressure_bounded_and_counted():
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    reg = MetricsRegistry()
    inner = _SlowSink(delay_s=0.05)
    sink = AsyncSink(inner, max_queue=1, registry=reg)
    for i in range(1, 5):
        sink.append(_res(i))
    sink.drain()
    sink.close()
    # blocked, and accounted
    assert reg.get("rtfds_sink_backpressure_seconds_total",
                   sink="_SlowSink").value > 0.05
    assert reg.get("rtfds_sink_queue_depth", sink="_SlowSink").value == 0
    assert inner.order == [1, 2, 3, 4]


def test_async_sink_error_propagates_with_original_type():
    class _Failing(MemorySink):
        def __init__(self):
            super().__init__()
            self.n = 0

        def append(self, res):
            self.n += 1
            if self.n == 2:
                raise OSError("disk on fire")
            super().append(res)

    sink = AsyncSink(_Failing(), max_queue=8)
    sink.append(_res(1))
    sink.append(_res(2))
    with pytest.raises(OSError, match="disk on fire"):
        sink.drain()
    sink.append(_res(3))  # the raise cleared the error: writing resumes
    sink.drain()
    assert [b["tx_id"][0] for b in sink.inner.batches] == [4, 12]
    sink.close()


def test_async_sink_flush_and_truncate_drain_first(tmp_path):
    pq = ParquetSink(str(tmp_path / "parts"))
    sink = AsyncSink(pq, max_queue=8)
    for i in range(1, 6):
        sink.append(_res(i))
    sink.truncate_after(3)
    assert sorted(os.listdir(pq.directory)) == [
        f"part-{i:08d}.parquet" for i in (1, 2, 3)]
    assert len(sink.read_all()["tx_id"]) == 12
    sink.close()


_MANY_WRITER_THREADS = r"""
import sys
import numpy as np
from real_time_fraud_detection_system_tpu_torch.io.sink import (
    AsyncSink, ParquetSink)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    BatchResult)
assert "pyarrow" not in sys.modules
for k in range(30):
    sink = AsyncSink(ParquetSink(f"{sys.argv[1]}/out{k % 3}"), max_queue=8)
    for i in range(1, 4):
        ids = np.arange(1000, dtype=np.int64) + i * 1000
        sink.append(BatchResult(ids, ids, ids % 7, ids % 5, ids,
                                np.zeros((1000, 15), np.float32),
                                np.zeros(1000, np.float32), 0.0, i))
    sink.close()
print("ok")
"""


def test_async_parquet_sinks_survive_many_writer_threads(tmp_path):
    """Thirty async Parquet sinks one after another, in a fresh process
    that has not imported pyarrow: each writer thread starts after the
    last has exited. With pyarrow first imported on such a thread, and
    the default thread stack, a later one crashed inside the
    ParquetWriter constructor (SIGSEGV); the sink imports pyarrow on the
    thread that builds it and gives its writer a larger stack."""
    proc = subprocess.run([sys.executable, "-c", _MANY_WRITER_THREADS,
                           str(tmp_path)], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == "ok"


def test_engine_drains_an_async_sink_at_run_end(jax_run):
    jtxs, _, jout = jax_run
    _, tcfg = _loop_configs()
    mean, scale = _scaler()
    params = weights.from_numpy(jax.tree.map(np.asarray, _logreg()),
                                device="cpu")
    eng = ScoringEngine(tcfg, "logreg", params,
                        Scaler(torch.from_numpy(mean),
                               torch.from_numpy(scale)), device="cpu")
    inner = _SlowSink(delay_s=0.005)
    sink = AsyncSink(inner, max_queue=2)
    eng.run(ReplaySource(_port_txs(jtxs), START, batch_rows=250), sink)
    assert inner.order == list(range(1, 9))  # landed before run returned
    _assert_outputs(inner.concat(), jout)
    sink.close()


def test_fanout_console_and_parquet_sinks(tmp_path, capsys, monkeypatch):
    mem = MemorySink()
    pq = make_parquet_sink(str(tmp_path / "out"))
    fan = FanoutSink(mem, None, pq, ConsoleSink(every=2, limit=1))
    for i in (1, 2, 3):
        fan.append(_res(i))
    fan.flush()
    printed = capsys.readouterr().out
    assert "[batch 2] rows=4" in printed and "[batch 1]" not in printed
    back = pq.read_all()
    for k, v in mem.concat().items():
        if k != "processed_at_us":
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    fan.truncate_after(1)
    assert sorted(os.listdir(pq.directory)) == ["part-00000001.parquet"]
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="boto3"):
        make_parquet_sink("s3://bucket/prefix")


# ---------------------------------------------------------------------------
# the score command against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def score_files(small_dataset, tmp_path_factory):
    d = tmp_path_factory.mktemp("score")
    jtxs = small_dataset[3].slice(slice(0, 3000))
    jsave_transactions(str(d / "txs.npz"), jtxs)
    mean, scale = _scaler()
    model = JTrainedModel(kind="forest",
                          scaler=JScaler(jnp.asarray(mean),
                                         jnp.asarray(scale)),
                          params=jforest.synthetic_ensemble(10, 5, 15,
                                                            seed=3))
    with open(d / "forest.npz", "wb") as f:
        f.write(jdump_model_bytes(model))
    logreg = JTrainedModel(kind="logreg", scaler=model.scaler,
                           params=_logreg(4))
    with open(d / "logreg.npz", "wb") as f:
        f.write(jdump_model_bytes(logreg))
    return d


def _score_both(d, capsys, flags, port_flags=()):
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), "--batch-rows", "1024", *flags]
    tag = "-".join(f.strip("-") for f in (*flags, *port_flags)) \
        or "columnar"
    jdir, tdir = d / f"jax-{tag}", d / f"port-{tag}"
    assert jcli_main(["score", "--out", str(jdir), *common]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out", str(tdir),
                      *common, *port_flags]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return jstats, tstats, ParquetSink(str(jdir)).read_all(), \
        ParquetSink(str(tdir)).read_all()


@pytest.mark.parametrize("flags,port_flags", [
    ((), ()), (("--mode", "envelope"), ()), (("--key-mode", "hash"), ()),
    (("--pipeline-depth", "3", "--coalesce-rows", "2048"),
     ("--async-sink",))],
    ids=["columnar", "envelope", "hash", "depth3-coalesce-async"])
def test_score_cli_writes_the_parquet_of_the_jax_score(score_files, capsys,
                                                       flags, port_flags):
    """The port's ``score`` against the JAX package's on the same files.
    The port's async sink is held against the JAX synchronous sink: the
    parts do not depend on which thread writes them, and the JAX
    package's async writer has the pyarrow crash that the port's writer
    avoids (``io/sink.py::AsyncSink``)."""
    jstats, tstats, jout, tout = _score_both(score_files, capsys, flags,
                                             port_flags)
    assert tstats["rows"] == jstats["rows"] == 3000
    assert tstats["batches"] == jstats["batches"]
    assert tstats["device"] == "cpu" and tstats["kind"] == "forest"
    _assert_outputs(tout, jout)
    assert tout["prediction"].std() > 0


@pytest.mark.parametrize("model,flags", [
    ("logreg", ("--online-lr", "0.05")),
    ("forest", ("--reload-model-every", "2")),
    ("logreg", ("--online-lr", "0.05", "--reload-model-every", "2",
                "--pipeline-depth", "1"))],
    ids=["online-lr", "reload", "online-lr-reload-depth1"])
def test_score_cli_learning_flags_write_the_parquet_of_the_jax_score(
        score_files, capsys, model, flags):
    """``--online-lr`` (the in-step SGD on the table's in-band labels) and
    ``--reload-model-every`` (the first due interval reloads the file: a
    swap that clobbers the SGD's updates) against the JAX ``score``,
    column by column; probabilities within ``atol=1e-6`` (the SGD's
    params differ by ulps, ``tests/test_torch_online_sgd.py``)."""
    d = score_files
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / f"{model}.npz"), "--batch-rows", "1024", *flags]
    tag = model + "-".join(f.strip("-") for f in flags)
    jdir, tdir = d / f"jax-{tag}", d / f"port-{tag}"
    assert jcli_main(["score", "--out", str(jdir), *common]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out", str(tdir),
                      *common]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["rows"] == jstats["rows"] == 3000
    jout = ParquetSink(str(jdir)).read_all()
    tout = ParquetSink(str(tdir)).read_all()
    _assert_outputs(tout, jout)
    if "--online-lr" in flags:
        # the SGD moved the model: the scores differ from a static run
        static = d / f"port-{tag}-static"
        assert tcli.main(["score", "--device", "cpu", "--out", str(static),
                          "--data", str(d / "txs.npz"), "--model-file",
                          str(d / f"{model}.npz"), "--batch-rows",
                          "1024"]) == 0
        capsys.readouterr()
        assert not np.array_equal(
            ParquetSink(str(static)).read_all()["prediction"],
            tout["prediction"])


def test_score_cli_learn_registry_as_the_jax_score(score_files, capsys,
                                                   tmp_path):
    """``--learn-registry``: the serving model bootstraps as v1 in a
    registry each package opens; a second run adopts the champion (the
    JAX registry served by the port too); with the registry, the reloader
    swaps only on a change of the file, so an unchanged one never
    reloads."""
    d = score_files
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "logreg.npz"), "--batch-rows", "1024",
              "--reload-model-every", "1"]
    jreg, treg = tmp_path / "jreg", tmp_path / "treg"
    assert jcli_main(["score", "--learn-registry", str(jreg),
                      "--out", str(tmp_path / "j"), *common]) == 0
    assert tcli.main(["score", "--device", "cpu", "--learn-registry",
                      str(treg), "--out", str(tmp_path / "t"),
                      *common]) == 0
    # the JAX registry, served by the port
    assert tcli.main(["score", "--device", "cpu", "--learn-registry",
                      str(jreg), "--out", str(tmp_path / "tj"),
                      *common]) == 0
    capsys.readouterr()
    from real_time_fraud_detection_system_tpu.io.registry import (
        make_model_registry as jmake_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )

    for reg in (make_model_registry(str(treg)),
                jmake_model_registry(str(jreg))):
        assert reg.versions() == [1] and reg.champion_version() == 1
        assert reg.meta(1)["source"] == "bootstrap"
    _assert_outputs(ParquetSink(str(tmp_path / "t")).read_all(),
                    ParquetSink(str(tmp_path / "j")).read_all())
    _assert_outputs(ParquetSink(str(tmp_path / "tj")).read_all(),
                    ParquetSink(str(tmp_path / "j")).read_all())


@pytest.mark.parametrize("seed_initial", [False, True])
def test_model_reloader_gates_on_the_files_mtime(score_files, tmp_path,
                                                seed_initial):
    """The first due interval reloads unless the startup mtime is the
    baseline (``--learn-registry``); afterwards only a new mtime reloads,
    and an artifact of another kind is refused."""
    import logging
    import shutil

    path = tmp_path / "model.npz"
    shutil.copy(score_files / "logreg.npz", path)
    sig: dict = {}
    poll = tcli._make_model_reloader(str(path), "logreg", 2,
                                     logging.getLogger("t"),
                                     seed_initial=seed_initial,
                                     sig_state=sig, device="cpu")
    assert poll() is None  # not due
    first = poll()
    assert (first is None) == seed_initial
    assert poll() is None and poll() is None  # unchanged file
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 10 ** 9))
    assert poll() is None  # not due
    params, scaler = poll()
    assert params.w.shape == (15,) and scaler.mean.shape == (15,)
    # a fresh reloader over the same shared baseline keeps it
    again = tcli._make_model_reloader(str(path), "logreg", 1,
                                      logging.getLogger("t"),
                                      seed_initial=seed_initial,
                                      sig_state=sig, device="cpu")
    assert again() is None
    shutil.copy(score_files / "forest.npz", path)
    os.utime(path, ns=(time.time_ns(), time.time_ns() + 2 * 10 ** 9))
    assert again() is None  # a forest for a logreg engine: refused


def test_score_cli_feedback_without_kafka_fails_as_the_jax_score(
        score_files, capsys):
    """``--feedback-bootstrap`` needs ``confluent_kafka``: both commands
    raise ``ModuleNotFoundError`` naming it when the feedback loop is
    built, and print no result."""
    d = score_files
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "logreg.npz"), "--feedback-bootstrap",
              "localhost:9092", "--max-batches", "1"]
    with pytest.raises(ModuleNotFoundError, match="confluent_kafka"):
        jcli_main(["score", *common])
    with pytest.raises(ModuleNotFoundError, match="confluent_kafka"):
        tcli.main(["score", "--device", "cpu", *common])
    assert tcli.main(["score", "--device", "cpu", *common,
                      "--alerts-only"]) == 2
    assert capsys.readouterr().out == ""


def test_score_cli_refuses_exact_keys_and_missing_data(score_files, capsys,
                                                       caplog):
    d = score_files
    base = ["score", "--device", "cpu", "--data", str(d / "txs.npz"),
            "--model-file", str(d / "forest.npz")]
    # --key-mode exact serves (tests/test_torch_cold_store.py); what the
    # JAX score refuses around it, the port refuses with rc 2 too
    assert tcli.main(base + ["--key-mode", "exact", "--cold-store",
                             str(d / "cold")]) == 2
    assert "compact_every" in caplog.text
    assert tcli.main(base + ["--state-compact-every", "2"]) == 2
    assert tcli.main(base + ["--key-mode", "exact",
                             "--state-hbm-budget-mb", "0.01"]) == 2
    assert tcli.main(base + ["--resume-merge", "old:2:1:shrink",
                             "--resume-merge-cold", str(d / "x")]) == 2
    assert "--resume-merge requires --checkpoint-dir" in caplog.text
    assert tcli.main(["score", "--device", "cpu", "--model-file",
                      str(d / "forest.npz")]) == 2
    assert tcli.main(["score", "--device", "cpu", "--data",
                      str(d / "txs.npz"), "--model-file",
                      str(d / "forest.npz"), "--decode-workers",
                      "-1"]) == 2
    assert capsys.readouterr().out == ""


def test_score_cli_alerts_only_and_max_batches(score_files, capsys):
    d = score_files
    assert tcli.main(["score", "--device", "cpu", "--data",
                      str(d / "txs.npz"), "--model-file",
                      str(d / "forest.npz"), "--batch-rows", "1000",
                      "--max-batches", "2", "--alerts-only",
                      "--out", str(d / "alerts")]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["rows"] == 2000 and stats["batches"] == 2
    out = ParquetSink(str(d / "alerts")).read_all()
    assert (out["customer_id_nb_tx_1day_window"] == 0).all()
    assert out["prediction"].std() > 0


def test_score_cli_defaults_to_the_card(score_files):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    d = score_files
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["score", "--data", str(d / "txs.npz"), "--model-file",
                   str(d / "forest.npz")])


def test_score_cli_flag_defaults_match_jax():
    """The flags the two commands share have the same defaults and
    choices."""
    from real_time_fraud_detection_system_tpu import cli as jcli

    jparser = None
    orig = jcli.argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        nonlocal jparser
        jparser = self
        raise SystemExit(0)

    jcli.argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jcli.main(["score"])
    finally:
        jcli.argparse.ArgumentParser.parse_args = orig

    def score_actions(parser):
        sub = next(a for a in parser._actions
                   if isinstance(a, argparse._SubParsersAction))
        return {a.dest: a for a in sub.choices["score"]._actions}

    j, t = score_actions(jparser), score_actions(tcli.build_parser())
    shared = ["data", "model_file", "mode", "source", "out", "batch_rows",
              "max_batches", "key_mode", "alerts_only", "pipeline_depth",
              "coalesce_rows", "async_sink", "sink_queue_batches",
              "decode_workers", "no_fetch_overlap", "z_mode", "start_date",
              "online_lr", "feedback_bootstrap", "feedback_topic",
              "reload_model_every", "learn_registry", "publish_every_labels",
              "promote_min_labels", "promote_margin", "rollback_min_labels",
              "rollback_margin", "precompile", "autobatch", "latency_slo_ms",
              "emit_threshold", "emit_bf16", "nan_guard", "overload",
              "overload_spill", "overload_lag_high",
              "overload_climb_pressure", "overload_descend_pressure",
              "overload_climb_dwell", "overload_descend_dwell",
              "overload_max_deferred", "scorer", "from_date", "to_date",
              "bootstrap", "topic", "idle_timeout", "raw_table",
              "prefetch_batches", "metrics_port", "metrics_dump",
              "healthz_max_batch_age", "healthz_max_lag_rows",
              "flight_record", "flight_record_max_mb", "trace_out",
              "trace_dir"]
    for dest in shared:
        assert t[dest].default == j[dest].default, dest
        assert t[dest].option_strings == j[dest].option_strings, dest
        if j[dest].choices is not None:
            assert list(t[dest].choices) == list(j[dest].choices), dest
    assert t["device"].default == "cuda" and "device" not in j


@pytest.mark.parametrize("flags", [
    ("--nan-guard",),
    ("--emit-threshold", "1.5"),
    ("--emit-threshold", "0.5", "--alerts-only"),
    ("--emit-threshold", "0.5", "--emit-bf16"),
    ("--latency-slo-ms", "-1"),
    ("--overload", "--overload-descend-pressure", "1.5"),
    ("--overload", "--overload-climb-dwell", "0"),
    ("--learn-registry", "reg", "--emit-bf16"),
], ids=["nan-guard-no-dlq", "threshold-range", "threshold-alerts",
        "threshold-bf16", "slo-negative", "overload-band", "overload-dwell",
        "learn-bf16"])
def test_score_cli_serving_extras_refusals_match_jax(score_files, capsys,
                                                     flags):
    """The serving extras' refusals: exit code 2 from both commands, and
    nothing printed on stdout."""
    d = score_files
    flags = tuple(str(d / f) if f == "reg" else f for f in flags)
    common = ["--data", str(d / "txs.npz"), "--model-file",
              str(d / "forest.npz"), *flags]
    assert jcli_main(["score", *common]) == 2
    assert tcli.main(["score", "--device", "cpu", *common]) == 2
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("flags,port_flags", [
    (("--emit-threshold", "0.72"), ("--precompile",)),
    (("--emit-bf16", "--pipeline-depth", "1"), ()),
    (("--overload", "--overload-spill", "", "--autobatch"), ()),
    ((), ("--nan-guard", "--dead-letter", "dlq.jsonl")),
], ids=["selective-precompile", "bf16", "overload", "nan-guard"])
def test_score_cli_serving_extras_write_the_parquet_of_the_jax_score(
        score_files, capsys, tmp_path, flags, port_flags):
    """The flags reach the engine as the JAX ``score``'s do: the same
    Parquet (``--precompile`` and ``--nan-guard`` change no output;
    autobatch over one-bucket polls of 1,024 rows keeps the batches)."""
    port_flags = tuple(str(tmp_path / f) if f.endswith(".jsonl") else f
                       for f in port_flags)
    jstats, tstats, jout, tout = _score_both(score_files, capsys, flags,
                                             port_flags)
    assert tstats["rows"] == jstats["rows"] == 3000
    _assert_outputs(tout, jout)
    if "--emit-threshold" in flags:
        assert tstats["selective_overflows"] == \
            jstats["selective_overflows"] == 0
        flagged = tout["prediction"] >= 0.72
        assert 0 < flagged.sum() < len(flagged)
        assert (tout["customer_id_nb_tx_1day_window"][~flagged] == 0).all()
    if "--nan-guard" in port_flags:
        assert tstats["dead_letter_rows"] == 0
