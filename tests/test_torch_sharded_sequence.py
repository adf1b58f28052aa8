"""Port parity: the sequence kind over shards
(``parallel/sequence_step.py``, ``ShardedScoringEngine(kind="sequence")``)
against the JAX package's sharded engine on the 8 virtual devices of
``tests/conftest.py`` — the eight cases of ``tests/test_sharded_sequence.py``
(equality with one shard, the hot-key spill, same-second ties, feedback
not wired, checkpoint resume, the 1→N reshard, the run loop and sink, the
non-power-of-2 refusal), plus checkpoints that cross between the packages
both ways, restores at another width through ``feature_state_n_old``, the
topology refusal, and the stacked step against separate per-shard states.

The weights are the JAX package's ``init_transformer`` carried over by
``weights.from_numpy``; the streams are numpy from a seed.

Tolerances, and why they hold:

- probabilities within ``atol=1e-5``, the JAX test's own tolerance: the
  transformer's products are XLA's on one side and torch's on the other,
  and the sharded and single engines run them over other batch shapes
  (a few ulps of float32 reach the logit through layer norms);
- the history rings' integer leaves (``pos``, ``count``, ``last_t``)
  equal bit for bit; their event features (``events``, log1p and sin/cos
  of the same inputs in two libraries) within ``atol=1e-6``; the sink row
  of each block holds no fixed content and is left out;
- a resharded state equals the JAX reshard's bit for bit (a permutation
  of the same arrays), and the 1→8→4→1 round trip is lossless;
- the stacked step equals the per-shard states bit for bit, sinks
  included: the same operations on the same rows.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    ParquetSink as JParquetSink,
)
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.sequence import (
    init_transformer,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu.parallel import (
    sequence_step as jseqstep,
)
from real_time_fraud_detection_system_tpu.runtime import (
    ShardedScoringEngine as JShardedEngine,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.features.history import (
    init_history_state,
    update_and_score,
)
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.parallel import (
    sequence_step as tseqstep,
)
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    make_mesh,
)
from real_time_fraud_detection_system_tpu_torch.runtime.distributed import (
    ProcessTopology,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine import (
    ShardedScoringEngine,
)

torch.set_num_threads(1)

ATOL_PROB = 1e-5
ATOL_EVENTS = 1e-6
T0 = 20000 * 86400


def _fields():
    return dict(customer_capacity=64, terminal_capacity=64, history_len=8)


def _rt(rows, checkpoint_every):
    return dict(batch_buckets=(rows,), max_batch_rows=rows,
                trigger_seconds=0.0,
                checkpoint_every_batches=checkpoint_every)


def _cfg(rows=64, checkpoint_every=50):
    return Config(features=FeatureConfig(**_fields()),
                  runtime=RuntimeConfig(**_rt(rows, checkpoint_every)))


def _jcfg(rows=64, checkpoint_every=50):
    return JConfig(features=JFeatureConfig(**_fields()),
                   runtime=JRuntimeConfig(**_rt(rows, checkpoint_every)))


def _stream_cols(n_batches, rows, n_cust=24, seed=1):
    """The JAX test's stream: one day per batch, times sorted."""
    rng = np.random.default_rng(seed)
    out, t, tx = [], T0, 0
    for _ in range(n_batches):
        t_s = t + np.sort(rng.integers(0, 86400, rows))
        out.append({
            "tx_id": np.arange(tx, tx + rows, dtype=np.int64),
            "tx_datetime_us": (t_s * 1_000_000).astype(np.int64),
            "customer_id": rng.integers(0, n_cust, rows).astype(np.int64),
            "terminal_id": rng.integers(0, 40, rows).astype(np.int64),
            "tx_amount_cents": rng.integers(100, 90000, rows,
                                            dtype=np.int64),
            "kafka_ts_ms": (t_s * 1000).astype(np.int64),
        })
        t += 86400
        tx += rows
    return out


def _hot_cols(rows, t_s, amounts, customer, seed=7):
    rng = np.random.default_rng(seed)
    return {
        "tx_id": np.arange(rows, dtype=np.int64),
        "tx_datetime_us": (t_s * 1_000_000).astype(np.int64),
        "customer_id": np.full(rows, customer, dtype=np.int64),
        "terminal_id": rng.integers(0, 40, rows).astype(np.int64),
        "tx_amount_cents": amounts,
        "kafka_ts_ms": (t_s * 1000).astype(np.int64),
    }


def _spill_cols():
    """One dominant customer: 128 rows, more than one shard's budget."""
    rng = np.random.default_rng(7)
    t_s = T0 + np.sort(rng.integers(0, 86400, 128))
    return _hot_cols(128, t_s, rng.integers(100, 90000, 128,
                                            dtype=np.int64), 5)


def _tie_cols():
    """64 rows of one customer in ONE second."""
    t_s = np.full(64, T0 + 1234, dtype=np.int64)
    return _hot_cols(64, t_s, (np.arange(64) * 137 + 100).astype(np.int64),
                     3, seed=0) | {"terminal_id": np.zeros(64, np.int64)}


@pytest.fixture(scope="module")
def jparams():
    return init_transformer(d_model=16, n_heads=2, n_layers=1, d_ff=32,
                            seed=4)


@pytest.fixture(scope="module")
def tparams(jparams):
    return weights.from_numpy(jax.tree.map(np.asarray, jparams),
                              device="cpu")


def _scaler():
    return Scaler(torch.zeros(15), torch.ones(15))


def _jscaler():
    return JScaler(mean=jnp.zeros(15), scale=jnp.ones(15))


def _port(tparams, cfg=None, **kw):
    return ShardedScoringEngine(cfg or _cfg(), "sequence", tparams,
                                _scaler(), device="cpu", **kw)


def _single(tparams, cfg=None):
    return ScoringEngine(cfg or _cfg(), "sequence", tparams, _scaler(),
                         device="cpu")


def _jax(jparams, cfg=None, **kw):
    return JShardedEngine(cfg or _jcfg(), kind="sequence", params=jparams,
                          scaler=_jscaler(), **kw)


def _by_tx(r):
    return np.asarray(r.probs)[np.argsort(np.asarray(r.tx_id))]


def _assert_history(t_state, j_state, what=""):
    """Stacked history states equal off the sink rows."""
    names = ("events", "pos", "count", "last_t")
    for name, a, b in zip(names, t_state, j_state):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.shape == b.shape, (what, name)
        if name == "events":
            np.testing.assert_allclose(a[:, :-1], b[:, :-1],
                                       atol=ATOL_EVENTS, err_msg=what)
        else:
            np.testing.assert_array_equal(a[:, :-1], b[:, :-1],
                                          err_msg=f"{what} {name}")


# -- the eight cases of tests/test_sharded_sequence.py --------------------

@pytest.fixture(scope="module")
def jax_three_batches(jparams):
    """The JAX sharded engine (8 shards) over the three-batch stream: its
    probabilities per batch and its final state."""
    jeng = _jax(jparams, n_devices=8)
    probs = [_by_tx(jeng.process_batch(dict(c)))
             for c in _stream_cols(3, 64)]
    return probs, jax.tree.map(np.asarray, jeng.state.feature_state)


def test_sharded_sequence_matches_single_chip(tparams, jax_three_batches):
    jprobs, jstate = jax_three_batches
    single = _single(tparams)
    sharded = _port(tparams, n_devices=8)
    for i, cols in enumerate(_stream_cols(3, 64)):
        r1 = _by_tx(single.process_batch(dict(cols)))
        r2 = _by_tx(sharded.process_batch(dict(cols)))
        np.testing.assert_allclose(r2, r1, atol=ATOL_PROB,
                                   err_msg=f"batch {i} vs single")
        np.testing.assert_allclose(r2, jprobs[i], atol=ATOL_PROB,
                                   err_msg=f"batch {i} vs JAX")
    assert sharded.chunks_done == 3  # owner-local chunks only
    _assert_history(sharded.state.feature_state, jstate)


@pytest.fixture(scope="module")
def jax_spill(jparams):
    return (_by_tx(_jax(jparams, n_devices=8, rows_per_shard=16)
                   .process_batch(_spill_cols())),
            _by_tx(_jax(jparams, n_devices=8, rows_per_shard=8)
                   .process_batch(_tie_cols())))


def test_sharded_sequence_hot_key_spill(tparams, jax_spill):
    """One dominant customer forces routed spill chunks; the scores still
    equal the single engine's and the JAX sharded engine's."""
    single = _single(tparams, _cfg(rows=128))
    sharded = _port(tparams, n_devices=8, rows_per_shard=16)
    r1 = _by_tx(single.process_batch(_spill_cols()))
    r2 = _by_tx(sharded.process_batch(_spill_cols()))
    assert len(r2) == 128
    assert sharded.chunks_done == 2  # chunk 0 and one routed spill chunk
    np.testing.assert_allclose(r2, r1, atol=ATOL_PROB)
    np.testing.assert_allclose(r2, jax_spill[0], atol=ATOL_PROB)


def test_sharded_sequence_spill_same_second_ties(tparams, jax_spill):
    """Same-second bursts of one hot customer land in the ring in the
    single engine's order: the routed exchange regroups rows by sender,
    and the original batch position that rides with each row keeps the
    order."""
    single = _single(tparams)
    sharded = _port(tparams, n_devices=8, rows_per_shard=8)
    r1 = _by_tx(single.process_batch(_tie_cols()))
    r2 = _by_tx(sharded.process_batch(_tie_cols()))
    assert sharded.chunks_done > 1
    np.testing.assert_allclose(r2, r1, atol=ATOL_PROB)
    np.testing.assert_allclose(r2, jax_spill[1], atol=ATOL_PROB)


def test_sharded_sequence_feedback_not_wired(tparams, jparams):
    args = (np.array([1]), np.array([20000]), np.array([1]))
    with pytest.raises(ValueError, match="sequence") as t:
        _port(tparams, n_devices=2).apply_state_feedback(*args)
    with pytest.raises(ValueError) as j:
        _jax(jparams, n_devices=2).apply_state_feedback(*args)
    assert str(t.value) == str(j.value)


class _Src:
    def __init__(self, batches):
        self._b, self._i = batches, 0

    def poll_batch(self):
        if self._i >= len(self._b):
            return None
        self._i += 1
        return dict(self._b[self._i - 1])

    @property
    def offsets(self):
        return [self._i]

    def seek(self, o):
        self._i = int(o[0])


@pytest.fixture(scope="module")
def jax_checkpointed(jparams, tmp_path_factory):
    """The JAX sharded engine (4 shards) over five batches, and the
    directory of another run stopped after two, a checkpoint after every
    batch (the newest, batch 2, kept)."""
    d = str(tmp_path_factory.mktemp("jax-seq-ckpt"))
    batches = _stream_cols(5, 64, seed=11)
    sink = JMemorySink()
    _jax(jparams, n_devices=4).run(_Src(batches), sink=sink)
    _jax(jparams, _jcfg(checkpoint_every=1), n_devices=4).run(
        _Src(batches), sink=JMemorySink(), max_batches=2,
        checkpointer=jckpt.Checkpointer(d))
    return sink.concat(), d


def test_sequence_checkpoint_resume_matches_uninterrupted(
        tparams, jparams, jax_checkpointed, tmp_path):
    """Crash-replay for the stacked history state: resume a 4-shard
    engine from its checkpoint mid-stream and finish — the output equals
    a run that never stopped, and the JAX sharded engine's. Then the
    checkpoints cross: the port resumes the JAX engine's, the JAX engine
    the port's, each finishing as the uninterrupted run."""
    cfg = _cfg(checkpoint_every=1)
    batches = _stream_cols(5, 64, seed=11)
    jout, jdir = jax_checkpointed

    sink_a = MemorySink()
    _port(tparams, cfg, n_devices=4).run(
        _Src(batches), sink_a, checkpointer=tckpt.Checkpointer(
            str(tmp_path / "a")))
    a = sink_a.concat()
    np.testing.assert_array_equal(a["tx_id"], jout["tx_id"])
    np.testing.assert_allclose(a["prediction"], jout["prediction"],
                               atol=ATOL_PROB)

    def finish(eng, ck, path=None):
        assert ck.restore(eng.state, path=path) is not None
        assert eng.state.batches_done == 2
        src = _Src(batches)
        src.seek(eng.state.offsets)
        sink = MemorySink() if isinstance(eng, ShardedScoringEngine) \
            else JMemorySink()
        eng.run(src, sink=sink)
        return sink.concat()

    ck = tckpt.Checkpointer(str(tmp_path / "b"))
    _port(tparams, cfg, n_devices=4).run(
        _Src(batches), MemorySink(), max_batches=2, checkpointer=ck)
    two = f"{tmp_path / 'b'}/ckpt-0000000002.npz"
    for name, out in (
            ("port", finish(_port(tparams, cfg, n_devices=4), ck)),
            ("JAX → port", finish(_port(tparams, cfg, n_devices=4),
                                  tckpt.Checkpointer(jdir),
                                  f"{jdir}/ckpt-0000000002.npz")),
            ("port → JAX", finish(_jax(jparams, _jcfg(checkpoint_every=1),
                                       n_devices=4),
                                  jckpt.Checkpointer(str(tmp_path / "b")),
                                  two))):
        np.testing.assert_array_equal(out["tx_id"], a["tx_id"][2 * 64:],
                                      err_msg=name)
        np.testing.assert_allclose(out["prediction"],
                                   a["prediction"][2 * 64:],
                                   atol=ATOL_PROB, err_msg=name)


def test_elastic_reshard_single_to_sharded(tparams, jparams):
    """Serve batches 0-1 on one engine, re-shard the state 8 ways, serve
    batches 2-4 sharded: the scores of an engine that stayed single. The
    layout round trip 1→8→4→1 is lossless, and each reshard equals the
    JAX package's bit for bit."""
    cfg = _cfg()
    batches = _stream_cols(5, 64, seed=13)
    single = _single(tparams)
    ref = [_by_tx(single.process_batch(dict(b))) for b in batches]

    eng1 = _single(tparams)
    for b in batches[:2]:
        eng1.process_batch(dict(b))
    sharded = _port(tparams, n_devices=8)
    tseqstep.shard_history_state(
        tseqstep.reshard_history_state(eng1.state.feature_state, cfg, 8),
        sharded.mesh, out=sharded.state.feature_state)
    for i, b in enumerate(batches[2:], start=2):
        np.testing.assert_allclose(_by_tx(sharded.process_batch(dict(b))),
                                   ref[i], atol=ATOL_PROB,
                                   err_msg=f"batch {i}")

    s0 = [t.numpy() for t in eng1.state.feature_state]
    s8 = tseqstep.reshard_history_state(eng1.state.feature_state, cfg, 8)
    s4 = tseqstep.reshard_history_state(s8, cfg, 4)
    s1 = tseqstep.reshard_history_state(s4, cfg, 1)
    for a, b in zip(s0, s1):
        # the sink (last row) is scratch: compare the real slots
        np.testing.assert_array_equal(a[:-1], b[:-1])
    jcfg = _jcfg()
    j8 = jseqstep.reshard_history_state(s0, jcfg, 8)
    j4 = jseqstep.reshard_history_state(j8, jcfg, 4)
    for mine, theirs in ((s8, j8), (s4, j4)):
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a, np.asarray(b))


def test_sharded_sequence_run_loop_and_sink(tparams, jparams):
    cols = _stream_cols(3, 64, seed=9)
    sink = MemorySink()
    stats = _port(tparams, n_devices=4).run(_Src(cols), sink)
    assert stats["batches"] == 3
    assert stats["chunks"] == 3
    got = sink.concat()
    assert len(got["tx_id"]) == 3 * 64
    p = got["prediction"]
    assert ((p >= 0) & (p <= 1)).all()
    jsink = JMemorySink()
    _jax(jparams, n_devices=4).run(_Src(cols), sink=jsink)
    np.testing.assert_allclose(p, jsink.concat()["prediction"],
                               atol=ATOL_PROB)


def test_non_pow2_local_capacity_rejected():
    """24576 / 4 = 6144 divides but is not a power of two: the slot mask
    would merge customers. The config refuses the capacity; the reshard
    refuses a non-power-of-2 local capacity with the JAX message."""
    with pytest.raises(ValueError, match="power of two"):
        Config(features=FeatureConfig(customer_capacity=24576,
                                      terminal_capacity=1024,
                                      history_len=8))
    cfg = Config(features=FeatureConfig(
        customer_capacity=8192, terminal_capacity=1024, history_len=8))
    state = init_history_state(cfg.features, "cpu")
    with pytest.raises(ValueError, match="power of two|divide") as t:
        tseqstep.reshard_history_state(state, cfg, 3)
    jcfg = JConfig(features=JFeatureConfig(
        customer_capacity=8192, terminal_capacity=1024, history_len=8))
    with pytest.raises(ValueError) as j:
        jseqstep.reshard_history_state(
            [t.numpy() for t in state], jcfg, 3)
    assert str(t.value) == str(j.value)


# -- beyond the JAX file ---------------------------------------------------

def test_restore_at_another_width_through_feature_state_n_old(tparams):
    """A checkpoint's history state restores into an engine of another
    width through ``feature_state_n_old`` (1→8 and 8→4), and the engine
    serves on as the single engine does."""
    cfg = _cfg()
    batches = _stream_cols(4, 64, seed=21)
    single = _single(tparams)
    ref = [_by_tx(single.process_batch(dict(b))) for b in batches]
    eng1 = _single(tparams)
    eng1.process_batch(dict(batches[0]))
    eng8 = _port(tparams, n_devices=8,
                 feature_state=eng1.state.feature_state,
                 feature_state_n_old=1)
    np.testing.assert_allclose(_by_tx(eng8.process_batch(dict(batches[1]))),
                               ref[1], atol=ATOL_PROB)
    eng4 = _port(tparams, n_devices=4,
                 feature_state=eng8.state.feature_state,
                 feature_state_n_old=8)
    assert eng4.state.feature_state.events.shape[:2] == (4, 17)
    for i in (2, 3):
        np.testing.assert_allclose(
            _by_tx(eng4.process_batch(dict(batches[i]))), ref[i],
            atol=ATOL_PROB, err_msg=f"batch {i}")


def test_sequence_refusals_match_jax(tparams, jparams):
    """A fleet topology and hash keys are refused with the JAX messages,
    a state of another layout without ``feature_state_n_old`` naming it;
    the sequence kind's engine captures no graphs (JAX: no AOT path)."""
    with pytest.raises(ValueError) as t:
        _port(tparams, n_devices=2, topology=ProcessTopology(2, 0, 2))
    assert "not wired for kind='sequence'" in str(t.value)
    hcfg = dataclasses.replace(_cfg(), features=dataclasses.replace(
        _cfg().features, key_mode="hash"))
    jhcfg = dataclasses.replace(_jcfg(), features=dataclasses.replace(
        _jcfg().features, key_mode="hash"))
    with pytest.raises(ValueError) as t:
        _port(tparams, hcfg, n_devices=2)
    with pytest.raises(ValueError) as j:
        _jax(jparams, jhcfg, n_devices=2)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="feature_state_n_old"):
        _port(tparams, n_devices=4, feature_state=init_history_state(
            _cfg().features, "cpu"))
    eng = _port(tparams, n_devices=2)
    assert eng.dispatch_inventory() == []
    assert eng.precompile() == {"buckets": [], "variants": 0,
                                "seconds": 0.0, "skipped": "sequence"}


@pytest.mark.parametrize("route", [False, True], ids=["local", "routed"])
def test_stacked_step_equals_separate_shard_states(tparams, route):
    """The stacked step runs each shard on its block as a state of views;
    it equals n separate one-shard states fed each shard's rows, bit for
    bit and sinks included — so a padded row of shard s lands in block
    s's own sink, never a neighbour's."""
    n, bl = 4, 16
    cfg = _cfg()
    rng = np.random.default_rng(31)
    cust = rng.integers(0, 24, n * bl)
    valid = rng.random(n * bl) < 0.8
    if not route:
        cust = cust - cust % n + np.repeat(np.arange(n), bl)  # owner rows
    t_s = T0 + np.sort(rng.integers(0, 3600, n * bl))
    host = make_batch(customer_id=cust, terminal_id=np.zeros(n * bl,
                                                             np.int64),
                      tx_datetime_us=t_s * 1_000_000,
                      amount_cents=rng.integers(100, 90000, n * bl))
    batch = unpack_batch(torch.from_numpy(pack_batch(
        host._replace(valid=valid))))
    order = torch.from_numpy(rng.permutation(n * bl).astype(np.int32))
    mesh = make_mesh(n, devices=["cpu"] * n)
    stacked = tseqstep.init_sharded_history_state(cfg, mesh)
    for t in stacked:  # a non-blank sink in every block
        t[:, -1] = 7
    _, probs = tseqstep.make_sharded_sequence_step(cfg, mesh, route=route)(
        stacked, tparams, batch, order)

    lcfg = dataclasses.replace(cfg.features, customer_capacity=64 // n)
    owner = (cust % n) if route else np.repeat(np.arange(n), bl)
    want = np.zeros(n * bl, np.float32)
    for s in range(n):
        own = init_history_state(lcfg, "cpu")
        for t in own:
            t[-1] = 7
        rows = np.flatnonzero(owner == s)
        sub = unpack_batch(torch.from_numpy(pack_batch(host._replace(
            valid=valid)))[:, rows].contiguous())
        _, p = update_and_score(
            own, tparams, sub, lcfg,
            lambda k: (k.view(torch.int32).long() & 0xFFFFFFFF) // n,
            order_key=order[rows])
        want[rows] = p.numpy()
        for a, b in zip(stacked, own):
            # routed, the owner's rows arrive beside bucket padding, which
            # writes the sink too: the real slots alone are comparable
            cut = -1 if route else None
            np.testing.assert_array_equal(a[s].numpy()[:cut],
                                          b.numpy()[:cut])
    if route:
        # the owner reads the routed rows in another batch shape
        np.testing.assert_allclose(probs.numpy(), want, atol=ATOL_PROB)
    else:
        np.testing.assert_array_equal(probs.numpy(), want)


def test_score_devices_serves_the_sequence_kind_as_the_jax_score(
        small_dataset, jparams, tmp_path, capsys):
    """``score --devices 4`` with a sequence model writes the JAX
    ``score``'s Parquet: every column equal, predictions within
    ``ATOL_PROB`` (the feature columns are zeros on both sides: the
    sequence kind emits no feature matrix)."""
    jsave_transactions(str(tmp_path / "txs.npz"),
                       small_dataset[3].slice(slice(0, 3000)))
    with open(tmp_path / "sequence.npz", "wb") as f:
        f.write(jdump_model_bytes(JTrainedModel(
            kind="sequence", scaler=_jscaler(), params=jparams)))
    common = ["--data", str(tmp_path / "txs.npz"), "--model-file",
              str(tmp_path / "sequence.npz"), "--batch-rows", "1024",
              "--devices", "4"]
    assert jcli_main(["score", "--out", str(tmp_path / "jax"),
                      *common]) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tcli.main(["score", "--device", "cpu", "--out",
                      str(tmp_path / "port"), *common]) == 0
    tstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tstats["rows"] == jstats["rows"] == 3000
    assert tstats["batches"] == jstats["batches"]
    tout = JParquetSink(str(tmp_path / "port")).read_all()
    jout = JParquetSink(str(tmp_path / "jax")).read_all()
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col], rtol=0.0,
                                       atol=ATOL_PROB)
        else:
            np.testing.assert_array_equal(tout[col], jout[col],
                                          err_msg=col)
