"""Port parity: checkpoints move between the two packages both ways.

For each served kind and feature mode, the JAX engine and the port's
``ScoringEngine(device="cpu")`` serve the same 1,024-row stream in 256-row
batches with a checkpointer every 2 batches, each writing with its own
package's ``Checkpointer``. Then each package restores the OTHER's
checkpoint at batch 2 and serves the rest of the stream:

- JAX → port: the port's continuation and final state against the JAX
  engine's uninterrupted run;
- port → JAX: the JAX engine, restored from the port's checkpoint, against
  its own uninterrupted run;
- and the two packages' ``__meta__``, leaf spec and fingerprint of the
  checkpoint at batch 2 are identical.

Tolerances (those of ``tests/test_torch_engine.py`` and
``tests/test_torch_hash_cms.py``): bucket days, counts, fraud sums, flags,
sketch slice days and decisions bit for bit; amount sums and averages
within ``rtol=1e-6`` (float32 sums in another order); probabilities within
``atol=1e-6`` (logreg, forest, tree: the dot or the tree sum in another
order) and ``rtol=1e-5, atol=1e-6`` (gbt: a sigmoid of such a sum).
"""

import io
import json
import os

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
from real_time_fraud_detection_system_tpu.core import batch as jbatch
from real_time_fraud_detection_system_tpu.features import online as jonline
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io.sink import (
    MemorySink as JMemorySink,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
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
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    get_registry,
)

torch.set_num_threads(1)

START = 1_743_465_600
ROWS = 1024
BATCH = 256
RTOL_SUM_ORDER = 1e-6
TOL_PROB = {"logreg": dict(rtol=0.0, atol=1e-6),
            "forest": dict(rtol=0.0, atol=1e-6),
            "tree": dict(rtol=0.0, atol=1e-6),
            "gbt": dict(rtol=1e-5, atol=1e-6)}
EXACT_STATE = ("bucket_day", "count", "fraud", "slice_day", "keys", "slots",
               "free", "free_top")

# (id, kind, feature fields). "tree-deep" is one depth-13 tree, too large
# for the GEMM form: both engines keep the descent form, whose Python
# ``max_depth`` is a 0-d leaf (int32 once the JAX step has returned it).
CASES = [
    ("logreg-direct", "logreg", {}),
    ("logreg-hash", "logreg", {"key_mode": "hash"}),
    ("forest-direct", "forest", {}),
    ("forest-hash", "forest", {"key_mode": "hash"}),
    ("forest-cms", "forest", {"customer_source": "cms"}),
    ("gbt-direct", "gbt", {}),
    ("gbt-hash", "gbt", {"key_mode": "hash"}),
    ("gbt-cms", "gbt", {"customer_source": "cms"}),
    ("tree-deep-direct", "tree", {}),
    # the tiered store: key directories, the terminal sketch's fraud
    # column and a compaction pass per checkpoint interval
    ("logreg-exact", "logreg", {"key_mode": "exact", "compact_every": 2}),
    ("forest-exact", "forest", {"key_mode": "exact", "compact_every": 2}),
    ("gbt-exact", "gbt", {"key_mode": "exact", "compact_every": 2}),
]


def _port_txs(txs) -> Transactions:
    return Transactions(*[getattr(txs, f) for f in (
        "tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
        "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")])


def _jax_params(case_id: str, kind: str):
    if kind == "logreg":
        rng = np.random.default_rng(9)
        return JLogRegParams(
            w=jnp.asarray(rng.normal(0, 0.8, 15).astype(np.float32)),
            b=jnp.float32(-1.0))
    if kind == "gbt":
        return jgbt.synthetic_gbt(8, 4, 15, seed=3)
    if case_id.startswith("tree-deep"):
        return jforest.synthetic_ensemble(1, 13, 15, seed=5)
    return jforest.synthetic_ensemble(10, 5, 15, seed=3)


def _configs(features: dict):
    fields = dict(customer_capacity=256, terminal_capacity=512,
                  cms_width=1 << 8, **features)
    runtime = dict(batch_buckets=(BATCH,), checkpoint_every_batches=2)
    jcfg = JConfig(features=JFeatureConfig(**fields),
                   runtime=JRuntimeConfig(max_batch_rows=BATCH, **runtime))
    tcfg = Config(features=FeatureConfig(**fields),
                  runtime=RuntimeConfig(**runtime))
    return jcfg, tcfg


def _scaler():
    rng = np.random.default_rng(3)
    return (rng.normal(3, 1, 15).astype(np.float32),
            rng.uniform(0.5, 3, 15).astype(np.float32))


def _assert_outputs(tout: dict, jout: dict, kind: str) -> None:
    assert sorted(tout) == sorted(jout)
    for col in tout:
        if col == "processed_at_us":
            continue
        if col == "prediction":
            np.testing.assert_allclose(tout[col], jout[col],
                                       **TOL_PROB[kind])
            assert np.array_equal(tout[col] >= 0.5, jout[col] >= 0.5)
        elif "avg_amount" in col:
            np.testing.assert_allclose(tout[col], jout[col],
                                       rtol=RTOL_SUM_ORDER)
        else:
            np.testing.assert_array_equal(tout[col], jout[col], err_msg=col)


def _assert_state(tstate, jstate) -> None:
    """The port's feature state against the JAX package's, leaf by leaf
    (both flatten to the same named leaves)."""
    tleaves = tree.leaves_with_path(tstate)
    jleaves = jax.tree_util.tree_flatten_with_path(jstate)[0]
    assert [p for p, _ in tleaves] == [jax.tree_util.keystr(p)
                                       for p, _ in jleaves]
    for (path, t), (_, j) in zip(tleaves, jleaves):
        t, j = t.numpy(), np.asarray(j)
        assert t.dtype == j.dtype and t.shape == j.shape, path
        if path.rsplit(".", 1)[-1] in EXACT_STATE:
            np.testing.assert_array_equal(t, j, err_msg=path)
        else:
            np.testing.assert_allclose(t, j, rtol=RTOL_SUM_ORDER,
                                       err_msg=path)


def _concat_from(sink_batches: list, first: int) -> dict:
    keep = sink_batches[first:]
    return {k: np.concatenate([b[k] for b in keep]) for k in keep[0]}


@pytest.fixture(scope="module", params=CASES, ids=[c[0] for c in CASES])
def crossed(request, small_dataset, tmp_path_factory):
    """Both engines' uninterrupted checkpointed runs, then each package's
    continuation from the other's checkpoint at batch 2."""
    case_id, kind, features = request.param
    tmp = tmp_path_factory.mktemp(case_id)
    jtxs = small_dataset[3].slice(slice(0, ROWS))
    txs = _port_txs(jtxs)
    jcfg, tcfg = _configs(features)
    mean, scale = _scaler()
    jparams = _jax_params(case_id, kind)
    tparams = weights.from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")

    def port_engine():
        return ScoringEngine(tcfg, kind, tparams,
                             Scaler(torch.from_numpy(mean),
                                    torch.from_numpy(scale)), device="cpu")

    jeng = JScoringEngine(jcfg, kind=kind, params=jparams,
                          scaler=JScaler(jnp.asarray(mean),
                                         jnp.asarray(scale)))
    jdir, tdir = str(tmp / "jax"), str(tmp / "port")
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=BATCH), sink=jsink,
             checkpointer=jckpt.Checkpointer(jdir))
    jout = {"all": jsink.concat(), "tail": _concat_from(jsink.batches, 2)}
    jfinal = jax.tree.map(lambda a: np.array(a, copy=True),
                          jeng.state.feature_state)

    teng = port_engine()
    tsink = MemorySink()
    teng.run(ReplaySource(txs, START, batch_rows=BATCH), tsink,
             checkpointer=tckpt.Checkpointer(tdir))

    # JAX → port: the port restores the JAX checkpoint at batch 2
    into_port = port_engine()
    assert tckpt.Checkpointer(jdir).restore(
        into_port.state, path=f"{jdir}/ckpt-0000000002.npz") is not None
    assert into_port.state.batches_done == 2
    src = ReplaySource(txs, START, batch_rows=BATCH)
    src.seek(into_port.state.offsets)
    port_tail = MemorySink()
    into_port.run(src, port_tail)

    # port → JAX: the JAX engine restores the port's checkpoint at batch 2
    assert jckpt.Checkpointer(tdir).restore(
        jeng.state, path=f"{tdir}/ckpt-0000000002.npz") is not None
    assert jeng.state.batches_done == 2
    jsrc = JReplaySource(jtxs, START, batch_rows=BATCH)
    jsrc.seek(jeng.state.offsets)
    jax_tail = JMemorySink()
    jeng.run(jsrc, sink=jax_tail)
    return dict(kind=kind, jout=jout, jfinal=jfinal, teng=teng,
                tout=tsink.concat(), into_port=into_port,
                port_tail=port_tail.concat(), jeng=jeng,
                jax_tail=jax_tail.concat(), jdir=jdir, tdir=tdir)


def test_port_serves_on_from_a_jax_checkpoint(crossed):
    c = crossed
    _assert_outputs(c["port_tail"], c["jout"]["tail"], c["kind"])
    _assert_state(c["into_port"].state.feature_state, c["jfinal"])
    assert c["into_port"].state.batches_done == ROWS // BATCH
    assert c["into_port"].state.rows_done == ROWS
    assert c["into_port"].state.offsets == [ROWS]


def test_jax_serves_on_from_a_port_checkpoint(crossed):
    c = crossed
    _assert_outputs(c["jax_tail"], c["jout"]["tail"], c["kind"])
    # the port's own uninterrupted run, too
    _assert_outputs(c["tout"], c["jout"]["all"], c["kind"])
    _assert_state(c["teng"].state.feature_state, c["jfinal"])
    assert c["jeng"].state.batches_done == ROWS // BATCH
    assert c["jeng"].state.rows_done == ROWS


def test_checkpoint_meta_spec_and_fingerprint_match_jax(crossed):
    c = crossed
    name = "ckpt-0000000002.npz"
    jman = jckpt.Checkpointer(c["jdir"]).manifest(f"{c['jdir']}/{name}")
    tman = tckpt.Checkpointer(c["tdir"]).manifest(f"{c['tdir']}/{name}")
    assert tman["meta"] == jman["meta"]
    assert tman["spec"] == jman["spec"]
    assert tman["fingerprint"] == jman["fingerprint"]
    assert tman["stored"] == jman["stored"] and tman["kind"] == "full"
    # the leaves a restore would compare against: the live state's spec
    assert tckpt._template_spec(c["teng"].state) == jckpt._template_spec(
        c["jeng"].state)
    if c["kind"] == "tree":
        p = [k for k, (shape, dt) in tman["spec"].items()
             if k.startswith("p_") and shape == [] and dt == "int32"]
        assert p == ["p_5"]  # TreeEnsemble.max_depth


def test_cms_state_carries_across_leaf_for_leaf(crossed):
    """``weights.from_numpy`` carries the JAX engine's whole feature state
    across — the customer sketch and the tiered store's directories and
    terminal sketch too — bit for bit."""
    jstate = crossed["jeng"].state.feature_state
    moved = weights.from_numpy(jax.tree.map(np.asarray, jstate),
                               device="cpu")
    jleaves = jax.tree_util.tree_leaves(jstate)
    tleaves = tree.leaves(moved)
    tiered = 12 if jstate.terminal_dir is not None else 0
    assert len(tleaves) == len(jleaves) == (
        11 if jstate.cms is not None else 8) + tiered
    for t, j in zip(tleaves, jleaves):
        assert t.numpy().dtype == np.asarray(j).dtype
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_weights_refuse_the_tiered_store():
    """The tiered store's records carry across since the port serves it:
    a JAX ``key_mode="exact"`` feature state after a batch (key
    directories, the terminal sketch's fraud column), and each record on
    its own, arrive leaf for leaf with the JAX dtypes and values; a
    record of fields no port record has is still refused."""
    jcfg = JFeatureConfig(key_mode="exact", customer_capacity=16,
                          terminal_capacity=16, cms_width=1 << 6)
    rng = np.random.default_rng(4)
    n = 64
    jstate, _, _ = jonline.update_and_featurize_exact(
        jonline.init_feature_state(jcfg),
        jax.tree.map(jnp.asarray, jbatch.make_batch(
            customer_id=rng.integers(0, 40, n).astype(np.int64),
            terminal_id=rng.integers(0, 40, n).astype(np.int64),
            tx_datetime_us=np.full(n, 20200 * 86_400_000_000, np.int64),
            amount_cents=np.full(n, 500, np.int64),
            label=rng.integers(0, 2, n))), jcfg)
    host = jax.tree.map(np.asarray, jstate)
    moved = weights.from_numpy(host, device="cpu")
    jleaves = jax.tree_util.tree_leaves(host)
    tleaves = tree.leaves(moved)
    assert len(tleaves) == len(jleaves) == 23
    for t, j in zip(tleaves, jleaves):
        assert t.numpy().dtype == j.dtype
        np.testing.assert_array_equal(t.numpy(), j)
    assert int(moved.terminal_dir.free_top) < 16  # the batch took slots
    kd = weights.from_numpy(host.terminal_dir, device="cpu")
    assert kd.keys.dtype == torch.uint32 and kd.free_top.shape == ()
    sk = weights.from_numpy(host.terminal_cms, device="cpu")
    np.testing.assert_array_equal(sk.fraud.numpy(), host.terminal_cms.fraud)
    with pytest.raises(ValueError, match="no port record"):
        weights.from_numpy(dict(customer_dir={"keys": np.zeros(4)}),
                           device="cpu")


def _rewrite_meta(path: str, **meta_fields) -> None:
    """The same arrays and manifest with other ``__meta__`` values: the
    leaf CRCs still hold, so only the stamps differ."""
    with np.load(path, allow_pickle=False) as z:
        entries = {k: z[k] for k in z.files}
    meta = json.loads(str(entries.pop("__meta__")))
    meta.update(meta_fields)
    buf = io.BytesIO()
    np.savez(buf, __meta__=json.dumps(meta), **entries)
    with open(path, "wb") as f:
        f.write(buf.getvalue())


@pytest.mark.parametrize("stamps,error,item", [
    (dict(process_count=2, process_id=1), tckpt.CheckpointTopologyError,
     "merge_process_states"),
    (dict(layout_devices=4), None, None),
    (dict(resize_epochs=[{"generation": 1}]), None, None),
    (dict(cold_lineage={"segments": [{"seq": 0}]}), None, None),
], ids=["processes", "devices", "resized", "cold-tier"])
def test_restore_refuses_what_the_port_cannot_serve(tmp_path, stamps, error,
                                                    item):
    """A healthy checkpoint of one process of a 2-process fleet restored
    into a single-process engine raises, naming the merge (as the JAX
    checkpointer refuses it); it is never quarantined. A cold-tier
    lineage and a fleet's resize epochs are served: the restore hands
    them back to the engine. So is a one-process checkpoint of 4 shards
    (the sharded engine's layout): the restore stamps the writer's width
    and the engine converts the state before its next step
    (``tests/test_torch_sharded_engine.py``)."""
    cfg = Config(features=FeatureConfig(customer_capacity=64,
                                        terminal_capacity=128))
    params = weights.from_numpy(jax.tree.map(np.asarray, _jax_params(
        "logreg", "logreg")), device="cpu")
    scaler = Scaler(torch.zeros(15), torch.ones(15))
    eng = ScoringEngine(cfg, "logreg", params, scaler, device="cpu")
    ck = tckpt.Checkpointer(str(tmp_path))
    path = ck.save(eng.state)
    _rewrite_meta(path, **stamps)
    before = get_registry().family_total("rtfds_checkpoint_corrupt_total")
    fresh = ScoringEngine(cfg, "logreg", params, scaler, device="cpu")
    if error is None:
        assert ck.restore(fresh.state) is fresh.state
        assert fresh.state.cold_lineage == stamps.get("cold_lineage")
        assert fresh.state.layout_devices == stamps.get("layout_devices", 1)
        assert fresh.state.resize_epochs == stamps.get("resize_epochs")
    else:
        with pytest.raises(error, match=item):
            ck.restore(fresh.state)
    assert ck.latest() == path and os.path.exists(path)
    assert get_registry().family_total(
        "rtfds_checkpoint_corrupt_total") == before


def test_restore_refuses_a_jax_exact_mode_checkpoint(tmp_path,
                                                     small_dataset):
    """The JAX package's tiered store (``key_mode="exact"``) with a hot
    tier too small for the slice, so rows overflow to the sketch tier:
    its checkpoint at batch 2 restores into the port (directories bit for
    bit, nothing quarantined) and the port serves the rest of the slice as
    the JAX engine did."""
    jtxs = small_dataset[3].slice(slice(0, ROWS))
    fields = dict(customer_capacity=64, terminal_capacity=64,
                  cms_width=1 << 8, key_mode="exact", compact_every=2)
    jcfg = JConfig(features=JFeatureConfig(**fields),
                   runtime=JRuntimeConfig(batch_buckets=(BATCH,),
                                          max_batch_rows=BATCH,
                                          checkpoint_every_batches=2))
    mean, scale = _scaler()
    jeng = JScoringEngine(jcfg, kind="logreg",
                          params=_jax_params("logreg", "logreg"),
                          scaler=JScaler(jnp.asarray(mean),
                                         jnp.asarray(scale)))
    jsink = JMemorySink()
    jeng.run(JReplaySource(jtxs, START, batch_rows=BATCH), sink=jsink,
             checkpointer=jckpt.Checkpointer(str(tmp_path)))
    tcfg = Config(features=FeatureConfig(**fields),
                  runtime=RuntimeConfig(batch_buckets=(BATCH,)))
    eng = ScoringEngine(tcfg, "logreg", weights.from_numpy(
        jax.tree.map(np.asarray, jeng.state.params), device="cpu"),
        Scaler(torch.from_numpy(mean), torch.from_numpy(scale)),
        device="cpu")
    ck = tckpt.Checkpointer(str(tmp_path))
    latest = ck.latest()
    path = f"{tmp_path}/ckpt-0000000002.npz"
    assert ck.restore(eng.state, path=path) is eng.state
    assert eng.state.batches_done == 2
    src = ReplaySource(_port_txs(jtxs), START, batch_rows=BATCH)
    src.seek(eng.state.offsets)
    tail = MemorySink()
    eng.run(src, tail)
    _assert_outputs(tail.concat(), _concat_from(jsink.batches, 2), "logreg")
    _assert_state(eng.state.feature_state, jeng.state.feature_state)
    assert int(eng.state.feature_state.customer_dir.free_top) == 0
    assert ck.latest() == latest
