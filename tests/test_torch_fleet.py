"""Port parity: the fleet of processes, in one process — the port's
``runtime/distributed.py``, ``parallel/distributed.py``, the fleet's legs
of ``parallel/mesh.py``, ``PartitionAffineSource`` and
``OwnershipFloorSource``, the sharded engine with a ``topology``, the
fleet's checkpoints, ``runtime/cms_exchange.py``, the cold store's
``rehome``/``consolidate_cold_stores``, ``merge_process_snapshots``,
``runtime/elastic.py`` and the port's launcher's plumbing, each against
the JAX package (``tests/test_multihost.py``, ``test_distributed.py``,
``test_cms_exchange.py``, ``test_elastic.py``). The JAX engines run on
the suite's virtual CPU devices; the port's shards are co-located on the
CPU.

Tolerances. The streams are whole-dollar (float32 sums of whole dollars
are exact in any order; counts and fraud sums are whole numbers), so
every state leaf, feature, sketch table and cold row is compared bit for
bit; logistic probabilities within ``ATOL_PROB`` = 1e-6 (the dot product
in another order). The port's fleet against its own single-process
engine: bit for bit.
"""

import dataclasses
import json
import os
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    DistributedConfig as JDistributedConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    RuntimeConfig as JRuntimeConfig,
)
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io import coldstore as jcold
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.ops import cms as jcms
from real_time_fraud_detection_system_tpu.parallel import (
    distributed as jpdist,
)
from real_time_fraud_detection_system_tpu.parallel import mesh as jmesh
from real_time_fraud_detection_system_tpu.runtime import (
    ShardedScoringEngine as JShardedScoringEngine,
)
from real_time_fraud_detection_system_tpu.runtime import (
    cms_exchange as jxch,
)
from real_time_fraud_detection_system_tpu.runtime import elastic as jel
from real_time_fraud_detection_system_tpu.runtime import sources as jsources
from real_time_fraud_detection_system_tpu.runtime.distributed import (
    ProcessTopology as JProcessTopology,
)
from real_time_fraud_detection_system_tpu.runtime.distributed import (
    bootstrap_distributed as jbootstrap,
)
from real_time_fraud_detection_system_tpu.utils import metrics as jmetrics
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    DistributedConfig,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    fold_key,
    make_batch,
    pack_batch,
    unpack_batch,
)
from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)
from real_time_fraud_detection_system_tpu_torch.features.online import (
    init_feature_state,
    update_and_featurize,
)
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io import coldstore as tcold
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    logreg_loss,
    logreg_predict_proba,
)
from real_time_fraud_detection_system_tpu_torch.ops import cms as tcms
from real_time_fraud_detection_system_tpu_torch.parallel import (
    distributed as tpdist,
)
from real_time_fraud_detection_system_tpu_torch.parallel import mesh as tmesh
from real_time_fraud_detection_system_tpu_torch.parallel import step as tstep
from real_time_fraud_detection_system_tpu_torch.runtime import (
    cms_exchange as txch,
)
from real_time_fraud_detection_system_tpu_torch.runtime import elastic as tel
from real_time_fraud_detection_system_tpu_torch.runtime import sources
from real_time_fraud_detection_system_tpu_torch.runtime.distributed import (
    ProcessTopology,
    bootstrap_distributed,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine import (
    ShardedScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.tools import (
    multihost_launcher,
)
from real_time_fraud_detection_system_tpu_torch.utils import metrics, tree

torch.set_num_threads(1)

CPU = torch.device("cpu")
ATOL_PROB = 1e-6  # logistic probabilities: the dot product in another order
DAY0 = 20100


# -- configs, models, streams -------------------------------------------------


def _cfgs(key_mode="direct", cap=128):
    f = dict(customer_capacity=cap, terminal_capacity=cap,
             cms_width=1 << 10, key_mode=key_mode)
    rt = dict(batch_buckets=(64, 256), max_batch_rows=256)
    return (Config(features=FeatureConfig(**f), runtime=RuntimeConfig(**rt)),
            JConfig(features=JFeatureConfig(**f),
                    runtime=JRuntimeConfig(**rt)))


def _model():
    """(JAX params, JAX scaler, port params, port scaler), seeded."""
    rng = np.random.default_rng(4)
    jp = JLogRegParams(w=jnp.asarray(rng.normal(0, 0.5, 15)
                                     .astype(np.float32)),
                       b=jnp.float32(-0.5))
    js = JScaler(jnp.asarray(rng.normal(2, 1, 15).astype(np.float32)),
                 jnp.asarray(rng.uniform(0.5, 3, 15).astype(np.float32)))
    return (jp, js, weights.from_numpy(jax.tree.map(np.asarray, jp),
                                       device=CPU),
            weights.from_numpy(jax.tree.map(np.asarray, js), device=CPU))


def _cols(cust, term, tx0=0, day=DAY0):
    n = len(cust)
    us = np.full(n, day * 86400_000_000, np.int64) + np.arange(n) * 1000
    return {
        "tx_id": np.arange(tx0, tx0 + n, dtype=np.int64),
        "tx_datetime_us": us,
        "customer_id": np.asarray(cust, np.int64),
        "terminal_id": np.asarray(term, np.int64),
        # whole dollars: day-bucket sums exact in float32
        "tx_amount_cents": ((np.arange(n) % 7 + 1) * 100).astype(np.int64),
        "kafka_ts_ms": us // 1000,
    }


def _stream(n_batches=3, rows=96, n_proc=2, seed=7):
    """Co-partitioned traffic (terminal residues track customer residues
    mod ``n_proc``·2), as the JAX fleet's exactness contract asks."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        cust = rng.integers(0, 100, rows)
        term = rng.integers(0, 30, rows) * 2 * n_proc + cust % (2 * n_proc)
        out.append(_cols(cust, term, tx0=i * rows, day=DAY0 + i))
    return out


def _mine(cols, topo):
    mask = topo.owns(cols["customer_id"])
    return {k: v[mask] for k, v in cols.items()}


def _engines(key_mode, topo=None, n_dev=1, registry=None):
    """A port and a JAX sharded engine of one configuration."""
    tcfg, jcfg = _cfgs(key_mode)
    jp, js, tp, ts = _model()
    jt = None if topo is None else JProcessTopology(
        topo.n_processes, topo.process_id, topo.local_devices)
    t = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=n_dev,
                             device=CPU, topology=topo, metrics=registry)
    j = JShardedScoringEngine(jcfg, kind="logreg", params=jp, scaler=js,
                              n_devices=n_dev, topology=jt)
    return t, j


def _host_jax(state):
    return jax.tree.map(np.asarray, state)


def _assert_leaves_equal(t_state, j_state, what="", stack_of_one=False):
    """Every leaf bit for bit. ``stack_of_one``: a one-shard engine's
    sketches and directories, which the port keeps as a stack of one
    (``[1, ...]``) where the JAX engine's adoption leaves them single."""
    jl = jax.tree_util.tree_leaves_with_path(j_state)
    tl = tree.leaves_with_path(t_state)
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [p for p, _ in tl]
    for (path, t), (_, j) in zip(tl, jl):
        t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
        j = np.asarray(j)
        if stack_of_one and t.shape == (1,) + j.shape:
            t = t[0]
        np.testing.assert_array_equal(t, j, err_msg=f"{what} {path}")


# -- topology geometry and the bootstrap --------------------------------------


@pytest.mark.parametrize("n_proc,pid,local", [(1, 0, 1), (2, 0, 1),
                                              (2, 1, 2), (4, 3, 2),
                                              (3, 1, 4)])
def test_topology_residue_math_matches_jax(n_proc, pid, local):
    rng = np.random.default_rng(n_proc * 10 + pid)
    ids = np.concatenate([rng.integers(0, 1 << 20, 500),
                          rng.integers(1 << 32, 1 << 40, 100)])
    t = ProcessTopology(n_proc, pid, local)
    j = JProcessTopology(n_proc, pid, local)
    np.testing.assert_array_equal(t.owner_process(ids), j.owner_process(ids))
    np.testing.assert_array_equal(t.owns(ids), j.owns(ids))
    assert (t.n_shards_total, t.shard_offset, t.owned_shards) == \
        (j.n_shards_total, j.shard_offset, j.owned_shards)
    assert t.describe() == j.describe()
    for n_part in (n_proc, 8, 13):
        assert t.kafka_partitions(n_part) == j.kafka_partitions(n_part)
    # the residue block composes with the engine's local modulo
    mine = fold_key(ids[t.owns(ids)]).astype(np.int64)
    np.testing.assert_array_equal(
        mine % local, mine % t.n_shards_total - t.shard_offset)


def test_topology_and_config_refusals_match_jax():
    for args in ((0, 0, 1), (2, 2, 1), (2, 0, 0)):
        with pytest.raises(ValueError) as te:
            ProcessTopology(*args)
        with pytest.raises(ValueError) as je:
            JProcessTopology(*args)
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError) as te:
        ProcessTopology(4, 0, 1).kafka_partitions(3)
    with pytest.raises(ValueError) as je:
        JProcessTopology(4, 0, 1).kafka_partitions(3)
    assert str(te.value) == str(je.value)
    for kw in (dict(num_processes=0), dict(num_processes=2, process_id=2),
               dict(init_timeout_s=0)):
        with pytest.raises(ValueError) as te:
            DistributedConfig(**kw)
        with pytest.raises(ValueError) as je:
            JDistributedConfig(**kw)
        assert str(te.value) == str(je.value)
    assert dataclasses.asdict(DistributedConfig()) == \
        dataclasses.asdict(JDistributedConfig())
    assert RuntimeConfig().n_partitions == JRuntimeConfig().n_partitions


def test_bootstrap_resolves_the_id_as_jax_does(monkeypatch):
    """Never a defaulted fleet id: without ``--process-id`` the port reads
    ``RANK`` (the JAX package ``JAX_PROCESS_ID``), and with neither a
    fleet raises; one process without a coordinator returns None; an
    uncoordinated fleet initializes no process group."""
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    dcfg = dict(num_processes=2, process_id=-1)
    with pytest.raises(ValueError, match="process-id"):
        bootstrap_distributed(DistributedConfig(**dcfg), local_devices=1)
    with pytest.raises(ValueError, match="process-id"):
        jbootstrap(JDistributedConfig(**dcfg), local_devices=1)
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    t = bootstrap_distributed(DistributedConfig(**dcfg), local_devices=2)
    j = jbootstrap(JDistributedConfig(**dcfg), local_devices=2)
    assert t.describe() == j.describe() and not t.coordinated
    assert bootstrap_distributed(DistributedConfig(), 1) is None
    assert tpdist.process_count() == 1 and tpdist.process_index() == 0
    assert tpdist.initialize_distributed() is False


# -- the 2-axis mesh ---------------------------------------------------------


def test_hybrid_mesh_matches_jax_and_the_axis_pair_step():
    """``make_hybrid_mesh`` builds the JAX grid over co-located shards;
    the sharded step over the axis pair equals the single-device
    features, as the JAX hybrid step does (``test_distributed.py``)."""
    devs = [CPU] * 8
    m = tpdist.make_hybrid_mesh(n_hosts=2, devices_per_host=4,
                                devices=devs)
    jm = jpdist.make_hybrid_mesh(n_hosts=2, devices_per_host=4)
    assert m.shape == jm.devices.shape == (2, 4)
    assert tpdist.mesh_axes(m) == jpdist.mesh_axes(jm) == ("dcn", "ici")
    assert tpdist.make_hybrid_mesh(devices=devs).shape == \
        jpdist.make_hybrid_mesh().devices.shape
    for kw in (dict(n_hosts=4, devices_per_host=4),
               dict(devices_per_host=16)):
        with pytest.raises(ValueError, match="device"):
            tpdist.make_hybrid_mesh(devices=devs, **kw)
        with pytest.raises(ValueError, match="device"):
            jpdist.make_hybrid_mesh(**kw)
    s = tpdist.process_local_batch_slice(1024, m)
    js = jpdist.process_local_batch_slice(1024, jm)
    assert (s.start, s.stop) == (js.start, js.stop) == (0, 1024)
    with pytest.raises(ValueError, match="axes"):
        tstep.make_sharded_step(_cfgs()[0], logreg_predict_proba, mesh=m,
                                axis="data")

    tcfg, _ = _cfgs(cap=1024)
    rng = np.random.default_rng(1)
    n = 512
    cols = {
        "tx_id": np.arange(n, dtype=np.int64),
        "tx_datetime_us": ((20200 * 86400 + rng.integers(0, 86400, n))
                           * 1_000_000).astype(np.int64),
        "customer_id": rng.integers(0, 300, n).astype(np.int64),
        "terminal_id": rng.integers(0, 600, n).astype(np.int64),
        "tx_amount_cents": rng.integers(1, 500, n).astype(np.int64) * 100,
        "label": (rng.random(n) < 0.1).astype(np.int64),
    }
    ref_state = init_feature_state(tcfg.features, CPU)
    _, ref = update_and_featurize(ref_state, unpack_batch(torch.from_numpy(
        pack_batch(make_batch(
            customer_id=cols["customer_id"],
            terminal_id=cols["terminal_id"],
            tx_datetime_us=cols["tx_datetime_us"],
            amount_cents=cols["tx_amount_cents"],
            label=cols["label"])))), tcfg.features)
    _, _, tp, ts = _model()
    step = tstep.make_sharded_step(
        tcfg, logreg_predict_proba, loss_fn=logreg_loss, online_lr=1e-2,
        mesh=m, axis=tpdist.mesh_axes(m), packed=True)
    (part, _, pos), = tstep.partition_batch_spill(cols, 8, 256)
    packed = pack_batch(make_batch(
        customer_id=part["customer_id"], terminal_id=part["terminal_id"],
        tx_datetime_us=part["tx_datetime_us"],
        amount_cents=part["tx_amount_cents"],
        label=np.where(part["__valid__"], part["label"], -1),
    )._replace(valid=part["__valid__"]))
    w0 = tp.w.clone()
    fs = tmesh.shard_feature_state(init_feature_state(tcfg.features, CPU),
                                   m)
    _, tp2, _, feats = step(fs, tp, ts, torch.from_numpy(packed))
    assert torch.equal(feats[torch.from_numpy(pos)], ref)
    assert not torch.equal(tp2.w, w0) and tp2.w.shape == (15,)


def test_process_mesh_and_collectives_probe_in_one_process():
    assert tmesh.make_process_mesh(2, CPU) == ((0, "cpu"), (0, "cpu"))
    assert tmesh.cross_process_collectives_supported() is None
    assert jmesh.cross_process_collectives_supported(
        jmesh.make_process_mesh()) is None


# -- the fleet's sources -----------------------------------------------------


def _txs(n=600, seed=0, n_cust=64):
    rng = np.random.default_rng(seed)
    t_s = np.sort(rng.integers(0, 86400 * 5, n)).astype(np.int64)
    return dict(
        tx_id=np.arange(n, dtype=np.int64),
        tx_time_seconds=t_s,
        tx_time_days=(t_s // 86400).astype(np.int32),
        customer_id=rng.integers(0, n_cust, n).astype(np.int64),
        terminal_id=rng.integers(0, 64, n).astype(np.int64),
        amount_cents=rng.integers(100, 999, n).astype(np.int64),
        tx_fraud=np.zeros(n, np.int8),
        tx_fraud_scenario=np.zeros(n, np.int8))


def _drain(src):
    out = []
    while (b := src.poll_batch()) is not None:
        out.append(b)
    return out


def _jax_txs(fields):
    from real_time_fraud_detection_system_tpu.data.generator import (
        Transactions as JTransactions,
    )

    return JTransactions(**fields)


@pytest.mark.parametrize("n_proc,pid,local", [(2, 1, 1), (4, 2, 2)])
def test_affine_source_gives_the_jax_rows_and_replays(n_proc, pid, local):
    fields = _txs()
    topo = ProcessTopology(n_proc, pid, local)
    jtopo = JProcessTopology(n_proc, pid, local)
    t = _drain(sources.PartitionAffineSource(
        sources.ReplaySource(Transactions(**fields), 0, batch_rows=128),
        topo))
    j = _drain(jsources.PartitionAffineSource(
        jsources.ReplaySource(_jax_txs(fields), 0, batch_rows=128), jtopo))
    assert len(t) == len(j)
    for a, b in zip(t, j):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert topo.owns(a["customer_id"]).all()
    # the offsets are the inner source's: a seek replays the same slice
    src = sources.PartitionAffineSource(
        sources.ReplaySource(Transactions(**fields), 0, batch_rows=128),
        topo)
    src.poll_batch()
    offs = list(src.offsets)
    second = src.poll_batch()
    src.seek(offs)
    np.testing.assert_array_equal(src.poll_batch()["tx_id"],
                                  second["tx_id"])


def test_floor_source_drops_the_jax_rows():
    fields = _txs(n=900, seed=2)
    floors, old_p, old_l = [300, 640], 2, 1
    t = _drain(sources.OwnershipFloorSource(
        sources.ReplaySource(Transactions(**fields), 0, batch_rows=128),
        floors, old_p, old_l))
    j = _drain(jsources.OwnershipFloorSource(
        jsources.ReplaySource(_jax_txs(fields), 0, batch_rows=128),
        floors, old_p, old_l))
    got = np.concatenate([b["tx_id"] for b in t])
    np.testing.assert_array_equal(got, np.concatenate(
        [b["tx_id"] for b in j]))
    owner = JProcessTopology(2, 0, 1).owner_process(fields["customer_id"])
    keep = np.arange(900) >= np.asarray(floors)[owner]
    np.testing.assert_array_equal(got, fields["tx_id"][keep])
    for bad in (dict(floors=[1], old_processes=2, old_local_devices=1),):
        with pytest.raises(ValueError, match="floors"):
            sources.OwnershipFloorSource(
                sources.ReplaySource(Transactions(**fields), 0), **bad)


# -- the sharded engine as a fleet process ------------------------------------


@pytest.mark.parametrize("key_mode", ["direct", "exact"])
def test_fleet_engines_match_jax_and_the_single_process_engine(key_mode):
    """2 processes × 2 local shards: each process's features, probs,
    state and shard labels equal the JAX fleet engine's, and its rows
    equal the single-process 4-shard engine's bit for bit (the residue
    block IS the global layout)."""
    stream = _stream()
    control, _ = _engines(key_mode, n_dev=4)
    ctrl = {}
    for cols in stream:
        r = control.process_batch(dict(cols))
        ctrl.update(zip(r.tx_id.tolist(), zip(r.probs, r.features)))
    for pid in (0, 1):
        topo = ProcessTopology(2, pid, 2)
        reg = metrics.MetricsRegistry()
        t, j = _engines(key_mode, topo, n_dev=2, registry=reg)
        assert t.state.process_count == 2 and t.state.process_id == pid
        for cols in stream:
            mine = _mine(cols, topo)
            tr, jr = t.process_batch(dict(mine)), j.process_batch(dict(mine))
            np.testing.assert_array_equal(tr.features,
                                          np.asarray(jr.features))
            np.testing.assert_allclose(tr.probs, np.asarray(jr.probs),
                                       atol=ATOL_PROB)
            for tx, p, f in zip(tr.tx_id.tolist(), tr.probs, tr.features):
                assert p == ctrl[tx][0] and np.array_equal(f, ctrl[tx][1])
        _assert_leaves_equal(t.state.feature_state,
                             _host_jax(j.state.feature_state), f"p{pid}")
        labels = [r["labels"] for r in
                  reg.snapshot()["rtfds_shard_rows"]["series"]]
        assert labels == [{"shard": str(2 * pid + s), "process": str(pid)}
                          for s in range(2)]


def test_engine_refuses_an_affinity_breach_as_jax():
    topo = ProcessTopology(2, 0, 1)
    t, j = _engines("direct", topo, n_dev=1)
    good = _cols(cust=np.arange(32) * 2, term=np.arange(32) * 2)
    t.process_batch(dict(good))
    j.process_batch(dict(good))
    bad = _cols(cust=np.arange(32) * 2 + 1, term=np.arange(32) * 2, tx0=99)
    with pytest.raises(ValueError) as te:
        t.process_batch(dict(bad))
    with pytest.raises(ValueError) as je:
        j.process_batch(dict(bad))
    assert "partition-affinity breach" in str(te.value)
    assert str(te.value) == str(je.value)


# -- the fleet's checkpoints --------------------------------------------------


def test_fleet_checkpoints_cross_both_ways(tmp_path):
    """A JAX fleet process's checkpoint (stamps, resize epochs) restores
    into the port's engine of the same topology and the other way round,
    every leaf bit for bit; the next batch then equals the JAX engine's."""
    topo = ProcessTopology(2, 1, 2)
    stream = [_mine(c, topo) for c in _stream()]
    t, j = _engines("exact", topo, n_dev=2)
    for cols in stream[:2]:
        t.process_batch(dict(cols))
        j.process_batch(dict(cols))
    epochs = [{"epoch": 1, "from_processes": 1, "to_processes": 2,
               "old_local_devices": 2, "reason": "grow", "floors": [5],
               "min_offset": 5}]
    for st in (t.state, j.state):
        st.offsets = [7]
        st.resize_epochs = epochs
    jck = jckpt.make_checkpointer(str(tmp_path / "jax"))
    tck = tckpt.make_checkpointer(str(tmp_path / "port"))
    jck.save(j.state)
    tck.save(t.state)
    t2, j2 = _engines("exact", topo, n_dev=2)
    assert tckpt.make_checkpointer(str(tmp_path / "jax")).restore(
        t2.state) is t2.state
    assert jckpt.make_checkpointer(str(tmp_path / "port")).restore(
        j2.state) is not None
    for st in (t2.state, j2.state):
        assert (st.process_count, st.process_id) == (2, 1)
        assert st.resize_epochs == epochs and list(st.offsets) == [7]
    _assert_leaves_equal(t2.state.feature_state,
                         _host_jax(j.state.feature_state), "jax→port")
    _assert_leaves_equal(t.state.feature_state,
                         _host_jax(j2.state.feature_state), "port→jax")
    tr, jr = t2.process_batch(dict(stream[2])), j.process_batch(
        dict(stream[2]))
    np.testing.assert_array_equal(tr.features, np.asarray(jr.features))


@pytest.mark.parametrize("restorer,match", [
    ((2, 1, 1), "its OWN"),
    (None, "merge_process_states"),
    ((4, 0, 1), "process-count"),
    ((2, 0, 2), "merge_process_states"),
], ids=["other-process", "single", "wider-fleet", "wider-process"])
def test_topology_mismatch_is_refused_as_jax(tmp_path, restorer, match):
    """Every refusal of ``tests/test_multihost.py``'s checkpoint test, in
    both packages, never a quarantine."""
    topo = ProcessTopology(2, 0, 1)
    t, j = _engines("direct", topo, n_dev=1)
    cols = _cols(cust=np.arange(16) * 2, term=np.arange(16) * 2)
    t.process_batch(dict(cols))
    t.state.offsets = [1]
    tck = tckpt.make_checkpointer(str(tmp_path))
    path = tck.save(t.state)
    topo2 = None if restorer is None else ProcessTopology(*restorer)
    t2, j2 = _engines("direct", topo2, n_dev=topo2.local_devices
                      if topo2 else 1)
    with pytest.raises(tckpt.CheckpointTopologyError, match=match):
        tck.restore(t2.state)
    with pytest.raises(jckpt.CheckpointTopologyError, match=match):
        jckpt.make_checkpointer(str(tmp_path)).restore(j2.state)
    assert tck.latest() == os.path.basename(path) or os.path.exists(path)
    same, _ = _engines("direct", topo, n_dev=1)
    assert tck.restore(same.state) is not None


def test_single_process_checkpoint_adopts_into_the_fleet(tmp_path):
    """The 1→P leg: a global single-process exact checkpoint restores into
    each fleet process, which keeps its residue block (by directory key,
    as ``adopt_process_slice``) and serves the SAME probabilities as the
    global engine — in the port as in the JAX package."""
    cust = np.arange(48, dtype=np.int64)
    warm = _cols(cust=cust, term=cust)
    probe = _cols(cust=cust, term=cust, tx0=1000, day=DAY0 + 1)
    ctrl, jctrl = _engines("exact", n_dev=2)
    ctrl.process_batch(dict(warm))
    ctrl.state.offsets = [1]
    ck = tckpt.make_checkpointer(str(tmp_path))
    ck.save(ctrl.state)
    ctrl_res = ctrl.process_batch(dict(probe))
    for pid in (0, 1):
        topo = ProcessTopology(2, pid, 1)
        t, j = _engines("exact", topo, n_dev=1)
        assert ck.restore(t.state) is not None
        assert jckpt.make_checkpointer(str(tmp_path)).restore(
            j.state) is not None
        assert t.state.process_count == j.state.process_count == 1
        t._ensure_layout()
        j._ensure_layout()
        assert (t.state.process_count, t.state.process_id) == (2, pid)
        _assert_leaves_equal(t.state.feature_state,
                             _host_jax(j.state.feature_state), f"p{pid}",
                             stack_of_one=True)
        mask = topo.owns(probe["customer_id"])
        res = t.process_batch({k: v[mask] for k, v in probe.items()})
        np.testing.assert_array_equal(res.probs, ctrl_res.probs[mask])


# -- adopt and merge ----------------------------------------------------------


def _fleet_states(key_mode, n_proc=2, local=1):
    """Each process's host state after a co-partitioned stream, port and
    JAX."""
    stream = _stream(n_proc=n_proc)
    t_states, j_states = [], []
    for pid in range(n_proc):
        topo = ProcessTopology(n_proc, pid, local)
        t, j = _engines(key_mode, topo, n_dev=local)
        for cols in stream:
            mine = _mine(cols, topo)
            t.process_batch(dict(mine))
            j.process_batch(dict(mine))
        t_states.append(tree.map(lambda x: x.numpy(), t.state.feature_state))
        j_states.append(_host_jax(j.state.feature_state))
    return t_states, j_states


@pytest.mark.parametrize("key_mode,local", [("direct", 1), ("exact", 1),
                                            ("exact", 2)])
def test_merge_process_states_matches_jax(key_mode, local):
    tcfg, jcfg = _cfgs(key_mode)
    t_states, j_states = _fleet_states(key_mode, local=local)
    tm = tmesh.merge_process_states(t_states, tcfg, [local] * 2)
    jm = jmesh.merge_process_states(j_states, jcfg, [local] * 2)
    _assert_leaves_equal(tree.map(np.asarray, tm), jm, "merged")
    # and the merge re-sliced per process equals the JAX adoption
    for pid in (0, 1):
        topo = ProcessTopology(2, pid, local)
        ta = tmesh.adopt_process_slice(tm, tcfg, 1, topo)
        ja = jmesh.adopt_process_slice(jm, jcfg, 1, JProcessTopology(
            2, pid, local))
        _assert_leaves_equal(tree.map(np.asarray, ta), ja, f"adopt {pid}")


def test_merge_refusals_match_jax():
    tcfg, jcfg = _cfgs("exact")
    t_states, j_states = _fleet_states("exact")
    for tst, jst, tc, jc in (
            (t_states[:1] * 2, j_states[:1] * 2, tcfg, jcfg),
            (t_states, j_states, _cfgs("hash")[0], _cfgs("hash")[1]),
            (t_states, j_states, tcfg, jcfg)):
        n_loc = [1] * len(tst) if tst is not t_states else [1]
        with pytest.raises(ValueError) as te:
            tmesh.merge_process_states(tst, tc, n_loc)
        with pytest.raises(ValueError) as je:
            jmesh.merge_process_states(jst, jc, n_loc)
        assert str(te.value) == str(je.value)
    d_t, d_j = _fleet_states("direct")
    with pytest.raises(ValueError) as te:
        tmesh.merge_process_states(d_t, _cfgs()[0], [1, 2])
    with pytest.raises(ValueError) as je:
        jmesh.merge_process_states(d_j, _cfgs()[1], [1, 2])
    assert str(te.value) == str(je.value)


# -- the terminal-sketch exchange ---------------------------------------------

DEPTH, WIDTH, ND = 2, 64, 8


def _sketch_pair(rows, sel, stacked=False):
    """The same sketch in both packages, built by the JAX ``cms_update``
    (whole amounts: every sum exact)."""
    sk = jcms.cms_init(DEPTH, WIDTH, n_days=ND, track_fraud=True)
    sk = jcms.cms_update(
        sk, jnp.asarray(rows["term"][sel]), jnp.asarray(rows["amount"][sel]),
        jnp.asarray(rows["day"][sel]), jnp.ones(int(sel.sum()), dtype=bool),
        fraud=jnp.asarray(rows["fraud"][sel]))
    host = [np.asarray(a) for a in sk]
    if stacked:
        host = [np.stack([a, np.zeros_like(a) if i else a])
                for i, a in enumerate(host)]
    return (jcms.CountMinSketch(*host),
            tcms.CountMinSketch(*[torch.from_numpy(a.copy()) for a in host]))


def _rows(seed, n):
    r = np.random.default_rng(seed)
    return {"term": r.integers(0, 50, n).astype(np.uint32),
            "amount": (r.integers(1, 500, n) * 1.0).astype(np.float32),
            "day": r.integers(0, 3, n).astype(np.int32),
            "fraud": (r.random(n) < 0.1).astype(np.float32)}


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("stacked", [False, True], ids=["single", "stacked"])
def test_sketch_exchange_matches_jax_and_reads_its_partials(tmp_path,
                                                            stacked):
    """Two rounds of a 2-process exchange, port and JAX in directories of
    their own: the same published partials (npz, key for key), the same
    merged view, install and checkpoint form; then a mixed fleet — the
    port's process 0 and the JAX package's process 1 in ONE directory —
    merges the same view as either alone."""
    rows = _rows(5, 300)
    sel = np.arange(300) % 2 == 0
    out = {}
    for pkg, xmod, cms_of in (("port", txch, 1), ("jax", jxch, 0)):
        root = str(tmp_path / pkg)
        x0 = xmod.SketchExchange(root, 0, 2, timeout_s=0.0)
        x1 = xmod.SketchExchange(root, 1, 2, timeout_s=0.0)
        own = _sketch_pair(rows, sel, stacked)[cms_of]
        peer = _sketch_pair(rows, ~sel)[cms_of]
        assert x1.exchange(peer) is None
        merged = x0.exchange(own)
        installed = xmod.install_logical(own, merged)
        again = x0.exchange(installed)
        out[pkg] = (merged, installed, again, x0.checkpoint_cms(installed),
                    _npz(os.path.join(root, "cms-p00.npz")),
                    _npz(os.path.join(root, "cms-p01.npz")))
    for a, b in zip(out["port"], out["jax"]):
        if isinstance(a, dict):
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            continue
        for x, y in zip(a, b):
            if x is None:
                assert y is None
                continue
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    mixed = str(tmp_path / "mixed")
    jxch.SketchExchange(mixed, 1, 2, timeout_s=0.0).exchange(
        _sketch_pair(rows, ~sel)[0])
    got = txch.SketchExchange(mixed, 0, 2, timeout_s=0.0).exchange(
        _sketch_pair(rows, sel, stacked)[1])
    for x, y in zip(got, out["jax"][0]):
        np.testing.assert_array_equal(x, np.asarray(y))


def test_engine_exchanges_at_checkpoints_and_saves_locals_only(tmp_path):
    """Two fleet engines with an exchange: after a checkpoint round each
    serves the merged terminal sketch, and what it saves is its locals
    only, so the P→1 merge of the saved states equals the merge of
    engines that never exchanged."""
    tcfg, _ = _cfgs("exact")
    _, _, tp, ts = _model()
    stream = _stream()
    saved, plain = [], []
    for pid in (0, 1):
        topo = ProcessTopology(2, pid, 1)
        for xch, keep in ((True, saved), (False, plain)):
            eng = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=1,
                                       device=CPU, topology=topo)
            if xch:
                eng.cms_exchange = txch.SketchExchange(
                    str(tmp_path / "xch"), pid, 2, timeout_s=0.0)
            for cols in stream:
                eng.process_batch(dict(_mine(cols, topo)))
            eng._maybe_exchange_cms()
            keep.append(tree.map(lambda x: np.asarray(x.numpy()
                                 if isinstance(x, torch.Tensor) else x),
                                 eng.checkpoint_state().feature_state))
    a = tmesh.merge_process_states(saved, tcfg, [1, 1])
    b = tmesh.merge_process_states(plain, tcfg, [1, 1])
    for x, y in zip(tree.leaves(a), tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


# -- the cold store across a resize -------------------------------------------


def _fill_cold(mod, path, keys, seed):
    rng = np.random.default_rng(seed)
    st = mod.ColdStore(path, segment_mb=0.01)
    n = len(keys)
    st.append("terminal", np.asarray(keys, np.uint32),
              rng.integers(0, 40, (n, 40)).astype(np.int32),
              rng.integers(0, 5, (n, 40)).astype(np.float32),
              (rng.integers(0, 9, (n, 40)) * 100).astype(np.float32),
              rng.integers(0, 2, (n, 40)).astype(np.float32))
    st.flush()
    return st


def test_rehome_and_consolidate_match_jax(tmp_path):
    """``consolidate_cold_stores`` of two per-process stores (written by
    either package) gives the JAX store's keys and rows; ``rehome`` to a
    process's residue block drops the JAX count and keeps the same
    keys."""
    srcs = []
    for i, mod in enumerate((tcold, jcold)):
        path = str(tmp_path / f"src{i}")
        _fill_cold(mod, path, np.arange(i, 60, 2), seed=i)
        srcs.append(path)
    t = tcold.consolidate_cold_stores(srcs, str(tmp_path / "t"),
                                      segment_mb=0.01)
    j = jcold.consolidate_cold_stores(srcs, str(tmp_path / "j"),
                                      segment_mb=0.01)
    keys = t.index_snapshot("terminal")
    np.testing.assert_array_equal(keys, j.index_snapshot("terminal"))
    tr, jr = t.get_rows("terminal", keys), j.get_rows("terminal", keys)
    for k in keys.tolist():
        for a, b in zip(tr[k], jr[k]):
            np.testing.assert_array_equal(a, b)
    topo = ProcessTopology(3, 1, 1)
    owned = lambda _t, ks: topo.owns(ks)  # noqa: E731
    assert t.rehome(owned) == j.rehome(owned) > 0
    np.testing.assert_array_equal(t.index_snapshot("terminal"),
                                  j.index_snapshot("terminal"))
    with pytest.raises(ValueError, match="also a source"):
        tcold.consolidate_cold_stores([srcs[0]], srcs[0])


# -- the aggregated view and the launcher's plumbing ---------------------------


def test_merge_process_snapshots_renders_as_jax():
    snaps = {
        "0": {"rtfds_rows_total": {
            "type": "counter", "help": "rows",
            "series": [{"labels": {}, "value": 5.0}]}},
        "1": {"rtfds_rows_total": {
            "type": "counter", "help": "rows",
            "series": [{"labels": {}, "value": 7.0}]},
            "rtfds_shard_rows": {
                "type": "gauge", "help": "per shard",
                "series": [{"labels": {"shard": "3", "process": "1"},
                            "value": 2.0}]}},
    }
    t = metrics.merge_process_snapshots(snaps)
    assert t == jmetrics.merge_process_snapshots(snaps)
    assert metrics.render_snapshot_prometheus(t) == \
        jmetrics.render_snapshot_prometheus(t)
    assert t["rtfds_shard_rows"]["series"][0]["labels"] == {
        "shard": "3", "process": "1"}


def test_launcher_builds_port_workers_and_serves_the_cluster_view(tmp_path):
    args = type("A", (), {
        "processes": 2, "local_devices": 2, "workdir": str(tmp_path),
        "worker_metrics_base": 9100})()
    workers = multihost_launcher.build_workers(
        args, ["score", "--out", "o/{proc}/{gen}", "--devices", "2"],
        "127.0.0.1:5555", gen=3)
    for pid, w in enumerate(workers):
        assert w.cmd[1:3] == ["-m",
                              "real_time_fraud_detection_system_tpu_torch.cli"]
        assert w.cmd[w.cmd.index("--process-id") + 1] == str(pid)
        assert w.cmd[w.cmd.index("--coordinator") + 1] == "127.0.0.1:5555"
        assert f"o/{pid:02d}/gen-003" in w.cmd
        assert w.cmd[w.cmd.index("--metrics-port") + 1] == str(9100 + pid)
        assert w.log_path.endswith(f"gen-003-proc-{pid:02d}.log")
    reg = metrics.get_registry()
    reg.counter("rtfds_xla_recompiles_total", "t").inc(0)
    srv = metrics.MetricsServer(port=0)
    srv.start()
    try:
        agg = multihost_launcher._ClusterMetricsServer(
            0, {0: srv.port, 1: srv.port},
            lambda: {"processes": 2, "workers": []})
        agg.start()
        try:
            base = f"http://127.0.0.1:{agg.port}"
            with urllib.request.urlopen(base + "/metrics.json",
                                        timeout=5) as r:
                merged = json.loads(r.read().decode())
            series = merged["rtfds_xla_recompiles_total"]["series"]
            assert {s["labels"]["process"] for s in series} == {"0", "1"}
            with urllib.request.urlopen(base + "/cluster", timeout=5) as r:
                assert json.loads(r.read().decode())["processes"] == 2
        finally:
            agg.stop()
    finally:
        srv.stop()


# -- the elastic policy plane -------------------------------------------------


_SIGNALS = [  # (seconds, worst rung, lag trend, shed pending, alive)
    (0.0, 2, 10.0, 0.0, 1), (0.5, 3, 5.0, 0.0, 1), (1.1, 2, 0.0, 0.0, 1),
    (1.3, 1, 0.0, 0.0, 1), (1.5, 2, 0.0, 0.0, 1), (3.0, 2, 0.0, 0.0, 1),
    (3.2, 0, -5.0, 0.0, 2), (4.0, 0, 0.0, 0.0, 2), (9.0, 0, 0.0, 10.0, 2),
    (10.0, 0, 0.0, 0.0, 1), (12.0, 0, 0.0, 0.0, 2), (25.0, 0, 0.0, 0.0, 2),
    (40.0, 0, 0.0, 0.0, 2), (41.0, 3, 0.0, 0.0, 2), (44.0, 3, 0.0, 0.0, 2),
]


@pytest.mark.parametrize("cfg", [
    dict(),
    dict(min_processes=1, max_processes=2, grow_rung=2, grow_dwell_s=1.0,
         shrink_dwell_s=1.5, cooldown_s=2.0),
    dict(max_processes=8, grow_rung=3, grow_dwell_s=0.0, cooldown_s=0.0),
], ids=["defaults", "smoke", "eager"])
def test_elastic_policy_decides_as_jax(cfg):
    t = tel.ElasticPolicy(tel.ElasticConfig(**cfg))
    j = jel.ElasticPolicy(jel.ElasticConfig(**cfg))
    n = 1
    for now, rung, trend, shed, alive in _SIGNALS:
        kw = dict(worst_rung=rung, lag_trend_rows_per_s=trend,
                  shed_pending_rows=shed, alive=alive)
        a = t.observe(tel.ClusterSignals(**kw), n, now)
        b = j.observe(jel.ClusterSignals(**kw), n, now)
        assert (a is None) == (b is None), now
        if a is not None:
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
            n = a.target
            t.note_resized(now)
            j.note_resized(now)


def test_elastic_fsm_config_manifest_and_signals_match_jax(tmp_path):
    for kw in (dict(min_processes=0), dict(max_processes=0),
               dict(grow_rung=4), dict(cooldown_s=-1)):
        with pytest.raises(ValueError) as te:
            tel.ElasticConfig(**kw)
        with pytest.raises(ValueError) as je:
            jel.ElasticConfig(**kw)
        assert str(te.value) == str(je.value)
    walks = [["draining", "retopologizing", "committing", "relaunching",
              "steady"],
             ["draining", "rolling_back", "steady"],
             ["retopologizing"], ["draining", "committing"],
             ["draining", "retopologizing", "rolling_back", "steady",
              "rolling_back"]]
    for walk in walks:
        logs = {"t": [], "j": []}
        fsms = {"t": tel.ResizeFsm(journal=logs["t"].append),
                "j": jel.ResizeFsm(journal=logs["j"].append)}
        errs = {}
        for k, fsm in fsms.items():
            try:
                for ph in walk:
                    if ph == "rolling_back":
                        fsm.rollback(stage=ph)
                    else:
                        fsm.to(ph, step=ph)
            except RuntimeError as e:
                errs[k] = str(e)
        assert logs["t"] == logs["j"] and errs.get("t") == errs.get("j")
        assert fsms["t"].phase == fsms["j"].phase
        assert fsms["t"].mid_resize == fsms["j"].mid_resize
    man = {"generation": 1, "processes": 2, "local_devices": 1,
           "checkpoint_root": "ck/gen-001", "reason": "grow"}
    path = str(tmp_path / "topology.json")
    tel.store_topology(path, man)
    assert jel.load_topology(path) == man
    jel.store_topology(path, dict(man, generation=2))
    assert tel.load_topology(path)["generation"] == 2
    with open(path, "w") as f:
        f.write('{"generation": 3, "pro')
    assert tel.load_topology(path) is None
    assert [p for p in os.listdir(tmp_path) if ".torn-" in p]
    snaps = {"0": {"rtfds_overload_rung": {"series": [{"value": 2.0}]},
                   "rtfds_shed_pending_rows": {"series": [{"value": 4.0}]}},
             "1": {"rtfds_overload_pressure": {"series": [{"value": 0.7}]},
                   "rtfds_source_lag_trend_rows_per_s": {
                       "series": [{"value": 3.0}, {"value": None}]},
                   "rtfds_shed_pending_rows": {"series": [{"value": 1.0}]}}}
    assert dataclasses.asdict(tel.signals_from_snapshots(snaps)) == \
        dataclasses.asdict(jel.signals_from_snapshots(snaps))
    reg = metrics.MetricsRegistry()
    fm = tel.fleet_metrics(reg)
    fm.fleet_size.set(2)
    fm.resizes_total("grow", "completed").inc()
    jreg = jmetrics.MetricsRegistry()
    jfm = jel.fleet_metrics(jreg)
    jfm.fleet_size.set(2)
    jfm.resizes_total("grow", "completed").inc()
    assert sorted(reg.snapshot()) == sorted(jreg.snapshot())


# -- the fleet's /healthz, the cold tier's re-home, the score flags ------------


def test_healthz_reads_the_fleet_shards_by_global_id():
    """A fleet process's per-shard tier and occupancy fields, keyed by
    global shard id, equal the JAX fleet engine's."""
    topo = ProcessTopology(2, 1, 2)
    treg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    tcfg, jcfg = _cfgs("exact", cap=64)
    jp, js, tp, ts = _model()
    t = ShardedScoringEngine(tcfg, "logreg", tp, ts, n_devices=2, device=CPU,
                             topology=topo, metrics=treg)
    j = JShardedScoringEngine(jcfg, "logreg", jp, js, n_devices=2,
                              topology=JProcessTopology(2, 1, 2),
                              metrics=jreg)
    rng = np.random.default_rng(2)
    for i in range(2):
        cust = rng.integers(0, 4000, 200) * 4 + 2 + rng.integers(0, 2, 200)
        cols = _cols(cust, cust, tx0=200 * i, day=DAY0 + i)
        t.process_batch(dict(cols))
        j.process_batch(dict(cols))
    t._record_compaction(torch.zeros((2, 2), dtype=torch.int32))
    j._record_compaction(j.state.feature_state, np.zeros((2, 2), np.int32))
    t_fs = metrics.MetricsServer(registry=treg).health()[1]["feature_state"]
    j_fs = jmetrics.MetricsServer(registry=jreg).health()[1]["feature_state"]
    assert sorted(t_fs["slots_occupied_per_shard"]) == ["2", "3"]
    for key in ("slots_occupied", "slots_occupied_per_shard", "worst_shard",
                "tier_rows", "tier_rows_per_shard", "dense_hit_rate"):
        assert t_fs[key] == j_fs[key], key


def test_restore_rehomes_the_cold_tier_to_the_residue_block(tmp_path):
    """A fleet process adopting a cold lineage that holds every key keeps
    only its residue block's, as the JAX engine's restore does."""
    path = str(tmp_path / "cold")
    st = tcold.ColdStore(path, segment_mb=0.01)
    rng = np.random.default_rng(8)
    for table in ("customer", "terminal"):
        keys = np.arange(60, dtype=np.uint32)
        st.append(table, keys,
                  rng.integers(0, 40, (60, 40)).astype(np.int32),
                  np.ones((60, 40), np.float32),
                  np.full((60, 40), 100.0, np.float32),
                  np.zeros((60, 40), np.float32))
    st.flush()
    lineage = st.lineage()
    topo = ProcessTopology(3, 1, 1)
    kept = {}
    for pkg in ("port", "jax"):
        tcfg, jcfg = _cfgs("exact")
        c = (tcfg if pkg == "port" else jcfg)
        c = c.replace(features=dataclasses.replace(
            c.features, compact_every=2, cold_store=path))
        jp, js, tp, ts = _model()
        if pkg == "port":
            eng = ShardedScoringEngine(c, "logreg", tp, ts, n_devices=1,
                                       device=CPU, topology=topo)
        else:
            eng = JShardedScoringEngine(c, kind="logreg", params=jp,
                                        scaler=js, n_devices=1,
                                        topology=JProcessTopology(3, 1, 1))
        eng.state.cold_lineage = lineage
        eng._sync_cold_after_restore()
        kept[pkg] = {tb: eng._cold.index_snapshot(tb)
                     for tb in ("customer", "terminal")}
        eng._promoter.close()
    for tb in ("customer", "terminal"):
        np.testing.assert_array_equal(kept["port"][tb], kept["jax"][tb])
        assert topo.owns(kept["port"][tb]).all()
        assert len(kept["port"][tb]) == int(topo.owns(np.arange(60)).sum())


@pytest.fixture(scope="module")
def score_files(tmp_path_factory):
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
        save_model,
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        init_logreg,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )

    d = tmp_path_factory.mktemp("fleet_score")
    fields = _txs(n=2000, seed=6)
    save_transactions(str(d / "txs.npz"), Transactions(**fields))
    save_model(str(d / "m.npz"), TrainedModel(
        "logreg", Scaler(torch.zeros(15), torch.ones(15)),
        init_logreg(15)))
    return d


@pytest.mark.parametrize("flags", [
    ["--num-processes", "2"],
    ["--num-processes", "2", "--process-id", "2"],
    ["--num-processes", "2", "--process-id", "0", "--nan-guard",
     "--dead-letter", "DLQ"],
    ["--resume-merge", "x"],
    ["--resume-merge", "OLD:2:1:r"],
    ["--resume-merge", "OLD:2:1:r", "--checkpoint-dir", "CK"],
    ["--resume-merge", "OLD:2:1:r", "--checkpoint-dir", "CK", "--resume",
     "--resume-merge-cold", "c"],
    ["--resume-merge", "OLD:2:1:r", "--checkpoint-dir", "CK", "--resume"],
], ids=["no-id", "id-out-of-range", "nan-guard", "merge-spec", "merge-no-dir",
        "merge-no-resume", "merge-cold-no-store", "merge-nothing-drained"])
def test_score_fleet_flags_exit_as_the_jax_score(score_files, tmp_path,
                                                 monkeypatch, capsys, flags):
    """The fleet's flags are refused where the JAX ``score`` refuses them,
    with its exit code 2 and nothing on stdout."""
    from real_time_fraud_detection_system_tpu.cli import main as jmain
    from real_time_fraud_detection_system_tpu_torch import cli as tcli

    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.delenv("JAX_PROCESS_ID", raising=False)
    subs = {"DLQ": str(tmp_path / "dlq.jsonl"), "CK": str(tmp_path / "ck"),
            "OLD:2:1:r": f"{tmp_path / 'old'}:2:1:r"}
    flags = [subs.get(f, f) for f in flags]
    common = ["score", "--data", str(score_files / "txs.npz"),
              "--model-file", str(score_files / "m.npz"), *flags]
    assert jmain(common) == 2
    capsys.readouterr()
    assert tcli.main([*common, "--device", "cpu"]) == 2
    assert capsys.readouterr().out == ""
