"""Port parity: tensor, expert and pipeline parallelism
(``parallel/tensor_parallel.py``, ``expert_parallel.py``,
``pipeline_parallel.py``) against the JAX package — the cases of
``tests/test_tensor_pipeline.py`` on 8 shards (the JAX side on the 8
virtual devices of ``tests/conftest.py``) and the two-process
tensor-parallel step of ``tests/test_multiprocess.py`` over gloo.

The weights are the JAX package's ``init_mlp``, ``init_transformer``,
``init_moe`` and ``init_stack`` carried over by ``weights.from_numpy``;
the inputs are numpy from a seed.

Tolerances, and why they hold:

- the TP MLP's probabilities and an lr=1 step's recovered gradients
  within ``1e-6``, as the JAX test: the row-parallel sum re-associates
  one float32 sum, and the two libraries' products differ in the last
  bits; the loss within ``1e-6``;
- the TP transformer's logits and gradients within ``2e-5`` (the JAX
  test's): two blocks of layer norms and attention in two libraries;
- expert parallelism within ``1e-5`` forward and ``rtol=1e-4, atol=1e-5``
  backward (the JAX test's): the same expert products over bucketed
  buffers;
- the pipeline equals the port's sequential stack BIT FOR BIT, as the JAX
  pipeline equals its own (each stage applies the same block to the same
  rows, one microbatch at a time), and the JAX stack within ``1e-6`` of
  the output's largest magnitude: eight residual blocks grow the
  activations to a few hundred, and torch's products differ from XLA's
  in the last bits at that scale; its gradients within ``rtol=1e-4,
  atol=1e-4`` (the JAX test's);
- the two-process step's loss and recovered gradients within ``1e-6`` of
  the full-batch JAX reference: the sum crosses processes as a gloo
  ``all_reduce`` of two float32 partials.
"""

import os
import socket
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from real_time_fraud_detection_system_tpu.models import mlp as jmlp
from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu.parallel import (
    expert_parallel as jep,
)
from real_time_fraud_detection_system_tpu.parallel import (
    pipeline_parallel as jpp,
)
from real_time_fraud_detection_system_tpu.parallel import (
    tensor_parallel as jtp,
)
from real_time_fraud_detection_system_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.models import mlp as tmlp
from real_time_fraud_detection_system_tpu_torch.models import sequence as tseq
from real_time_fraud_detection_system_tpu_torch.parallel import (
    expert_parallel as tep,
)
from real_time_fraud_detection_system_tpu_torch.parallel import (
    pipeline_parallel as tpp,
)
from real_time_fraud_detection_system_tpu_torch.parallel import (
    tensor_parallel as ttp,
)
from real_time_fraud_detection_system_tpu_torch.parallel.distributed import (
    SpanningMesh,
    make_hybrid_mesh,
)
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    make_mesh,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL_TP = 1e-6
ATOL_TF = 2e-5
ATOL_EP = 1e-5


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8)


def _jmesh2():
    return jax.sharding.Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4),
                             ("dp", "tp"))


def _mesh2():
    return make_hybrid_mesh(2, 4, dcn_axis="dp", ici_axis="tp",
                            devices=["cpu"] * 8)


def _port(jtree):
    return weights.from_numpy(jax.tree.map(np.asarray, jtree), device="cpu")


def _np(t):
    return t.detach().numpy()


def _ref_mlp_grads(params, x, y):
    """The JAX test's full-batch reference: loss and gradients."""
    def ref_loss(p):
        per = optax.sigmoid_binary_cross_entropy(
            jmlp.mlp_logits(p, x), y.astype(jnp.float32))
        return per.mean()

    return jax.value_and_grad(ref_loss)(params)


def _assert_recovered(params, new, ref_g, atol, what=""):
    """lr=1: old - new is the gradient, on every leaf."""
    for i, (a, b, g) in enumerate(zip(jax.tree.leaves(params),
                                      tree.leaves(new),
                                      jax.tree.leaves(ref_g))):
        np.testing.assert_allclose(np.asarray(a) - _np(b), np.asarray(g),
                                   atol=atol, err_msg=f"{what} leaf {i}")


# -- tensor parallelism: the MLP -------------------------------------------

def test_tp_forward_matches_unsharded(mesh):
    params = jmlp.init_mlp(15, hidden=(64, 32), seed=3)
    x = np.random.default_rng(0).normal(0, 1, (256, 15)).astype(np.float32)
    ref = np.asarray(jmlp.mlp_predict_proba(params, jnp.asarray(x)))
    sharded, predict = ttp.make_tp_mlp(mesh, _port(params))
    tp = _np(predict(sharded, torch.from_numpy(x)))
    np.testing.assert_allclose(tp, ref, atol=ATOL_TP)
    np.testing.assert_allclose(
        tp, _np(tmlp.mlp_predict_proba(_port(params), torch.from_numpy(x))),
        atol=ATOL_TP)


def test_tp_rejects_bad_shapes(mesh, jmesh):
    for hidden, match in (((64,), "hidden layers"), ((30, 16), "divisible")):
        jp = jmlp.init_mlp(15, hidden=hidden)
        with pytest.raises(ValueError, match=match) as t:
            ttp.make_tp_mlp(mesh, _port(jp))
        with pytest.raises(ValueError) as j:
            jtp.make_tp_mlp(jmesh, jp)
        assert str(t.value) == str(j.value)


def test_tp_grads_match_unsharded(mesh):
    """One lr=1 step recovers the gradient: it equals the single-device
    gradient on every layer (an inflated sharded-layer gradient, the
    psum-transpose fault, would still descend)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (128, 15)).astype(np.float32)
    y = (rng.random(128) < 0.3).astype(np.int32)
    params = jmlp.init_mlp(15, hidden=(32, 16), seed=7)
    ref_l, ref_g = _ref_mlp_grads(params, jnp.asarray(x), jnp.asarray(y))
    sharded, step = ttp.make_tp_step(mesh, _port(params), lr=1.0)
    new, loss = step(sharded, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(loss) - float(ref_l)) < 1e-6
    _assert_recovered(params, new, ref_g, ATOL_TP)


def test_tp_training_step_learns(mesh):
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (512, 15)).astype(np.float32)
    y = (x[:, 0] - x[:, 2] > 0.5).astype(np.int32)
    params = _port(jmlp.init_mlp(15, hidden=(64, 32), seed=0))
    sharded, step = ttp.make_tp_step(mesh, params, lr=0.1)
    losses = []
    for _ in range(30):
        sharded, loss = step(sharded, torch.from_numpy(x),
                             torch.from_numpy(y))
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.7
    # the params keep their global form and the TP layout's split
    assert [tuple(w.shape) for w, _ in sharded] == [
        tuple(w.shape) for w, _ in params]
    assert ttp.tp_specs(sharded) == [(1, 0), (0, None), (None, None)]


def test_dp_tp_step_matches_full_batch_sgd():
    """The 2D (dp=2, tp=4) step equals full-batch SGD: equal-size dp
    groups make the mean of group means the full-batch mean."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (128, 15)).astype(np.float32)
    y = (rng.random(128) < 0.3).astype(np.int32)
    params = jmlp.init_mlp(15, hidden=(32, 16), seed=7)
    ref_l, ref_g = _ref_mlp_grads(params, jnp.asarray(x), jnp.asarray(y))
    sharded, step = ttp.make_dp_tp_step(_mesh2(), _port(params), lr=1.0)
    new, loss = step(sharded, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(float(loss) - float(ref_l)) < 1e-6
    _assert_recovered(params, new, ref_g, ATOL_TP)
    jsh, jstep = jtp.make_dp_tp_step(_jmesh2(), params, lr=1.0)
    jnew, _ = jstep(jsh, jnp.asarray(x), jnp.asarray(y))
    for a, b in zip(tree.leaves(new), jax.tree.leaves(jnew)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL_TP)


# -- tensor parallelism: the transformer ----------------------------------

def test_tp_transformer_matches_unsharded(mesh, jmesh):
    """Head-sharded attention and two sums per block equal the
    single-device forward, the port's and the JAX one."""
    params = jseq.init_transformer(d_model=32, n_heads=8, n_layers=2,
                                   d_ff=64, seed=1)
    x = np.random.default_rng(6).normal(0, 1, (4, 16, 8)).astype(
        np.float32)
    ref = np.asarray(jseq.transformer_logits(params, jnp.asarray(x)))
    sharded, logits = ttp.make_tp_transformer(mesh, _port(params))
    tp = _np(logits(sharded, torch.from_numpy(x)))
    np.testing.assert_allclose(tp, ref, atol=ATOL_TF)
    np.testing.assert_allclose(
        tp, _np(tseq.transformer_logits(_port(params), torch.from_numpy(x))),
        atol=ATOL_TF)
    bad = jseq.init_transformer(d_model=32, n_heads=2, n_layers=1)
    with pytest.raises(ValueError, match="divide") as t:
        ttp.make_tp_transformer(mesh, _port(bad))
    with pytest.raises(ValueError) as j:
        jtp.make_tp_transformer(jmesh, bad)
    assert str(t.value) == str(j.value)


@pytest.mark.parametrize("two_d", [False, True], ids=["tp", "dp-tp"])
def test_tp_transformer_step_matches_full_batch(mesh, two_d):
    """An lr=1 TP (and dp × tp) transformer step recovers the full-batch
    gradient on every leaf, with an uneven mask so the dp combination's
    weighting by mask mass is exercised."""
    rng = np.random.default_rng(8)
    params = jseq.init_transformer(d_model=16, n_heads=8, n_layers=1,
                                   d_ff=32, seed=2)
    x = rng.normal(0, 1, (8, 12, 8)).astype(np.float32)
    y = (rng.random((8, 12)) < 0.2).astype(np.int32)
    mask = (np.arange(12)[None, :] < rng.integers(3, 13, (8, 1))).astype(
        np.float32)
    ref_l, ref_g = jax.value_and_grad(lambda p: jseq.transformer_loss(
        p, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask),
        pos_weight=3.0))(params)
    kw = dict(axis="tp", dp_axis="dp") if two_d else {}
    sharded, step = ttp.make_tp_transformer_step(
        _mesh2() if two_d else mesh, _port(params), lr=1.0, pos_weight=3.0,
        **kw)
    new, loss = step(sharded, *map(torch.from_numpy, (x, y, mask)))
    assert abs(float(loss) - float(ref_l)) < 1e-6
    _assert_recovered(params, new, ref_g, ATOL_TF)
    bad = jseq.init_transformer(d_model=16, n_heads=6, n_layers=1, d_ff=32)
    with pytest.raises(ValueError, match="divide"):
        ttp.make_tp_transformer_step(mesh, _port(bad))


# -- pipeline parallelism ---------------------------------------------------

def test_pipeline_matches_sequential(mesh):
    width, n_dev, n_micro = 16, 8, 4
    jp = jpp.init_stack(width, n_stages=n_dev, seed=2)
    params = _port(jp)
    x = np.random.default_rng(3).normal(0, 1, (64, width)).astype(
        np.float32)
    ref = _np(tpp.stack_apply(params, torch.from_numpy(x)))
    sharded, run = tpp.make_pipeline(mesh, params, n_micro=n_micro)
    out = _np(run(sharded, torch.from_numpy(x)))
    # the same per-microbatch compute in the same order: bit-identical
    np.testing.assert_array_equal(out, ref)
    jref = np.asarray(jpp.stack_apply(jp, jnp.asarray(x)))
    np.testing.assert_allclose(out, jref, rtol=0,
                               atol=1e-6 * np.abs(jref).max())


def test_pipeline_backward_matches_sequential(mesh):
    """GPipe training by plain autograd: the gradients through the
    pipeline equal the sequential stack's, and the JAX ones."""
    width, n_dev = 8, 8
    jp = jpp.init_stack(width, n_stages=n_dev, seed=5)
    x = np.random.default_rng(6).normal(0, 1, (16, width)).astype(
        np.float32)
    sharded, run = tpp.make_pipeline(mesh, _port(jp), n_micro=2)

    def grads(fn):
        p = tpp.StackParams(*[t.clone().requires_grad_() for t in sharded])
        (fn(p, torch.from_numpy(x)) ** 2).mean().backward()
        return [t.grad.numpy() for t in p]

    g_pipe = grads(run)
    g_seq = grads(tpp.stack_apply)
    g_jax = jax.grad(lambda p: (jpp.stack_apply(p, jnp.asarray(x)) ** 2)
                     .mean())(jp)
    for a, b, c in zip(g_pipe, g_seq, jax.tree.leaves(g_jax)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-4, atol=1e-4)


def test_pipeline_single_microbatch_and_errors(mesh, jmesh):
    params = _port(jpp.init_stack(8, n_stages=8))
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (8, 8))
                         .astype(np.float32))
    sharded, run = tpp.make_pipeline(mesh, params, n_micro=1)
    np.testing.assert_array_equal(_np(run(sharded, x)),
                                  _np(tpp.stack_apply(params, x)))
    jbad = jpp.init_stack(8, n_stages=4)
    with pytest.raises(ValueError, match="stage") as t:
        tpp.make_pipeline(mesh, _port(jbad), n_micro=2)
    with pytest.raises(ValueError) as j:
        jpp.make_pipeline(jmesh, jbad, n_micro=2)
    assert str(t.value) == str(j.value)
    with pytest.raises(ValueError, match="not divisible"):
        tpp.make_pipeline(mesh, params, n_micro=3)[1](sharded, x)


# -- expert parallelism -----------------------------------------------------

def test_expert_parallel_matches_dense(mesh, jmesh):
    """Top-1 MoE with the all-to-all dispatch equals the dense form:
    worst-case buckets drop no token, so expert parallelism is exact."""
    jp = jep.init_moe(d_model=16, d_ff=32, n_experts=8, seed=3)
    params = _port(jp)
    x = np.random.default_rng(9).normal(0, 1, (64, 16)).astype(np.float32)
    ref = np.asarray(jep.moe_apply_dense(jp, jnp.asarray(x)))
    sharded, apply_fn = tep.make_ep_apply(mesh, params)
    ep = _np(apply_fn(sharded, torch.from_numpy(x)))
    np.testing.assert_allclose(ep, ref, atol=ATOL_EP)
    np.testing.assert_allclose(
        ep, _np(tep.moe_apply_dense(params, torch.from_numpy(x))),
        atol=ATOL_EP)
    e, _ = tep._route_and_gate(params, torch.from_numpy(x))
    je, _ = jep._route_and_gate(jp, jnp.asarray(x))
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert len(np.unique(e.numpy())) >= 3  # routing is not trivial
    jbad = jep.init_moe(16, 32, n_experts=4)
    with pytest.raises(ValueError, match="expert") as t:
        tep.make_ep_apply(mesh, _port(jbad))
    with pytest.raises(ValueError) as j:
        jep.make_ep_apply(jmesh, jbad)
    assert str(t.value) == str(j.value)


def test_expert_parallel_backward_matches_dense(mesh):
    """Gradients through the dispatch (the scatter and gather transpose
    to each other) equal the dense form's on every leaf, and the JAX
    dense form's."""
    jp = jep.init_moe(d_model=16, d_ff=32, n_experts=8, seed=4)
    x = torch.from_numpy(np.random.default_rng(10).normal(0, 1, (64, 16))
                         .astype(np.float32))
    sharded, apply_fn = tep.make_ep_apply(mesh, _port(jp))

    def grads(fn):
        p = tep.MoEParams(*[t.clone().requires_grad_() for t in sharded])
        (fn(p, x) ** 2).mean().backward()
        return [t.grad.numpy() for t in p]

    g_ep = grads(apply_fn)
    g_ref = grads(tep.moe_apply_dense)
    g_jax = jax.grad(lambda p: (jep.moe_apply_dense(p, jnp.asarray(
        x.numpy())) ** 2).mean())(jp)
    for a, b, c in zip(g_ep, g_ref, jax.tree.leaves(g_jax)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=ATOL_EP)
        np.testing.assert_allclose(a, np.asarray(c), rtol=1e-4,
                                   atol=ATOL_EP)


# -- across processes -------------------------------------------------------

_WORKER = textwrap.dedent("""
    import sys

    import numpy as np
    import torch

    from real_time_fraud_detection_system_tpu_torch.parallel.distributed \\
        import initialize_distributed, make_spanning_mesh, \\
        shutdown_distributed
    from real_time_fraud_detection_system_tpu_torch.parallel \\
        .tensor_parallel import make_tp_step

    pid, port, data, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], \\
        sys.argv[4]
    assert initialize_distributed(f"127.0.0.1:{port}", 2, pid,
                                  init_timeout_s=120)
    try:
        z = np.load(data)
        n = len([k for k in z.files if k.startswith("w")])
        params = [(torch.from_numpy(z[f"w{i}"]), torch.from_numpy(z[f"b{i}"]))
                  for i in range(n)]
        mesh = make_spanning_mesh(1, "cpu")
        assert mesh.shape == (2,) and mesh.process_id == pid
        sharded, step = make_tp_step(mesh, params, lr=1.0)
        new, loss = step(sharded, torch.from_numpy(z["x"]),
                         torch.from_numpy(z["y"]))
        flat = {f"{k}{i}": t.numpy() for i, (w, b) in enumerate(new)
                for k, t in (("w", w), ("b", b))}
        np.savez(out, loss=loss.numpy(), **flat)
        print(f"MPOK {pid} {float(loss):.6f}", flush=True)
    finally:
        shutdown_distributed()
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_tp_step(tmp_path):
    """Two processes, one shard each, over a gloo group: the TP step's sum
    crosses processes as an ``all_reduce`` and the result is gathered. Each
    process's loss and updated params equal single-device full-batch SGD
    (the JAX reference); the serving engines refuse the spanning mesh."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (64, 15)).astype(np.float32)
    y = (rng.random(64) < 0.3).astype(np.int32)
    params = jmlp.init_mlp(15, hidden=(32, 16), seed=7)
    np.savez(tmp_path / "data.npz", x=x, y=y,
             **{f"{k}{i}": np.asarray(a) for i, (w, b) in enumerate(params)
                for k, a in (("w", w), ("b", b))})
    (tmp_path / "worker.py").write_text(_WORKER)
    env = dict(os.environ)
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    port = str(_free_port())
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "worker.py"), str(pid), port,
         str(tmp_path / "data.npz"), str(tmp_path / f"out{pid}.npz")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("tensor-parallel worker timed out")
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"MPOK {pid}" in out, out
    ref_l, ref_g = _ref_mlp_grads(params, jnp.asarray(x), jnp.asarray(y))
    for pid in (0, 1):
        z = np.load(tmp_path / f"out{pid}.npz")
        assert abs(float(z["loss"]) - float(ref_l)) < 1e-6
        new = [(torch.from_numpy(z[f"w{i}"]), torch.from_numpy(z[f"b{i}"]))
               for i in range(len(params))]
        _assert_recovered(params, new, ref_g, ATOL_TP, f"process {pid}")

    from real_time_fraud_detection_system_tpu_torch.config import Config
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    with pytest.raises(ValueError, match="spanning processes"):
        ShardedScoringEngine(Config(), "logreg", None, None,
                             mesh=SpanningMesh(["cpu"], 2, 0))
