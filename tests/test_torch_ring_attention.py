"""Port parity: blockwise, ring and Ulysses attention
(``parallel/ring_attention.py``) and the sequence-parallel forward
(``models/sequence.py::make_sp_logits_fn``) against the JAX package — the
cases of ``tests/test_ring_attention.py`` (causal and non-causal, the
ragged tail, bf16, Ulysses against ring and blockwise, the indivisible
heads refusal, gradients) on 8 shards, the JAX side on the 8 virtual
devices of ``tests/conftest.py``.

Inputs are numpy from a seed; the transformer's weights are the JAX
package's ``init_transformer`` carried over by ``weights.from_numpy``.

Tolerances, and why they hold:

- float32 attention outputs within ``atol=1e-5`` of the naive form and of
  the JAX functions (``2e-5`` for Ulysses, as the JAX test): the same
  online-softmax recurrence, with XLA's products on one side and torch's
  on the other and another order of blocks (a ring visits them from the
  shard's own one backwards);
- bf16 within ``atol=0.1`` of the float32 naive form, the JAX test's
  bound (bf16 keeps 8 bits of mantissa in q, k, v and the output);
- gradients within ``atol=3e-5`` (the JAX test's), through both
  libraries' autodiff of the recurrence;
- ``make_sp_logits_fn``'s logits within ``1e-5``, as the transformer's
  other parity tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu.parallel import (
    ring_attention as jring,
)
from real_time_fraud_detection_system_tpu.parallel.mesh import (
    make_mesh as jmake_mesh,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.models import sequence as tseq
from real_time_fraud_detection_system_tpu_torch.parallel import (
    ring_attention as tring,
)
from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
    make_mesh,
)

torch.set_num_threads(1)

ATOL = 1e-5
ATOL_ULYSSES = 2e-5
ATOL_BF16 = 0.1
ATOL_GRAD = 3e-5


def naive_attention(q, k, v, causal):
    """The JAX test's reference, in numpy-fed JAX."""
    b, t, h, d = q.shape
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(d)
    if causal:
        mask = jnp.tril(jnp.ones((t, t), dtype=bool))
        s = jnp.where(mask[None, None], s, -jnp.inf)
    p = jax.nn.softmax(s, axis=-1)
    return np.asarray(jnp.einsum("bhqk,bkhd->bqhd", p, v))


def _qkv(rng, b=2, t=64, h=2, d=8):
    return tuple(rng.normal(0, 1, (b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def _t(*xs):
    return tuple(torch.from_numpy(x) for x in xs)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8, devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def jmesh():
    return jmake_mesh(8)


@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_matches_naive(rng, causal):
    q, k, v = _qkv(rng)
    ref = naive_attention(q, k, v, causal)
    out = tring.blockwise_attention(*_t(q, k, v), block_size=16,
                                    causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)
    np.testing.assert_allclose(
        tseq.naive_attn(*_t(q, k, v), causal=causal).numpy(), ref,
        atol=ATOL)


def test_blockwise_ragged_tail(rng):
    """T not a multiple of the block: the padded keys never enter the
    softmax, causal or not."""
    q, k, v = _qkv(rng, t=50)
    for causal in (True, False):
        ref = naive_attention(q, k, v, causal)
        out = tring.blockwise_attention(*_t(q, k, v), block_size=16,
                                        causal=causal)
        np.testing.assert_allclose(out.numpy(), ref, atol=ATOL,
                                   err_msg=f"causal={causal}")
        jout = jring.blockwise_attention(
            *map(jnp.asarray, (q, k, v)), block_size=16, causal=causal)
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_naive_8dev(rng, mesh, jmesh, causal):
    q, k, v = _qkv(rng, b=2, t=8 * 16, h=2, d=8)
    ref = naive_attention(q, k, v, causal)
    out = tring.make_ring_attention_sharded(mesh, causal=causal)(
        *_t(q, k, v)).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL)
    jout = jring.make_ring_attention_sharded(jmesh, causal=causal)(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(out, np.asarray(jout), atol=ATOL)


def test_ring_bf16(rng, mesh):
    """bf16 in, bf16 out; the statistics stay float32 inside."""
    q, k, v = _qkv(rng, t=8 * 8)
    fn = tring.make_ring_attention_sharded(mesh, causal=True)
    out16 = fn(*(x.to(torch.bfloat16) for x in _t(q, k, v)))
    assert out16.dtype == torch.bfloat16
    np.testing.assert_allclose(out16.float().numpy(),
                               naive_attention(q, k, v, True),
                               atol=ATOL_BF16)


def test_ulysses_matches_blockwise_and_ring(mesh, jmesh):
    """Ulysses ≡ blockwise ≡ ring over 8 shards, and ≡ the JAX Ulysses."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(0, 1, (2, 8 * 16, 8, 16)).astype(np.float32)
               for _ in range(3))
    ref = tring.blockwise_attention(*_t(q, k, v), block_size=16).numpy()
    uly = tring.make_ulysses_attention_sharded(mesh)(*_t(q, k, v)).numpy()
    ring = tring.make_ring_attention_sharded(mesh)(*_t(q, k, v)).numpy()
    np.testing.assert_allclose(uly, ref, atol=ATOL_ULYSSES)
    np.testing.assert_allclose(uly, ring, atol=ATOL_ULYSSES)
    july = jring.make_ulysses_attention_sharded(jmesh)(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(uly, np.asarray(july), atol=ATOL_ULYSSES)
    for causal in (True, False):
        got = tring.make_ulysses_attention_sharded(mesh, causal=causal,
                                                   block_size=32)(
            *_t(q, k, v)).numpy()
        np.testing.assert_allclose(got, naive_attention(q, k, v, causal),
                                   atol=ATOL_ULYSSES,
                                   err_msg=f"causal={causal}")


def test_ulysses_rejects_indivisible_heads(mesh, jmesh):
    q = np.random.default_rng(5).normal(0, 1, (1, 64, 6, 8)).astype(
        np.float32)  # 6 heads over 8 shards
    with pytest.raises(ValueError, match="divisible") as t:
        tring.make_ulysses_attention_sharded(mesh)(*_t(q, q, q))
    with pytest.raises(ValueError) as j:
        jring.make_ulysses_attention_sharded(jmesh)(
            *map(jnp.asarray, (q, q, q)))
    assert str(t.value) == str(j.value)


def _grads(fn, q, k, v, w):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    (fn(qt, kt, vt) * torch.from_numpy(w)).sum().backward()
    return [x.grad.numpy() for x in (qt, kt, vt)]


def test_blockwise_gradients_match_naive():
    """Training through the flash recurrence: blockwise attention's
    gradients for q/k/v equal the naive form's, and the JAX ones."""
    rng = np.random.default_rng(9)
    q, k, v, w = (rng.normal(0, 1, (2, 48, 2, 8)).astype(np.float32)
                  for _ in range(4))
    gb = _grads(lambda *a: tring.blockwise_attention(*a, block_size=16),
                q, k, v, w)
    gn = _grads(tseq.naive_attn, q, k, v, w)
    jg = jax.grad(lambda *a: (jseq.naive_attn(*a, causal=True)
                              * jnp.asarray(w)).sum(), argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    for a, b, c in zip(gb, gn, jg):
        np.testing.assert_allclose(a, b, atol=ATOL_GRAD)
        np.testing.assert_allclose(a, np.asarray(c), atol=ATOL_GRAD)


@pytest.mark.parametrize("form", ["ring", "ulysses"])
def test_sharded_attention_gradients_match_jax(mesh, jmesh, form):
    """The ring's rolls and Ulysses' exchanges differentiate to the JAX
    forms' gradients (the backward pass sequence-parallel training
    takes)."""
    rng = np.random.default_rng(10)
    q, k, v, w = (rng.normal(0, 1, (2, 64, 8, 8)).astype(np.float32)
                  for _ in range(4))
    make_t = getattr(tring, f"make_{form}_attention_sharded")
    make_j = getattr(jring, f"make_{form}_attention_sharded")
    got = _grads(make_t(mesh), q, k, v, w)
    jfn = make_j(jmesh)
    want = jax.grad(lambda *a: (jfn(*a) * jnp.asarray(w)).sum(),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), atol=ATOL_GRAD)


def test_sp_logits_fn_matches_jax(mesh, jmesh):
    """The sequence-parallel forward (the ring in every block) equals the
    JAX ``make_sp_logits_fn`` and the port's unsharded forward."""
    jp = jseq.init_transformer(d_model=16, n_heads=2, n_layers=2, d_ff=32,
                               seed=5)
    tp = weights.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    x = np.random.default_rng(11).normal(0, 1, (3, 8 * 8, 8)).astype(
        np.float32)
    got = tseq.make_sp_logits_fn(mesh)(tp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(jseq.make_sp_logits_fn(jmesh)(jp, jnp.asarray(x))),
        atol=ATOL)
    np.testing.assert_allclose(
        got, tseq.transformer_logits(tp, torch.from_numpy(x)).numpy(),
        atol=ATOL)
    with pytest.raises(ValueError, match="does not divide"):
        tseq.make_sp_logits_fn(mesh)(tp, torch.from_numpy(x[:, :60]))


def test_train_refuses_ring_attention_with_the_jax_message():
    """Training takes naive or blockwise attention; ring attention is the
    sequence-parallel forward's (``make_sp_logits_fn``), and the refusal
    names it as the JAX trainer does."""
    rng = np.random.default_rng(13)
    seqs = tseq.SequenceBatch(
        x=rng.normal(0, 1, (4, 8, 8)).astype(np.float32),
        y=(rng.random((4, 8)) < 0.3).astype(np.int32),
        mask=np.ones((4, 8), bool), customer_id=np.arange(4),
        tx_index=np.arange(32).reshape(4, 8))
    with pytest.raises(ValueError, match="make_sp_logits_fn") as t:
        tseq.train_transformer(seqs, attn="ring", device="cpu")
    with pytest.raises(ValueError) as j:
        jseq.train_transformer(jseq.SequenceBatch(*seqs), attn="ring")
    assert str(t.value) == str(j.value)
