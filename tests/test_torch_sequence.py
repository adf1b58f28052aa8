"""Port parity: the sequence model family (``models/sequence.py``) and the
blockwise attention (``parallel/ring_attention.py``) against the JAX
package, at small widths (d_model 16, 1-2 layers, T 8 and 40).

The weights are the JAX package's ``init_transformer`` (``jax.random``
from a seed), carried over by ``weights.from_numpy``; the inputs are numpy
from a seed.

Tolerances, and why they hold:

- ``event_features`` and ``build_sequences`` equal: the same host numpy
  on both sides;
- attention outputs within ``atol=1e-6`` and logits within ``atol=1e-5``:
  the products are XLA's dot and einsum on one side and torch's on the
  other (each output adds its 8-64 terms in another order), exp and tanh
  differ by an ulp between the libraries, and the logits carry those
  differences through two blocks of layer norms and the head;
- GELU within ``1e-6``: ``jax.nn.gelu``'s default is the tanh form, the
  port asks torch for it (the exact erf form would differ by ~4e-4);
- artifacts bit for bit, with the same content hash both ways.
"""

import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu.parallel import (
    ring_attention as jring,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.io import artifacts as tart
from real_time_fraud_detection_system_tpu_torch.models import sequence as tseq
from real_time_fraud_detection_system_tpu_torch.parallel import (
    ring_attention as tring,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from test_torch_online_sgd import port_txs  # pytest adds tests/

torch.set_num_threads(1)

ATOL_ATTN = 1e-6
ATOL_LOGIT = 1e-5


def jparams(n_layers=2, d_model=16, seed=3):
    return jseq.init_transformer(d_model=d_model, n_heads=2,
                                 n_layers=n_layers, d_ff=32, seed=seed)


def port(obj):
    return weights.from_numpy(jax.tree.map(np.asarray, obj), "cpu")


def _x(b, t, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, t, tseq.N_EVENT_FEATURES)).astype(np.float32)


# -- host-side assembly ---------------------------------------------------

def test_event_features_equal_the_jax_package():
    rng = np.random.default_rng(1)
    amount = np.round(rng.gamma(2.0, 40.0, 200), 2)
    t_s = np.cumsum(rng.integers(0, 40000, 200)).astype(np.int64) \
        + 1_743_465_600
    np.testing.assert_array_equal(tseq.event_features(amount, t_s),
                                  jseq.event_features(amount, t_s))


@pytest.mark.parametrize("max_len,with_features", [(8, False), (40, True)])
def test_build_sequences_equal_the_jax_package(small_dataset, max_len,
                                               with_features):
    jtxs = small_dataset[3].slice(slice(0, 2000))
    feats = (np.random.default_rng(2).normal(size=(2000, 3))
             .astype(np.float32) if with_features else None)
    j = jseq.build_sequences(jtxs, max_len=max_len, features=feats,
                             start_epoch_s=1_743_465_600)
    t = tseq.build_sequences(port_txs(jtxs), max_len=max_len,
                             features=feats, start_epoch_s=1_743_465_600)
    assert len(t.customer_id) > 0
    for a, b, name in zip(t, j, tseq.SequenceBatch._fields):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- the model ------------------------------------------------------------

def test_init_has_the_jax_structure_and_leaf_order():
    jp = jparams(n_layers=2)
    tp = tseq.init_transformer(d_model=16, n_heads=2, n_layers=2, d_ff=32,
                               seed=3, device="cpu")
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert tree.keystr(tp) == paths
    assert paths[:3] == [".embed_w", ".embed_b", ".blocks[0].ln1_g"]
    assert [tuple(t.shape) for t in tree.leaves(tp)] == \
        [tuple(x.shape) for x in jax.tree_util.tree_leaves(jp)]
    # carried over, the same structure and the same values
    carried = port(jp)
    assert tree.structure(carried) == tree.structure(tp)
    for a, b in zip(tree.leaves(carried), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_gelu_is_the_tanh_form():
    x = np.linspace(-6, 6, 2001).astype(np.float32)
    np.testing.assert_allclose(
        tseq._gelu(torch.from_numpy(x)).numpy(),
        np.asarray(jax.nn.gelu(jnp.asarray(x))), atol=1e-6)


def test_layer_norm_matches_jax():
    x = _x(4, 8, 5) * 30 + 7
    g = np.random.default_rng(6).normal(size=8).astype(np.float32)
    b = np.random.default_rng(7).normal(size=8).astype(np.float32)
    np.testing.assert_allclose(
        tseq._ln(torch.from_numpy(x), torch.from_numpy(g),
                 torch.from_numpy(b)).numpy(),
        np.asarray(jseq._ln(jnp.asarray(x), jnp.asarray(g),
                            jnp.asarray(b))), atol=ATOL_ATTN * 4)


@pytest.mark.parametrize("t,block", [
    (8, 16), (40, 16), (33, 8), (16, 16), (40, 40)])
def test_attention_matches_jax(t, block):
    rng = np.random.default_rng(t + block)
    q, k, v = (rng.normal(size=(3, t, 2, 8)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    jblock = jring.blockwise_attention(jq, jk, jv, block_size=block,
                                       causal=True)
    tblock = tring.blockwise_attention(tq, tk, tv, block_size=block)
    np.testing.assert_allclose(tblock.numpy(), np.asarray(jblock),
                               atol=ATOL_ATTN)
    np.testing.assert_allclose(
        tseq.naive_attn(tq, tk, tv).numpy(),
        np.asarray(jseq.naive_attn(jq, jk, jv, causal=True)),
        atol=ATOL_ATTN)
    # the recurrence equals the materialized softmax
    np.testing.assert_allclose(
        tblock.numpy(), tseq.naive_attn(tq, tk, tv).numpy(),
        atol=ATOL_ATTN)


def _attn_pair(mode, block):
    if mode == "naive":
        return None, None
    return (lambda q, k, v: jring.blockwise_attention(
        q, k, v, block_size=block, causal=True),
        lambda q, k, v: tring.blockwise_attention(q, k, v, block_size=block))


@pytest.mark.parametrize("n_layers", [1, 2])
@pytest.mark.parametrize("t,mode", [(8, "naive"), (40, "naive"),
                                    (40, "blockwise")])
def test_transformer_logits_match_jax(n_layers, t, mode):
    jp = jparams(n_layers=n_layers)
    tp = port(jp)
    x = _x(5, t, t)
    ja, ta = _attn_pair(mode, 16)
    jl = np.asarray(jseq.transformer_logits(jp, jnp.asarray(x), ja))
    tl = tseq.transformer_logits(tp, torch.from_numpy(x), ta).numpy()
    np.testing.assert_allclose(tl, jl, atol=ATOL_LOGIT)
    qpos = np.random.default_rng(t).integers(0, t, 5).astype(np.int32)
    jlast = np.asarray(jseq.transformer_last_logit(
        jp, jnp.asarray(x), jnp.asarray(qpos), ja))
    tlast = tseq.transformer_last_logit(
        tp, torch.from_numpy(x), torch.from_numpy(qpos), ta).numpy()
    np.testing.assert_allclose(tlast, jlast, atol=ATOL_LOGIT)
    # the serving form is the full form at the query position
    np.testing.assert_allclose(tlast, tl[np.arange(5), qpos],
                               atol=ATOL_LOGIT)


def test_transformer_flops_counted_from_the_shapes():
    """At the bench's widths (d_model 32, 2 heads, 2 layers, d_ff 64,
    K = 32) the serving form does ~0.82 MFLOP per row, counted by hand
    from the products of the code."""
    tp = tseq.init_transformer(seed=0, device="meta")
    d, f, k, hd, n_in = 32, 64, 32, 32, 8
    embed = 2 * k * n_in * d
    block = k * (4 * 2 * d * hd + 2 * 2 * d * f) + 2 * 2 * k * k * hd
    last = (k * 2 * 2 * d * hd + 2 * 2 * d * hd + 2 * 2 * d * f
            + 2 * 2 * k * hd + 2 * d)
    assert tseq.transformer_flops(tp, 1, k) == embed + block + last \
        == 819_264
    assert tseq.transformer_flops(tp, 65_536, k) == 65_536 * 819_264


def test_sharded_attention_waits_for_a7():
    """The sharded forms no longer wait: over 4 stacked shards the ring
    and Ulysses forms equal the blockwise attention of the whole sequence
    (within ``ATOL_ATTN``: the same recurrence, other block orders), and
    Ulysses refuses a head count the shards do not divide, as the JAX
    function does."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 32, 4, 8))
                                .astype(np.float32)) for _ in range(3))
    ref = tring.blockwise_attention(q, k, v, block_size=8)

    def stacked(x):
        return x.reshape(2, 4, 8, 4, 8).transpose(0, 1)

    for form in (tring.ring_attention, tring.ulysses_attention):
        out = form(stacked(q), stacked(k), stacked(v))
        np.testing.assert_allclose(
            out.transpose(0, 1).reshape(2, 32, 4, 8).numpy(), ref.numpy(),
            atol=ATOL_ATTN, err_msg=form.__name__)
    with pytest.raises(ValueError, match="divisible"):
        tring.ulysses_attention(*(stacked(x)[:, :, :, :3] for x in
                                  (q, k, v)))


# -- artifacts ------------------------------------------------------------

@pytest.mark.parametrize("n_layers", [1, 2])
def test_sequence_artifacts_move_both_ways(n_layers):
    jp = jparams(n_layers=n_layers, seed=9)
    js = JScaler(mean=jnp.zeros(15), scale=jnp.ones(15))
    jbytes = jart.dump_model_bytes(JTrainedModel(kind="sequence", scaler=js,
                                                 params=jp))
    got = tart.load_model_bytes(jbytes, device="cpu")
    assert got.kind == "sequence"
    assert isinstance(got.params, tseq.TransformerParams)
    assert len(got.params.blocks) == n_layers
    for a, b in zip(tree.leaves(got.params), jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tbytes = tart.dump_model_bytes(tart.TrainedModel(
        kind="sequence", scaler=port(js), params=port(jp)))
    back = jart.load_model_bytes(tbytes)
    for a, b in zip(jax.tree_util.tree_leaves(back.params),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with np.load(io.BytesIO(tbytes)) as z:
        meta = json.loads(str(z["__meta__"]))
        assert meta["seq"] == {"d_model": 16, "n_in": 8, "n_heads": 2,
                               "n_layers": n_layers, "d_ff": 32}
        # the leaves in the JAX flatten order: embed_w first, head_b last
        assert z["seq0"].shape == (8, 16)
        last = 5 + 12 * n_layers
        assert z[f"seq{last}"].shape == (1,)
        assert f"seq{last + 1}" not in z.files
    assert meta["content_sha256"] == got.content_sha256
