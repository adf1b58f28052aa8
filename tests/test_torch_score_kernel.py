"""Port parity: the fused featurize→logreg step.

The port's plain ``fused_featurize_score`` (what the CUDA kernel of
``csrc/fused_score.cu`` is held against on the card) runs against the JAX
``update_and_score_pallas`` — its Pallas kernel in interpret mode — and
against the JAX composition ``update_and_featurize`` → ``transform`` →
``logreg_predict_proba``, on the same numpy-seeded batches; and, on
feature-state tables and slots, against the JAX kernel on the rows the JAX
``gather_state_rows`` takes from the same tables. The kernel itself runs
only on a card (``tests/test_torch_gpu.py``).

Tolerances: counts, flags, risks and ``TX_AMOUNT`` bit-identical; the
amount averages within ``rtol=1e-6`` (the JAX kernel sums the NB buckets
in another order than the port's ring order); probabilities within
``atol=1e-6`` (the JAX dot sums the 15 products in another order, and the
two sigmoids differ by ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.core import batch as jbatch
from real_time_fraud_detection_system_tpu.features import online as jonline
from real_time_fraud_detection_system_tpu.models import logreg as jlogreg
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    transform as jtransform,
)
from real_time_fraud_detection_system_tpu.ops.pallas_kernels import (
    fused_featurize_score as jfused_featurize_score,
)
from real_time_fraud_detection_system_tpu.ops.windows import (
    WindowState as JWindowState,
)
from real_time_fraud_detection_system_tpu.ops.windows import (
    gather_state_rows as jgather_state_rows,
)
from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core import batch as tbatch
from real_time_fraud_detection_system_tpu_torch.features import (
    online as tonline,
)
from real_time_fraud_detection_system_tpu_torch.models import logreg as tlogreg
from real_time_fraud_detection_system_tpu_torch.ops import score_kernels as sk
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
)

# Tiny shapes: one intra-op thread each keeps the parallel test workers'
# cores free for the timing-sensitive tests beside them.
torch.set_num_threads(1)

N_FEAT = 15
ATOL_PROB = 1e-6
RTOL_SUM_ORDER = 1e-6
EXACT_COLS = [0, 1, 2, 3, 5, 7, 9, 10, 11, 12, 13, 14]  # all but amount avgs
CAPS = dict(customer_capacity=256, terminal_capacity=512)


def _cols(rng, n, with_labels=True):
    """Rows like tests/test_pallas.py::_batch: 40 days, labels 0/1."""
    return {
        "customer_id": rng.integers(0, 200, n).astype(np.int64),
        "terminal_id": rng.integers(0, 400, n).astype(np.int64),
        "tx_datetime_us": (((20200 + rng.integers(0, 40, n)) * 86400
                            + rng.integers(0, 86400, n)).astype(np.int64)
                           * 1_000_000),
        "amount_cents": rng.integers(100, 50000, n).astype(np.int64),
        "label": (rng.integers(0, 2, n).astype(np.int32) if with_labels
                  else None),
    }


def _params(rng):
    w = rng.normal(0, 0.3, N_FEAT).astype(np.float32)
    b = np.float32(rng.normal(0, 0.5))
    mean = rng.normal(0, 1, N_FEAT).astype(np.float32)
    scale = rng.uniform(0.5, 2.0, N_FEAT).astype(np.float32)
    return w, b, mean, scale


def _both_batches(cols, pad_to=None):
    jb = jax.tree.map(jnp.asarray, jbatch.make_batch(**cols, pad_to=pad_to))
    tb = tbatch.unpack_batch(torch.from_numpy(tbatch.pack_batch(
        tbatch.make_batch(**cols, pad_to=pad_to))))
    return jb, tb


def _check_feats(tfeats, jfeats):
    np.testing.assert_array_equal(tfeats[:, EXACT_COLS], jfeats[:, EXACT_COLS])
    np.testing.assert_allclose(tfeats, jfeats, rtol=RTOL_SUM_ORDER)


@pytest.mark.parametrize("rows", [64, 256, 300])  # 300: no ×8 tile
def test_fused_score_matches_jax_pallas(rows):
    rng = np.random.default_rng(rows)
    w, b, mean, scale = _params(rng)
    jcfg = JFeatureConfig(**CAPS)
    tcfg = FeatureConfig(**CAPS)

    def fused(fstate, batch):
        return jonline.update_and_score_pallas(
            fstate, batch, jcfg, jnp.asarray(mean), jnp.asarray(scale),
            jnp.asarray(w), jnp.asarray(b))

    jfn = jax.jit(fused, donate_argnums=(0,))
    js = jonline.init_feature_state(jcfg)
    ts = tonline.init_feature_state(tcfg, torch.device("cpu"))
    targs = [torch.as_tensor(a) for a in (mean, scale, w, b)]
    # three chained batches: later ones read state the earlier scattered
    for _ in range(3):
        jb, tb = _both_batches(_cols(rng, rows))
        js, jprobs, jfeats = jfn(js, jb)
        ts, tprobs, tfeats = tonline.update_and_score_fused_logreg(
            ts, tb, tcfg, *targs)
        _check_feats(tfeats.numpy(), np.asarray(jfeats))
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                                   rtol=0.0, atol=ATOL_PROB)
    for table in ("customer", "terminal"):
        for name in ("bucket_day", "count", "fraud"):
            np.testing.assert_array_equal(
                getattr(getattr(ts, table), name).numpy(),
                np.asarray(getattr(getattr(js, table), name)))


@pytest.mark.parametrize("rows", [64, 256, 300])
def test_fused_score_matches_jax_composition(rows):
    """Against the unfused JAX path: assemble → transform → logreg."""
    rng = np.random.default_rng(100 + rows)
    w, b, mean, scale = _params(rng)
    jcfg = JFeatureConfig(**CAPS)
    tcfg = FeatureConfig(**CAPS)
    params = jlogreg.LogRegParams(w=jnp.asarray(w), b=jnp.asarray(b))
    scaler = JScaler(mean=jnp.asarray(mean), scale=jnp.asarray(scale))

    @jax.jit
    def unfused(fstate, batch):
        fstate, feats = jonline.update_and_featurize(fstate, batch, jcfg)
        probs = jnp.where(batch.valid, jlogreg.logreg_predict_proba(
            params, jtransform(scaler, feats)), 0.0)
        return fstate, probs, feats

    js = jonline.init_feature_state(jcfg)
    ts = tonline.init_feature_state(tcfg, torch.device("cpu"))
    targs = [torch.as_tensor(a) for a in (mean, scale, w, b)]
    for _ in range(2):
        jb, tb = _both_batches(_cols(rng, rows))
        js, jprobs, jfeats = unfused(js, jb)
        ts, tprobs, tfeats = tonline.update_and_score_fused_logreg(
            ts, tb, tcfg, *targs)
        _check_feats(tfeats.numpy(), np.asarray(jfeats))
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                                   rtol=0.0, atol=ATOL_PROB)
        assert np.array_equal(tprobs.numpy() >= 0.5,
                              np.asarray(jprobs) >= 0.5)


def test_padded_rows_score_zero_like_the_jax_kernel():
    """Mirror of tests/test_pallas.py::test_fused_kernel_jit_and_padding:
    100 real rows padded to 256, the JAX kernel on a 2-tile grid."""
    rng = np.random.default_rng(5)
    w, b, mean, scale = _params(rng)
    jcfg = JFeatureConfig(**CAPS)
    tcfg = FeatureConfig(**CAPS)
    jb, tb = _both_batches(_cols(rng, 100, with_labels=False), pad_to=256)

    js, cust, term = jonline._update_state(
        jonline.init_feature_state(jcfg), jb, jcfg)
    c_bd, c_cnt, c_amt, _ = jgather_state_rows(js.customer, cust)
    t_bd, t_cnt, _, t_frd = jgather_state_rows(js.terminal, term)
    jprobs, jfeats = jfused_featurize_score(
        (c_bd, c_cnt, c_amt), (t_bd, t_cnt, t_frd), jb.day, jb.tod_s,
        jb.amount, jb.valid, jnp.asarray(mean), jnp.asarray(scale),
        jnp.asarray(w), jnp.asarray(b), block_rows=128)

    ts = tonline.init_feature_state(tcfg, torch.device("cpu"))
    ts, tprobs, tfeats = tonline.update_and_score_fused_logreg(
        ts, tb, tcfg, *(torch.as_tensor(a) for a in (mean, scale, w, b)))
    _check_feats(tfeats.numpy(), np.asarray(jfeats))
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs),
                               rtol=0.0, atol=ATOL_PROB)
    assert (tprobs.numpy()[100:] == 0.0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_logreg_predict_matches_jax(seed):
    rng = np.random.default_rng(seed)
    w, b, _, _ = _params(rng)
    x = rng.normal(0, 2, (257, N_FEAT)).astype(np.float32)
    want = np.asarray(jlogreg.logreg_predict_proba(
        jlogreg.LogRegParams(jnp.asarray(w), jnp.asarray(b)),
        jnp.asarray(x)))
    got = tlogreg.logreg_predict_proba(
        tlogreg.LogRegParams(torch.as_tensor(w), torch.as_tensor(b)),
        torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0.0, atol=ATOL_PROB)


def test_plain_logit_adds_in_feature_order():
    """The plain logit is the kernel's: products added one after another
    in feature order, then the bias — bit for bit."""
    rng = np.random.default_rng(11)
    w, b, _, _ = _params(rng)
    x = rng.normal(0, 3, (64, N_FEAT)).astype(np.float32)
    want = np.zeros(64, np.float32)
    for f in range(N_FEAT):
        want = (want + x[:, f] * w[f]).astype(np.float32)
    want = (want + b).astype(np.float32)
    got = tlogreg.logreg_logits(
        tlogreg.LogRegParams(torch.as_tensor(w), torch.as_tensor(b)),
        torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(got, want)


def state_inputs(rng, b, nb, caps=(64, 128)):
    """Customer and terminal feature-state tables ([cap, nb] bucket_day,
    count, amount, fraud: stamps within the last ~45 days of day 20200, a
    third empty; small counts, cent amounts, fraud sums no larger than the
    counts), a batch's slots into them (repeats, slot cap-1 and, for b > 1,
    slot 0) and its per-row scalars (days around 20200, so some stamps lie
    ahead of a row's day), as numpy."""
    tables, slots = [], []
    for cap in caps:
        bd = (20200 - rng.integers(-1, 46, (cap, nb))).astype(np.int32)
        bd[rng.random((cap, nb)) < 0.3] = -1
        cnt = rng.integers(0, 6, (cap, nb)).astype(np.float32)
        amt = (cnt * rng.integers(100, 20000, (cap, nb)) / 100.0
               ).astype(np.float32)
        frd = np.minimum(rng.integers(0, 3, (cap, nb)), cnt).astype(
            np.float32)
        tables.append((bd, cnt, amt, frd))
        slot = rng.integers(0, cap, b)
        slot[0] = cap - 1
        slot[1:2] = 0
        slot[2:4] = slot[0]  # a repeat
        slots.append(slot.astype(np.int64))
    return dict(
        tables=tables, slots=slots,
        day=(20200 + rng.integers(-2, 3, b)).astype(np.int32),
        tod_s=rng.integers(0, 86400, b).astype(np.int32),
        amount=(rng.integers(100, 30000, b) / 100.0).astype(np.float32))


def port_feature_args(inp):
    """``state_inputs`` as the port's feature arguments (CPU tensors)."""
    (c, t), (cs, ts) = inp["tables"], inp["slots"]
    return dict(customer=WindowState(*map(torch.from_numpy, c)),
                terminal=WindowState(*map(torch.from_numpy, t)),
                cust_slot=torch.from_numpy(cs), term_slot=torch.from_numpy(ts),
                **{k: torch.from_numpy(inp[k])
                   for k in ("day", "tod_s", "amount")})


def jax_gathered_rows(inp):
    """``state_inputs``' rows as the JAX ``gather_state_rows`` takes them
    from the same tables: ((bd, cnt, amt), (bd, cnt, frd))."""
    (c, t), (cs, ts) = inp["tables"], inp["slots"]
    c_bd, c_cnt, c_amt, _ = jgather_state_rows(
        JWindowState(*map(jnp.asarray, c)), jnp.asarray(cs))
    t_bd, t_cnt, _, t_frd = jgather_state_rows(
        JWindowState(*map(jnp.asarray, t)), jnp.asarray(ts))
    return (c_bd, c_cnt, c_amt), (t_bd, t_cnt, t_frd)


@pytest.mark.parametrize("nb", [38, 40])  # 38: 7-day delay + 30-day window + 1
@pytest.mark.parametrize("b", [1, 37, 64])  # 37: no ×8 tile
def test_plain_on_tables_matches_jax_kernel_on_gathered_rows(b, nb):
    """The port's plain version and its CPU wrapper take the tables and
    the slots; the JAX kernel (interpret mode) takes the rows that the JAX
    ``gather_state_rows`` gathers from the same tables by the same slots."""
    rng = np.random.default_rng(1000 * nb + b)
    w, bias, mean, scale = _params(rng)
    inp = state_inputs(rng, b, nb)
    valid = rng.random(b) < 0.8
    c_rows, t_rows = jax_gathered_rows(inp)
    jprobs, jfeats = jfused_featurize_score(
        c_rows, t_rows, jnp.asarray(inp["day"]), jnp.asarray(inp["tod_s"]),
        jnp.asarray(inp["amount"]), jnp.asarray(valid), jnp.asarray(mean),
        jnp.asarray(scale), jnp.asarray(w), jnp.asarray(bias),
        block_rows=b)
    args = dict(port_feature_args(inp), valid=torch.from_numpy(valid),
                scaler_mean=torch.from_numpy(mean),
                scaler_scale=torch.from_numpy(scale),
                w=torch.from_numpy(w), b=torch.tensor(bias))
    pprobs, pfeats = sk.fused_featurize_score_plain(**args)
    probs, feats = sk.fused_featurize_score(**args)
    np.testing.assert_array_equal(feats.numpy(), pfeats.numpy())
    np.testing.assert_array_equal(probs.numpy(), pprobs.numpy())
    # counts, flags, risks and amount bit-identical; the amount averages
    # to rtol 1e-6, as the JAX kernel sums the buckets in another order
    _check_feats(pfeats.numpy(), np.asarray(jfeats))
    np.testing.assert_allclose(pprobs.numpy(), np.asarray(jprobs),
                               rtol=0.0, atol=ATOL_PROB)
    assert (pprobs.numpy()[~valid] == 0.0).all()


def test_plain_refuses_a_slot_outside_the_table():
    rng = np.random.default_rng(3)
    args = dict(port_feature_args(state_inputs(rng, 8, 40)),
                valid=torch.ones(8, dtype=torch.bool),
                scaler_mean=torch.zeros(N_FEAT),
                scaler_scale=torch.ones(N_FEAT), w=torch.zeros(N_FEAT),
                b=torch.tensor(0.0))
    for name, bad in (("cust_slot", 64), ("term_slot", -1)):
        slot = args[name].clone()
        slot[5] = bad
        with pytest.raises(IndexError, match=name):
            sk.fused_featurize_score_plain(**{**args, name: slot})


def _kernel_args(rng, b=40, nb=40):
    args = port_feature_args(state_inputs(rng, b, nb))
    return dict(
        args, valid=torch.as_tensor(rng.random(b) < 0.8),
        scaler_mean=torch.zeros(N_FEAT), scaler_scale=torch.ones(N_FEAT),
        w=torch.as_tensor(rng.normal(0, 0.1, N_FEAT).astype(np.float32)),
        b=torch.tensor(-1.0))


def test_cpu_wrapper_takes_the_plain_version():
    args = _kernel_args(np.random.default_rng(4))
    before = sk.fused_featurize_score.launches
    probs, feats = sk.fused_featurize_score(**args)
    assert sk.fused_featurize_score.launches == before
    pprobs, pfeats = sk.fused_featurize_score_plain(**args)
    np.testing.assert_array_equal(probs.numpy(), pprobs.numpy())
    np.testing.assert_array_equal(feats.numpy(), pfeats.numpy())
    assert (probs.numpy()[~args["valid"].numpy()] == 0.0).all()
    meta = {k: (type(v)(*(t.to("meta") for t in v)) if isinstance(v, tuple)
                else v.to("meta")) for k, v in args.items()}
    with pytest.raises(ValueError, match="no fused logreg kernel"):
        sk.fused_featurize_score(**meta)
