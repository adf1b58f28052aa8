"""DeepSeek-V2's block as the sequence scorer (``models/deepseek_v2.py``,
``ops/moe.py``) against the plain reference (``models/deepseek_v2_ref.py``),
on the CPU in float32 at a small size: hidden 64, 4 heads, latent 32,
rope 16, nope 32, v 32, 8 experts top-2 of width 32, 1 shared, a dense
width of 128, 3 layers (one dense), K = 8.

Tolerances: logits within ``1e-5`` of the reference. Both sides compute
in float32 from the same weights; they differ only in the order of their
sums (the absorbed last layer multiplies the query into W_UK before the
latents, the grouped experts add a row's slots after one product per
expert, the reference gathers each token's experts), which moves a
logit of magnitude ~1 by ~1e-6. The planted faults move it by more than
1e-2. The offline oracle's histories come from float64 times
(``models/sequence.py::event_features``), the step's from float32, as in
``tests/test_torch_history.py``: probabilities there within ``3e-4``.
"""

import math

import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.core.batch import (
    TxBatch,
    make_batch,
)
from real_time_fraud_detection_system_tpu_torch.features import history
from real_time_fraud_detection_system_tpu_torch.models import (
    deepseek_v2 as dsv2,
)
from real_time_fraud_detection_system_tpu_torch.models import (
    deepseek_v2_ref as ref,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    event_features,
)
from real_time_fraud_detection_system_tpu_torch.ops import moe as moe_op
from real_time_fraud_detection_system_tpu_torch.ops import (
    sequence_kernels as sqk,
)
from real_time_fraud_detection_system_tpu_torch.ops import stamp as stamp_op
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    EXPERT_SLOTS,
    SEQUENCE_ROWS,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

ATOL = 1e-5
ATOL_ORACLE = 3e-4
K = 8
YARN = dict(type="yarn", factor=40, original_max_position_embeddings=4096,
            beta_fast=32, beta_slow=1, mscale=0.707, mscale_all_dim=0.707)
SMALL = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4,
             kv_lora_rank=32, qk_nope_head_dim=32, qk_rope_head_dim=16,
             v_head_dim=32, intermediate_size=128, moe_intermediate_size=32,
             n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
             first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000,
             q_lora_rank=None, norm_topk_prob=False, scoring_func="softmax",
             topk_method="greedy", routed_scaling_factor=1.0,
             rope_scaling=YARN)
PUBLISHED = {**SMALL, "hidden_size": 2048, "num_hidden_layers": 27,
             "num_attention_heads": 16, "kv_lora_rank": 512,
             "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
             "v_head_dim": 128, "intermediate_size": 10944,
             "moe_intermediate_size": 1408, "n_routed_experts": 64,
             "n_shared_experts": 2, "num_experts_per_tok": 6}
CAP = 64


@pytest.fixture
def model():
    cfg = dsv2.DSV2Config.from_dict(SMALL)
    leaves = dsv2.init_leaves(cfg, torch.Generator().manual_seed(5))
    return cfg, leaves, dsv2.params_from_leaves(cfg, leaves)


def _events(b, t, seed=0):
    """Event histories [b, t, 8] with the channels' ranges."""
    g = torch.Generator().manual_seed(seed)
    amount = torch.rand(b, t, generator=g) * 200 + 5
    dt = -torch.log(torch.rand(b, t, generator=g)) * 40000
    tod = torch.rand(b, t, generator=g)
    wd = torch.randint(0, 7, (b, t), generator=g) / 7.0
    return torch.stack([torch.log1p(amount), amount / 100,
                        torch.log1p(dt) / 10, torch.sin(2 * math.pi * tod),
                        torch.cos(2 * math.pi * tod),
                        torch.sin(2 * math.pi * wd),
                        torch.cos(2 * math.pi * wd), torch.ones_like(tod)], 2)


def test_yarn_frequencies_follow_the_formulas():
    """The published rope: d(r) = 64 ln(4096 / 2πr) / (2 ln 10^4) gives
    the ramp ⌊d(32)⌋ = 10 to ⌈d(1)⌉ = 23; the frequencies blend θ^(−2i/64)
    and its 40th; the softmax scale is 192^−½ m², m = 0.1·0.707·ln 40 + 1."""
    cfg = dsv2.DSV2Config.from_dict(PUBLISHED)
    i = np.arange(32, dtype=np.float64)
    extra = 10000.0 ** (-2 * i / 64)
    inter = extra / 40

    def d(r):
        return 64 * math.log(4096 / (2 * math.pi * r)) / (2 * math.log(1e4))

    low, high = math.floor(d(32)), math.ceil(d(1))
    assert (low, high) == (10, 23)
    mask = 1 - np.clip((i - low) / (high - low), 0, 1)
    want = inter * (1 - mask) + extra * mask
    got = dsv2.yarn_inv_freq(cfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)
    np.testing.assert_array_equal(got, ref.yarn_inv_freq(PUBLISHED).numpy())
    assert got[0] == 1.0 and got[-1] == pytest.approx(extra[-1] / 40)
    m = 0.1 * 0.707 * math.log(40) + 1
    assert dsv2.softmax_scale(cfg) == pytest.approx(192 ** -0.5 * m * m)


def test_the_served_forward_matches_the_reference(model):
    cfg, leaves, params = model
    x = _events(24, K, seed=1)
    qpos = torch.randint(0, K, (24,), generator=torch.Generator()
                         .manual_seed(2))
    want = ref.logits(SMALL, leaves, x)[torch.arange(24), qpos]
    got = dsv2.last_logit(params, x, qpos)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


def test_the_absorbed_last_layer_matches_the_decompressed_one(model):
    _, _, params = model
    p = params.layers[-1].attn
    x = dsv2.rms_norm(torch.randn(16, K, 64), p.norm, 1e-6)
    cos, sin = dsv2.rope_tables(params.inv_freq, K)
    full = dsv2.mla_full(p, x, params.scale, params.eps, cos, sin)
    qpos = torch.arange(16) % K
    rows = torch.arange(16)
    got = dsv2.mla_absorbed(p, x, x[rows, qpos], qpos, params.scale,
                            params.eps, cos, sin)
    torch.testing.assert_close(got, full[rows, qpos], atol=ATOL, rtol=0)


def _per_token(p, leaves_moe, x):
    return ref.moe(SMALL, leaves_moe, x)


@pytest.mark.parametrize("routing", ["random", "one_takes_all",
                                     "some_take_none"])
def test_grouped_experts_match_the_per_token_form(model, routing):
    """The grouped layer against the reference's per-token gather, with
    each expert's slot count: random routing; expert 3 in every row's
    top-2; experts 0 and 5 alone, the other six taking no slot."""
    _, leaves, params = model
    li = 1
    lv = {n[len(f"l{li}."):]: v.clone() for n, v in leaves.items()
          if n.startswith(f"l{li}.")}
    g = torch.Generator().manual_seed(7)
    base = torch.randn(64, generator=g)
    x = dsv2.rms_norm(3 * base + torch.randn(96, 64, generator=g),
                      torch.ones(64), 1e-6)
    if routing == "one_takes_all":
        lv["router"][:, 3] = base
    elif routing == "some_take_none":
        lv["router"][:, 0] = base
        lv["router"][:, 5] = 0.8 * base
    mp = params.layers[li].mlp._replace(router=lv["router"])
    slots = torch.zeros(8, dtype=torch.int64)
    real = torch.arange(96) % 3 != 0
    got = moe_op.moe(mp, x, 2, 1.0, slots=slots, real=real)
    torch.testing.assert_close(got, _per_token(mp, lv, x), atol=ATOL, rtol=0)
    _, idx = moe_op.route(mp.router, x, 2, 1.0)
    want = torch.bincount(idx[real].reshape(-1), minlength=8)
    assert torch.equal(slots, want) and int(slots.sum()) == 64 * 2
    if routing == "one_takes_all":
        assert int(torch.bincount(idx.reshape(-1), minlength=8)[3]) == 96
    if routing == "some_take_none":
        assert set(torch.nonzero(want).reshape(-1).tolist()) == {0, 5}


def _route_renormalised(router, x, top_k, routed_scale):
    w, idx = torch.topk(torch.softmax(x.float() @ router.float(), -1),
                        top_k, dim=-1)
    return w / w.sum(-1, keepdim=True) * routed_scale, idx


_MOE = moe_op.moe


def _no_shared(p, x, *a, **kw):
    return _MOE(p._replace(shared_down=torch.zeros_like(p.shared_down)), x,
                *a, **kw)


@pytest.mark.parametrize("fault", ["topk_renormalised", "shared_dropped",
                                   "rope_skipped"])
def test_planted_faults_fail(model, monkeypatch, fault):
    cfg, leaves, params = model
    x = _events(24, K, seed=3)
    qpos = torch.full((24,), K - 1)
    want = ref.logits(SMALL, leaves, x)[:, -1]
    if fault == "topk_renormalised":
        monkeypatch.setattr(moe_op, "route", _route_renormalised)
    elif fault == "shared_dropped":
        monkeypatch.setattr(dsv2, "moe", _no_shared)
    else:
        monkeypatch.setattr(dsv2, "rope", lambda x, cos, sin: x)
    got = dsv2.last_logit(params, x, qpos)
    assert (got - want).abs().max() > 1e-2


def _stream(n=240, n_cust=11, seed=0):
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, n_cust, n).astype(np.int64)
    t_s = np.sort(rng.integers(0, 20 * 86400, n)).astype(np.int64) \
        + 20_000 * 86400
    amount = rng.integers(100, 50_000, n).astype(np.int64)
    return cust, t_s, amount


def _oracle(leaves, cust, t_s, amount):
    """Each row's causal window through the reference, at its own
    position."""
    out = np.zeros(len(cust))
    for i in range(len(cust)):
        sel = [j for j in range(i + 1) if cust[j] == cust[i]][-K:]
        f = event_features(amount[sel] / 100.0, t_s[sel])
        x = np.zeros((1, K, f.shape[1]), np.float32)
        x[0, :len(f)] = f
        lg = ref.logits(SMALL, leaves, torch.from_numpy(x))
        out[i] = torch.sigmoid(lg[0, len(f) - 1]).item()
    return out


class _Spy:
    """Records every forward's histories, positions and logits."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = dsv2.last_logit

        def spy(params, hist, qpos, **kw):
            out = inner(params, hist, qpos, **kw)
            self.calls.append((hist.clone(), qpos.clone(), out.clone()))
            return out

        monkeypatch.setattr(dsv2, "last_logit", spy)

    def check(self, leaves):
        for hist, qpos, own in self.calls:
            want = ref.logits(SMALL, leaves, hist)[
                torch.arange(hist.shape[0]), qpos.long()]
            torch.testing.assert_close(own, want, atol=ATOL, rtol=0)


def _fcfg():
    return FeatureConfig(customer_capacity=CAP, terminal_capacity=CAP,
                         history_len=K)


def test_update_and_score_matches_the_reference(model, monkeypatch):
    _, leaves, params = model
    spy = _Spy(monkeypatch)
    fcfg = _fcfg()
    cust, t_s, amount = _stream()
    state = history.init_history_state(fcfg, "cpu")
    probs = []
    for s in range(0, len(cust), 64):
        sl = slice(s, s + 64)
        batch = TxBatch(*[torch.from_numpy(np.asarray(a)) for a in make_batch(
            cust[sl], cust[sl] % 7, t_s[sl] * 1_000_000, amount[sl],
            pad_to=80)])
        state, p = history.update_and_score(state, params, batch, fcfg)
        probs.append(p[:len(cust[sl])].numpy())
        assert (p[len(cust[sl]):] == 0).all()  # padded rows score 0
    spy.check(leaves)
    np.testing.assert_allclose(np.concatenate(probs),
                               _oracle(leaves, cust, t_s, amount),
                               atol=ATOL_ORACLE)


class _ListSource:
    def __init__(self, batches):
        self._batches = batches
        self._i = 0

    def poll_batch(self):
        if self._i >= len(self._batches):
            return None
        self._i += 1
        return dict(self._batches[self._i - 1])

    @property
    def offsets(self):
        return [self._i]


def _columns(cust, t_s, amount, lo, hi):
    n = hi - lo
    return {"tx_id": np.arange(lo, hi, dtype=np.int64),
            "tx_datetime_us": t_s[lo:hi] * 1_000_000,
            "customer_id": cust[lo:hi], "terminal_id": cust[lo:hi] % 7,
            "tx_amount_cents": amount[lo:hi],
            "kafka_ts_ms": np.zeros(n, np.int64),
            "label": np.full(n, -1, np.int32)}


def test_engine_run_serves_the_reference(model, monkeypatch):
    """``ScoringEngine(kind="sequence")`` with DeepSeek-V2's params, depth
    2: the ``dsv2`` path (never the fused kernel), its rows counted under
    it, each expert layer's slots in the run's ``trace`` counters, and
    every row's score the reference's."""
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        MemorySink,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import trace

    _, leaves, params = model
    spy = _Spy(monkeypatch)
    cust, t_s, amount = _stream(seed=4)
    reg = MetricsRegistry()
    cfg = Config(features=_fcfg(), runtime=RuntimeConfig(
        batch_buckets=(64,), max_batch_rows=64, pipeline_depth=2))
    eng = ScoringEngine(cfg, "sequence", params,
                        Scaler(torch.zeros(15), torch.ones(15)),
                        device="cpu", metrics=reg)
    assert eng._seq_path == "dsv2"
    assert history.serving_path(params, cfg.features, "cuda") == "dsv2"
    assert sqk.serving_path(params, "cuda", K) == "plain"  # never fused
    sink = MemorySink()
    tr = trace.get_tracer()
    tr.reset()
    tr.configure(enabled=True)
    try:
        stats = eng.run(_ListSource([_columns(cust, t_s, amount, s, s + 60)
                                     for s in range(0, 240, 60)]), sink=sink)
    finally:
        tr.reset()
    spy.check(leaves)
    got = np.concatenate([b["prediction"] for b in sink.batches])
    np.testing.assert_allclose(got, _oracle(leaves, cust, t_s, amount),
                               atol=ATOL_ORACLE)
    assert reg.get(SEQUENCE_ROWS, path="dsv2").value == 240
    assert reg.get(SEQUENCE_ROWS, path="fused").value == 0
    slots = stats["trace"]["counters"]["expert_slots"]
    assert set(slots) == {"1", "2"} and all(len(v) == 8
                                            for v in slots.values())
    # layer 1 at every real position of every valid row, the last layer
    # at the rows' own positions: two slots each
    real = sum(min(i + 1, K) for c in range(11)
               for i in range(int((cust == c).sum())))
    assert sum(slots["1"]) == 2 * real and sum(slots["2"]) == 2 * 240
    assert reg.family_total(EXPERT_SLOTS) == 2 * real + 2 * 240
    assert "device/mla" not in stats["trace"]["device"]  # the card's only
    # a second run's counters are its own slots, read at its end
    cust2, t_s2, amount2 = _stream(n=120, seed=5)
    tr.configure(enabled=True)
    try:
        again = eng.run(_ListSource([_columns(cust2, t_s2 + 30 * 86400,
                                              amount2, s, s + 60)
                                     for s in (0, 60)]))
    finally:
        tr.reset()
    assert sum(again["trace"]["counters"]["expert_slots"]["2"]) == 2 * 120
    assert reg.family_total(EXPERT_SLOTS) == 2 * real + 2 * 240 + sum(
        map(sum, again["trace"]["counters"]["expert_slots"].values()))


def test_params_keep_their_precision_and_the_config_refuses_others():
    cfg = dsv2.DSV2Config.from_dict(SMALL)
    leaves = dsv2.init_leaves(cfg, torch.Generator().manual_seed(0))
    p = dsv2.params_from_leaves(cfg, leaves, torch.bfloat16)
    assert p.layers[1].mlp.w_gate.dtype == torch.bfloat16
    assert p.layers[0].attn.wq.shape == (64, 4, 48)
    for t in (p.norm_f, p.head_w, p.inv_freq, p.layers[1].mlp.router,
              p.layers[1].attn.kv_norm, p.layers[0].mlp_norm):
        assert t.dtype == torch.float32
    for key, bad in (("q_lora_rank", 1536), ("norm_topk_prob", True),
                     ("topk_method", "group_limited_greedy"),
                     ("scoring_func", "sigmoid")):
        with pytest.raises(ValueError, match=key):
            dsv2.DSV2Config.from_dict({**SMALL, key: bad})


def test_the_stamps_bound_each_span_and_refuse_the_cpu():
    """At the cell's depth (a dense layer and four expert layers) a step
    takes 18 stamps: a start and an end for each layer's attention, then
    for each expert layer; the CPU has no clock to stamp."""
    cfg = dsv2.DSV2Config.from_dict({**PUBLISHED, "num_hidden_layers": 5})
    shapes = dsv2.leaf_shapes(cfg)
    layers = tuple(
        dsv2.DSV2Layer(None, None, moe_op.MoEParams(*[None] * 7)
                       if f"l{i}.router" in shapes else
                       dsv2.DenseMLP(None, None, None))
        for i in range(5))
    p = dsv2.DSV2Params(None, layers, None, None, None, 6, 1.0, 1.0, 1e-6)
    slots = dsv2.stamp_slots(p)
    assert slots == {"device/mla": [(0, 1), (2, 3), (4, 5), (6, 7), (8, 9)],
                     "device/experts": [(10, 11), (12, 13), (14, 15),
                                        (16, 17)]}
    assert dsv2.n_stamps(p) == 18
    for buf, at in ((torch.zeros(18, dtype=torch.int64), 0),
                    (torch.zeros(18, dtype=torch.int32), 0)):
        with pytest.raises(ValueError, match="int64 buffer on the card"):
            stamp_op.stamp(buf, at)
