"""DeepSeek-V2's block as the sequence scorer on the card, in bfloat16 at
a reduced size (hidden 256, 4 heads, latent 64, 16 experts of width 128
top-4 and 2 shared, 3 layers, K = 16), through ``ScoringEngine.run`` from
the precompiled CUDA graph at depth 2: the scores against the plain
float32 reference, the graph against the same engine run eagerly, the
device spans ``device/mla`` and ``device/experts`` and the expert-slot
counter. Without a card they skip.

They import neither jax nor the JAX package (run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_dsv2_gpu.py``).

Tolerances: the graph replays the eager step's kernels on the same
inputs, so its scores equal the eager run's exactly. Against the float32
reference the products' inputs and outputs are rounded to bfloat16
(2^-8 relative) through three layers, which moves a score by ~1e-3 and,
where a row's top-4 experts change on the rounding (a near tie), by up to
a few 1e-2: median within 2e-3, every row within 0.05.
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
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
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
from real_time_fraud_detection_system_tpu_torch.ops import stamp
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    EXPERT_SLOTS,
    SEQUENCE_ROWS,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils import trace
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

pytestmark = pytest.mark.gpu

K = 16
ROWS = 256
CFG = dict(hidden_size=256, num_hidden_layers=3, num_attention_heads=4,
           kv_lora_rank=64, qk_nope_head_dim=64, qk_rope_head_dim=32,
           v_head_dim=64, intermediate_size=512, moe_intermediate_size=128,
           n_routed_experts=16, n_shared_experts=2, num_experts_per_tok=4,
           first_k_dense_replace=1, rms_norm_eps=1e-6, rope_theta=10000,
           q_lora_rank=None,
           rope_scaling=dict(type="yarn", factor=40,
                             original_max_position_embeddings=4096,
                             beta_fast=32, beta_slow=1, mscale=0.707,
                             mscale_all_dim=0.707))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    return torch.device("cuda")


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


def _stream(n, n_cust=96, seed=0):
    rng = np.random.default_rng(seed)
    cust = rng.integers(0, n_cust, n).astype(np.int64)
    t_s = np.sort(rng.integers(0, 20 * 86400, n)).astype(np.int64) \
        + 20_000 * 86400
    amount = rng.integers(100, 50_000, n).astype(np.int64)
    cols = [{"tx_id": np.arange(s, s + ROWS, dtype=np.int64),
             "tx_datetime_us": t_s[s:s + ROWS] * 1_000_000,
             "customer_id": cust[s:s + ROWS],
             "terminal_id": cust[s:s + ROWS] % 7,
             "tx_amount_cents": amount[s:s + ROWS],
             "kafka_ts_ms": np.zeros(ROWS, np.int64),
             "label": np.full(ROWS, -1, np.int32)}
            for s in range(0, n, ROWS)]
    return cust, t_s, amount, cols


def _oracle(leaves, cust, t_s, amount, dev):
    """Each row's causal window through the float32 reference."""
    x = np.zeros((len(cust), K, 8), np.float32)
    at = np.zeros(len(cust), np.int64)
    for i in range(len(cust)):
        sel = [j for j in range(i + 1) if cust[j] == cust[i]][-K:]
        f = event_features(amount[sel] / 100.0, t_s[sel])
        x[i, :len(f)] = f
        at[i] = len(f) - 1
    lg = ref.logits(CFG, leaves, torch.from_numpy(x).to(dev))
    return torch.sigmoid(lg[torch.arange(len(cust)), torch.from_numpy(at)
                            .to(dev)]).double().cpu().numpy()


def _engine(params, dev, precompile, reg):
    cfg = Config(features=FeatureConfig(customer_capacity=128,
                                        terminal_capacity=128,
                                        history_len=K),
                 runtime=RuntimeConfig(batch_buckets=(ROWS,),
                                       max_batch_rows=ROWS, pipeline_depth=2,
                                       precompile=precompile))
    return ScoringEngine(cfg, "sequence", params,
                         Scaler(torch.zeros(15, device=dev),
                                torch.ones(15, device=dev)),
                         device=dev, metrics=reg)


def test_the_captured_graph_serves_the_reference_with_its_spans(cuda):
    cfg = dsv2.DSV2Config.from_dict(CFG)
    leaves = dsv2.init_leaves(cfg, torch.Generator(device=cuda)
                              .manual_seed(3), cuda)
    params = dsv2.params_from_leaves(cfg, leaves, torch.bfloat16)
    cust, t_s, amount, cols = _stream(6 * ROWS)
    reg = MetricsRegistry()
    eng = _engine(params, cuda, True, reg)
    assert eng._seq_path == "dsv2"
    sink = MemorySink()
    tr = trace.get_tracer()
    tr.reset()
    tr.configure(enabled=True)
    try:
        stats = eng.run(_ListSource(cols), sink=sink)
    finally:
        tr.reset()
    assert ("step", 7, ROWS) in eng._graphs
    assert stamp.stamp.captured >= 2 * 3 + 2 * 2
    got = np.concatenate([b["prediction"] for b in sink.batches])
    # the graph equals the same step run eagerly
    eager = MemorySink()
    _engine(params, cuda, False, MetricsRegistry()).run(_ListSource(cols),
                                                        sink=eager)
    np.testing.assert_array_equal(
        got, np.concatenate([b["prediction"] for b in eager.batches]))
    gap = np.abs(got - _oracle(leaves, cust, t_s, amount, cuda))
    assert np.median(gap) < 2e-3 and gap.max() < 0.05, (np.median(gap),
                                                         gap.max())
    dev = stats["trace"]["device"]
    for name in ("device/mla", "device/experts"):
        assert dev[name]["count"] == 6 and dev[name]["median_ms"] > 0
    assert dev["device/mla"]["median_ms"] + dev["device/experts"][
        "median_ms"] < dev["device/step"]["median_ms"]
    slots = stats["trace"]["counters"]["expert_slots"]
    assert set(slots) == {"1", "2"}
    assert sum(slots["2"]) == 4 * 6 * ROWS  # the last layer: own positions
    assert reg.family_total(EXPERT_SLOTS) == sum(map(sum, slots.values()))
    assert reg.get(SEQUENCE_ROWS, path="dsv2").value == 6 * ROWS
    assert math.isfinite(float(got.sum()))
