"""Which forward the sequence step serves with (``ops/sequence_kernels.py``):
the fused kernel only on the card, with naive attention, no gradient and
forms within the kernel's support; the plain ``transformer_last_logit``
everywhere else. Also the kernel's shared-memory layout as the wrapper
mirrors it, the wrapper's plain version on the CPU, and the engine's
``SEQUENCE_ROWS`` counter by path. These run on the CPU: the
choice looks at forms and at the device's type, never at a card."""

import dataclasses

import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.features import history
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    init_transformer,
    transformer_last_logit,
)
from real_time_fraud_detection_system_tpu_torch.ops import (
    sequence_kernels as sqk,
)
from real_time_fraud_detection_system_tpu_torch.parallel.ring_attention \
    import blockwise_attention
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    SEQUENCE_ROWS,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

FCFG = FeatureConfig(customer_capacity=256, terminal_capacity=256,
                     history_len=32)


def _served(**kw):
    """The served configuration's params (d_model 32, 2 heads, 2 layers,
    d_ff 64, 8 channels), with ``kw`` overriding the init's widths."""
    return init_transformer(**{**dict(d_model=32, n_heads=2, n_layers=2,
                                      d_ff=64), **kw})


def test_the_served_forms_take_the_kernel_on_the_card():
    params = _served()
    assert sqk.kernel_support(params, 32) is None
    assert sqk.serving_path(params, "cuda", 32) == "fused"
    assert sqk.serving_path(params, torch.device("cuda", 0), 32) == "fused"
    assert history.serving_path(params, FCFG, "cuda") == "fused"


def test_cpu_tensors_take_the_plain_forward():
    params = _served()
    assert sqk.serving_path(params, "cpu", 32) == "plain"
    assert history.serving_path(params, FCFG, torch.device("cpu")) == "plain"


def test_blockwise_attention_takes_the_plain_forward():
    params = _served()
    attn = lambda q, k, v: blockwise_attention(q, k, v, block_size=16)  # noqa: E731,E501
    assert "attention" in sqk.kernel_support(params, 32, attn)
    assert sqk.serving_path(params, "cuda", 32, attn) == "plain"
    # auto attention past seq_attn_block is blockwise
    cfg = dataclasses.replace(FCFG, history_len=48, seq_attn_block=32)
    assert history.serving_path(params, cfg, "cuda") == "plain"
    cfg = dataclasses.replace(FCFG, history_len=48, seq_attn="naive")
    assert history.serving_path(params, cfg, "cuda") == "fused"


def test_a_needed_gradient_takes_the_plain_forward():
    params = tree.map(lambda t: t.clone().requires_grad_(True), _served())
    assert sqk.needs_grad(params)
    assert history.serving_path(params, FCFG, "cuda") == "plain"
    with torch.no_grad():
        assert not sqk.needs_grad(params)
        assert history.serving_path(params, FCFG, "cuda") == "fused"
    assert not sqk.needs_grad(_served())
    assert sqk.serving_path(_served(), "cuda", 32, grad=True) == "plain"


# forms outside the kernel's support, and the word its reason names
OUTSIDE = [
    ("d_model", dict(d_model=64), 32),
    ("n_heads", dict(n_heads=4), 32),
    ("n_heads", dict(n_heads=1), 32),
    ("history length", {}, 65),
    ("d_ff", dict(d_ff=129), 32),
    ("n_in", dict(n_in=17), 32),
    ("shared memory", dict(n_layers=7), 32),
    ("at most", dict(n_layers=9), 32),
]


@pytest.mark.parametrize("word,widths,k", OUTSIDE)
def test_shapes_outside_the_support_take_the_plain_forward(word, widths, k):
    params = _served(**widths)
    assert word in sqk.kernel_support(params, k)
    assert sqk.serving_path(params, "cuda", k) == "plain"


def test_other_dtypes_and_stacked_shard_params_take_the_plain_forward():
    doubled = tree.map(lambda t: t.double(), _served())
    assert "float32" in sqk.kernel_support(doubled, 32)
    assert sqk.serving_path(doubled, "cuda", 32) == "plain"
    # the tensor-parallel forward's params carry leading shard dims
    stacked = tree.map(lambda t: torch.stack([t, t]), _served())
    assert "shard" in sqk.kernel_support(stacked, 32)
    assert sqk.serving_path(stacked, "cuda", 32) == "plain"
    # one leaf off its form is enough
    p = _served()
    blk = p.blocks[1]._replace(b1=torch.zeros(65))
    p = p._replace(blocks=(p.blocks[0], blk))
    assert "blocks[1].b1" in sqk.kernel_support(p, 32)


def test_the_layout_mirrors_the_kernel_source():
    """The rows a tile holds and the block's shared memory at the main
    path (11 histories of 32 positions, under the 227 KB a block may take),
    and the deepest stacks that fit."""
    assert sqk.tile_rows(8, 2, 64, 32, 2) == 11
    assert sqk.smem_bytes(8, 2, 64, 32, 2) == 232208
    assert sqk.smem_bytes(8, 2, 64, 32, 2) <= sqk.SMEM_BUDGET
    assert sqk.tile_rows(8, 2, 64, 64, 2) == 5  # two warps a history
    assert sqk.tile_rows(8, 6, 64, 32, 2) == 1
    assert sqk.tile_rows(8, 7, 64, 32, 2) == 0
    assert sqk.tile_rows(8, 4, 128, 32, 2) >= 1
    src = sqk.SOURCE.read_text()
    for const, value in (("kD", sqk.D_MODEL), ("kMaxThreads", sqk.MAX_THREADS),
                         ("kMaxK", sqk.MAX_K), ("kMaxIn", sqk.MAX_IN),
                         ("kMaxFF", sqk.MAX_FF),
                         ("kMaxLayers", sqk.MAX_LAYERS),
                         ("kRow", sqk.ROW_FLOATS), ("kHeads", sqk.N_HEADS)):
        assert f"constexpr int {const} = {value};" in src, const


def test_the_wrapper_is_its_plain_version_on_the_cpu():
    params = _served()
    rng = np.random.default_rng(0)
    hist = torch.as_tensor(rng.normal(size=(40, 32, 8)).astype(np.float32))
    qpos = torch.as_tensor(rng.integers(0, 32, 40))
    n0 = sqk.fused_last_logit.launches
    got = sqk.fused_last_logit(params, hist, qpos)
    assert torch.equal(got, transformer_last_logit(params, hist, qpos))
    assert torch.equal(got, sqk.fused_last_logit_plain(params, hist, qpos))
    assert sqk.fused_last_logit.launches == n0


def _batch(rows=300, seed=1):
    rng = np.random.default_rng(seed)
    return {"tx_id": np.arange(rows, dtype=np.int64),
            "tx_datetime_us": (20200 * 86400 + rng.integers(0, 86400, rows))
            * 1_000_000,
            "customer_id": rng.integers(0, 100, rows).astype(np.int64),
            "terminal_id": rng.integers(0, 100, rows).astype(np.int64),
            "tx_amount_cents": rng.integers(100, 50000, rows)
            .astype(np.int64),
            "kafka_ts_ms": np.zeros(rows, np.int64),
            "label": np.full(rows, -1, np.int32)}


def test_the_engine_counts_scored_rows_by_path():
    """``SEQUENCE_ROWS{path}``, ``path`` fused, plain or dsv2 (DeepSeek-V2's
    forward, ``tests/test_torch_dsv2.py``): each dispatched batch's rows
    under the path its step was built with (plain on the CPU), and
    ``sequence_rows_scored`` among the counters a run's ``trace`` entry
    reads, with no expert slots for this transformer; a forest engine
    registers no such series."""
    reg = MetricsRegistry()
    cfg = Config(features=FCFG, runtime=RuntimeConfig(batch_buckets=(512,)))
    eng = ScoringEngine(cfg, "sequence", _served(),
                        Scaler(torch.zeros(15), torch.ones(15)),
                        device="cpu", metrics=reg)
    assert eng._seq_path == "plain"
    for seed in (1, 2):
        eng.process_batch(_batch(seed=seed))
    assert reg.get(SEQUENCE_ROWS, path="plain").value == 600
    assert reg.get(SEQUENCE_ROWS, path="fused").value == 0
    assert reg.get(SEQUENCE_ROWS, path="dsv2").value == 0
    counts = eng._trace_counts()
    assert set(counts["sequence_rows_scored"]) == {"fused", "plain", "dsv2"}
    assert "expert_slots" not in counts
    # a forest engine registers no such series
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
    )

    freg = MetricsRegistry()
    ScoringEngine(cfg, "forest", synthetic_ensemble(4, 3, 15, seed=0,
                                                    device="cpu"),
                  Scaler(torch.zeros(15), torch.ones(15)), device="cpu",
                  metrics=freg)
    assert freg.get(SEQUENCE_ROWS, path="plain") is None
