"""The ``dsv2_lite_l5_k32`` configuration (DeepSeek-V2-Lite's block as the
sequence scorer) on the CPU: its cell by name, the weights it draws, its
reference against the repository's, its count against a hand count, its
four readers, its control and planted faults at a small size, and a kind
that takes the model from the program alone."""

import ast
import json
import subprocess
import sys

import pytest
import torch

from fraudbench import harness
from fraudbench.counts.dsv2 import ops_per_row
from fraudbench.kinds.dsv2 import make_leaves, model_settings
from fraudbench.reference import deepseek_v2 as bench_ref
from fraudbench.tests import test_fraudbench_check as check

CELL = "dsv2_lite_l5_k32.cards8k_b2k"
SEED = 2 ** 31 + 424242
SMALL_MODEL = {"hidden_size": 64, "num_attention_heads": 4,
               "kv_lora_rank": 32, "qk_nope_head_dim": 32,
               "qk_rope_head_dim": 16, "v_head_dim": 32,
               "intermediate_size": 128, "moe_intermediate_size": 32,
               "n_routed_experts": 8, "num_experts_per_tok": 2,
               "n_shared_experts": 1, "num_hidden_layers": 3}
SMALL = {
    "traffic": {"n_cards": 512, "batch_rows": 256, "warm_days": 2,
                "pool_days": 2},
    "features": {"customer_capacity": 512, "terminal_capacity": 1024},
    "runtime": {"batch_buckets": [256], "max_batch_rows": 256},
    "model": SMALL_MODEL,
}
# the planted faults' size: the program in float32, whose scores match
# the reference's to ~1e-6 (in bfloat16 at this width they miss it by a
# few 1e-2, as the control does)
SMALL_F32 = {**SMALL, "model": {**SMALL_MODEL, "served_dtype": "float32"}}
NEW = ("mla_device_ms", "expert_device_ms", "expert_load_peak",
       "step_mfu_bf16")


def _config():
    return harness.load_cell(CELL)["config"]


def test_the_cell_loads_by_name():
    c = harness.load_cell(CELL)
    assert c["kind"].__name__ == "fraudbench.kinds.dsv2"
    assert c["traffic"].batch_rows == 2048 and c["traffic"].day_every == 8
    assert c["traffic"].warm_batches == 160
    assert {m["name"] for m in c["end_to_end"]} == {"tx_per_s.seq",
                                                   "setup_s"}
    names = {m["name"] for m in c["per_layer"]}
    assert set(NEW) | {"device_idle_share.seq", "step_device_ms.seq",
                       "latency_p95_ms.seq"} == names
    cfg = c["config"]
    assert cfg["num_hidden_layers"] == 5 and cfg["reduced"] == [
        "num_hidden_layers", "vocab_size"]
    assert cfg["published"] == {"num_hidden_layers": 27,
                                "vocab_size": 102400}


def test_the_configuration_keeps_the_published_widths():
    """Every key of the published config.json but the two cut is as
    published (the catalog's numbers)."""
    cfg = _config()
    published = {"hidden_size": 2048, "intermediate_size": 10944,
                 "kv_lora_rank": 512, "moe_intermediate_size": 1408,
                 "n_routed_experts": 64, "n_shared_experts": 2,
                 "num_attention_heads": 16, "num_experts_per_tok": 6,
                 "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                 "v_head_dim": 128, "first_k_dense_replace": 1,
                 "q_lora_rank": None, "norm_topk_prob": False,
                 "rms_norm_eps": 1e-06, "rope_theta": 10000,
                 "routed_scaling_factor": 1}
    assert {k: cfg[k] for k in published} == published
    assert cfg["rope_scaling"]["factor"] == 40


def _events(n=4096, seed=1):
    """Event channels as ``histories`` gives them: seven that vary and
    the constant last."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, 8, generator=g, dtype=torch.float64) \
        * torch.linspace(0.3, 2.0, 8, dtype=torch.float64) + 3.0
    x[:, 7] = 1.0
    return x


def _small_leaves():
    m = model_settings({**_config(), "model": {"n_in": 8, **SMALL_MODEL}})
    return m, make_leaves(m, 11, "cpu", _events())


def test_the_benchmark_draws_the_weights_the_program_serves():
    """The draw is the benchmark's own: every name and shape of the
    reference's table, N(0, 1) / sqrt(fan_in) from the seed (the same
    seed the same draw), norm gains 1; the program's params take it
    whole."""
    from real_time_fraud_detection_system_tpu_torch.models import (
        deepseek_v2 as dsv2,
    )

    m, leaves = _small_leaves()
    shapes = bench_ref.leaf_shapes(m)
    assert {k: tuple(v.shape) for k, v in leaves.items()} == shapes
    for name, t in leaves.items():
        if t.dim() == 1:
            assert bool((t == 1).all()), name
        elif name != "embed_w":
            fan_in = t.shape[-2]
            assert t.std().item() * fan_in ** 0.5 == pytest.approx(
                1.0, rel=0.25 if t.numel() < 512 else 0.1), name
    again = make_leaves(m, 11, "cpu", _events())
    other = make_leaves(m, 12, "cpu", _events())
    assert all(torch.equal(leaves[k], again[k]) for k in leaves)
    assert not torch.equal(leaves["l1.router"], other["l1.router"])
    p = dsv2.params_from_leaves(dsv2.DSV2Config.from_dict(m), leaves,
                                torch.bfloat16)
    assert p.layers[1].mlp.w_gate.dtype == torch.bfloat16
    assert torch.equal(p.layers[1].mlp.router, leaves["l1.router"])


def test_the_embedding_takes_the_channels_standardised():
    """Folded into the embedding: each varying channel centred and
    scaled by the events' mean and deviation, the constant channel
    (the bias) 0, so the embedded events have mean 0 and each channel's
    row the drawn row over its deviation."""
    m, leaves = _small_leaves()
    ev = _events()
    w = leaves["embed_w"].double()
    h = ev @ w
    assert h.mean(0).abs().max().item() < 1e-5
    mean, std = ev.mean(0), ev.std(0)
    raw = w[:7] * std[:7, None]  # the drawn rows
    assert raw.std().item() * 8 ** 0.5 == pytest.approx(1.0, rel=0.1)
    z = (ev[:, :7] - mean[:7]) / std[:7]
    torch.testing.assert_close(h, z @ raw, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="constant channel"):
        make_leaves(m, 11, "cpu", ev[:, :7])


def test_the_benchmark_reference_equals_the_repositorys():
    """The copy computes each expert over the rows that chose it, the
    repository's reference each row's experts from a gather: the same
    sums in another order, within 1e-5 on logits of magnitude ~1."""
    from real_time_fraud_detection_system_tpu_torch.models import (
        deepseek_v2_ref as repo_ref,
    )

    m, leaves = _small_leaves()
    x = torch.randn(12, 32, 8, generator=torch.Generator().manual_seed(2))
    want = repo_ref.logits(m, leaves, x)
    got = bench_ref.logits(m, leaves, x)
    assert want.abs().max() > 0.1
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    # the control is another number
    assert (bench_ref.logits(m, leaves, x, quant=True) - want).abs().max() \
        > 1e-2


def test_the_count_agrees_with_the_models_shapes():
    """``counts/dsv2.py`` against a count by hand at the cell's shapes
    (5 layers, K = 32): MLA's four products and the K x K scores and
    weighted sums at every position of four layers, the dense layer's
    SwiGLU and the 6 routed and 2 shared experts of width 1,408 there;
    the last layer absorbed at one position; the embedding and head."""
    m = model_settings(_config())
    d = 2048
    mla = 2 * d * 16 * 192 + 2 * d * 576 + 2 * 512 * 16 * 256 \
        + 2 * 16 * 128 * d
    attn = 2 * 32 * 32 * 16 * (192 + 128)
    dense = 6 * d * 10944
    expert = 6 * d * 1408 * 8
    last = 32 * 2 * d * 576 + 2 * d * 16 * 192 + 2 * 16 * 128 * 512 \
        + 2 * 32 * 16 * 576 + 2 * 32 * 16 * 512 + 2 * 16 * 512 * 128 \
        + 2 * 16 * 128 * d + expert
    want = 2 * 32 * 8 * d + 4 * (32 * mla + attn) \
        + 32 * (dense + 3 * expert) + last + 2 * d
    assert ops_per_row(m, 32) == want
    assert want == pytest.approx(21.4e9, rel=0.01)
    # the experts are most of it: 6 routed and 2 shared of width 1,408 at
    # 32 positions of 3 layers and one of the last
    assert 0.6 < (3 * 32 + 1) * expert / want < 0.66


TRACE = {"device": {"device/mla": {"count": 9, "median_ms": 30.5,
                                   "mean_ms": 31.0},
                    "device/experts": {"count": 9, "median_ms": 90.25,
                                       "mean_ms": 91.0}},
         "counters": {"expert_slots": {"1": [30.0, 10.0, 0.0, 0.0],
                                       "2": [10.0, 10.0, 10.0, 10.0]}}}


class _Kind:
    @staticmethod
    def ops_per_row():
        return 2.0e10


@pytest.mark.parametrize("metric,want", [
    ("mla_device_ms", 30.5), ("expert_device_ms", 90.25),
    # layer 1: 30 slots over a mean of 10
    ("expert_load_peak", 3.0),
    # 2e10 × 49,470 rows in 1 s over 989.4e12
    ("step_mfu_bf16", 100.0 * 2.0e10 * 49470 / 989.4e12)])
def test_the_new_readers(metric, want):
    read = harness.reader(metric)
    ctx = {"stats": {"batches": 9, "trace": TRACE}, "kind": _Kind(),
           "untraced": {"window_s": 1.0, "rows": 49470}}
    assert read(ctx) == pytest.approx(want)
    empty = {"stats": {"batches": 9, "trace": {"device": {},
                                               "counters": {}}},
             "kind": _Kind(), "untraced": {"window_s": 1.0, "rows": 0}}
    assert read(empty) is None
    assert read({**empty, "stats": {"batches": 9}}) is None


def test_the_control_fails_at_a_small_size():
    out = harness.run_cell(CELL, SEED, 1.0, False, device="cpu",
                           overrides=SMALL, control=True)
    assert out["attempted"] > 0 and out["failed"] == 0
    checks = out["checks"]
    assert checks["rows_missing"]["value"] == 0
    limit = checks["prob_gap"]["limit"]
    assert out["control"]["prob_gap"] > limit
    assert checks["prob_gap"]["value"] < out["control"]["prob_gap"]


@pytest.mark.parametrize("fault", [None, check._unchanged_state,
                                   check._half_batch,
                                   check._altered_score])
def test_a_planted_fault_fails_the_check(fault, monkeypatch):
    """The cell's check at a small size, the program in float32: it
    passes the program as it is, and fails a step that leaves its state
    unchanged, half of each batch left out, every 16th score altered."""
    if fault is not None:
        fault(monkeypatch)
    out = harness.run_cell(CELL, SEED, 1.0, False, device="cpu",
                           overrides=SMALL_F32)
    assert out["correct"] == (fault is None), out["checks"]
    if fault is None:
        assert out["checks"]["prob_gap"]["value"] < 1e-4


def test_the_kind_takes_the_model_from_the_program_alone(monkeypatch):
    """The kind defines no model code (only its class and the settings'
    merge), imports the model from the program, and a program without
    the model fails the cell at once."""
    path = harness.BENCH / "kinds" / "dsv2.py"
    tree = ast.parse(path.read_text())
    defs = {n.name for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}
    assert defs == {"model_settings", "_stream_events", "make_leaves",
                    "Kind"}
    imports = {a.module for a in ast.walk(tree)
               if isinstance(a, ast.ImportFrom)}
    assert "real_time_fraud_detection_system_tpu_torch.models.deepseek_v2" \
        in imports
    monkeypatch.setitem(
        sys.modules,
        "real_time_fraud_detection_system_tpu_torch.models.deepseek_v2",
        None)
    with pytest.raises(ImportError):
        harness.run_cell(CELL, SEED, 0.5, False, device="cpu",
                         overrides=SMALL)


RUN = """
import json, sys
sys.path.insert(0, {root!r})
from fraudbench.harness import forbidden_modules, run_cell
out = run_cell({cell!r}, 5, 0.5, True, device="cpu", overrides={small!r})
print(json.dumps({{"forbidden": forbidden_modules(),
                  "metrics": sorted(out["metrics"])}}))
"""


def test_a_traced_run_loads_no_jax_and_reads_its_counter():
    code = RUN.format(root=str(harness.ROOT), cell=CELL, small=SMALL)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    # on the CPU: the router's counter, no device spans
    assert "expert_load_peak" in got["metrics"]
    assert "mla_device_ms" not in got["metrics"]
