"""The check that decides ``correct``: at a small size on the CPU the
program agrees with the plain reference in every cell, and the check
comes out false for the control (the reference in bfloat16 in the
program's place) and for each fault a cell can have, planted in the
timed path underneath a whole run: a step that leaves its state
unchanged, half of each batch left out, a score altered where it is
produced."""

import numpy as np
import pytest
import torch

from fraudbench.harness import run_cell
from fraudbench.reference.sequence import logits

SEED = 2 ** 31 + 987654321


def _run(cell, small, seconds=1.0, **kw):
    return run_cell(cell, SEED, seconds, kw.pop("trace", False),
                    device="cpu", overrides=small, **kw)


def test_program_agrees_with_reference(small_cell):
    cell, small = small_cell
    # the traced window, which the counters are read over, holds a few
    # compaction passes even on a loaded CPU
    out = _run(cell, small, seconds=3.0, trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    if "dense_hit_rate" in m:
        # the small directory both misses and reclaims: the check covers
        # the sketch tier and compaction
        assert m["dense_hit_rate"] < 1.0
        assert m["slots_reclaimed_per_batch"] > 0


def test_control_fails(small_cell):
    cell, small = small_cell
    out = _run(cell, small, control=True)
    assert out["correct"]
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(v > limits[k] for k, v in out["control"].items()), out


def _unchanged_state(monkeypatch):
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    step = ScoringEngine._step

    def frozen(self, packed):
        before = [t.clone() for t in tree.leaves(self.state.feature_state)
                  if torch.is_tensor(t)]
        out = step(self, packed)
        live = [t for t in tree.leaves(self.state.feature_state)
                if torch.is_tensor(t)]
        for t, b in zip(live, before):
            t.copy_(b)
        return out

    monkeypatch.setattr(ScoringEngine, "_step", frozen)


def _half_batch(monkeypatch):
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )

    start = ScoringEngine._start_batch

    def half(self, cols):
        n = len(cols["tx_id"]) // 2
        return start(self, {k: v[:n] for k, v in cols.items()})

    monkeypatch.setattr(ScoringEngine, "_start_batch", half)


def _altered_score(monkeypatch):
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
        StepOut,
    )

    step = ScoringEngine._step

    def altered(self, packed):
        out = step(self, packed)
        probs = out.probs.clone()
        probs[::16] = 1.0 - probs[::16]
        return StepOut(probs, *out[1:])

    monkeypatch.setattr(ScoringEngine, "_step", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _altered_score])
def test_fault_fails(small_cell, fault, monkeypatch):
    cell, small = small_cell
    fault(monkeypatch)
    out = _run(cell, small)
    assert not out["correct"], out["checks"]


def test_transformer_reference_matches_port():
    """The reference's per-position forward against the port's
    serving form at one query position."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
        transformer_last_logit,
    )

    from fraudbench.kinds.sequence import BLOCK_LEAVES

    p = init_transformer(seed=3, device="cpu")
    named = {"embed_w": p.embed_w, "embed_b": p.embed_b, "lnf_g": p.lnf_g,
             "lnf_b": p.lnf_b, "head_w": p.head_w, "head_b": p.head_b}
    for i, blk in enumerate(p.blocks):
        named.update({f"b{i}.{k}": v for k, v in zip(BLOCK_LEAVES, blk)})
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, 32, 8), generator=g)
    qpos = torch.randint(0, 32, (64,), generator=g)
    want = transformer_last_logit(p, x, qpos)
    got = logits(named, x, 2).gather(1, qpos[:, None].long())[:, 0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=2e-5)
