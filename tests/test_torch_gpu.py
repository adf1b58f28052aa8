"""Tests that need an NVIDIA card: the fused forest kernel against its
plain version, and the engine on CUDA against the engine on the CPU.

They import neither jax nor the JAX package, so they also run on a machine
that has only PyTorch and the CUDA toolkit (the suite's ``conftest.py``
imports jax, hence ``--noconftest`` there):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a card they skip. Tolerances: features bit-identical (kernel and
plain version add the window buckets in the same order, with IEEE division
and no FMA contraction); leaf sums within ``atol=1e-5`` of the plain
version with identical decisions, and bit-identical across the z modes
(z is an exact integer in each). Engine against engine: amount averages
within ``rtol=1e-6`` (the card's ``index_add_`` adds a day's amounts in
any order), probabilities within ``1e-7``, the rest bit-identical.
"""

import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    DataConfig,
    FeatureConfig,
    RuntimeConfig,
)
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble,
    to_gemm,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler,
)
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels as fk
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource,
)

pytestmark = pytest.mark.gpu

N_FEAT = 15
ATOL_LEAF = 1e-5
ATOL_PROB = 1e-7
RTOL_AMOUNT = 1e-6
START = 1_743_465_600


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _gathered(rng, b, dev):
    """Gathered window rows: stamps within the last ~45 days (some empty),
    small counts, cent amounts, fraud sums no larger than the counts."""
    nb = 40
    bd = (20200 - rng.integers(-1, 46, (b, nb))).astype(np.int32)
    bd[rng.random((b, nb)) < 0.3] = -1
    cnt = rng.integers(0, 30, (2, b, nb)).astype(np.float32)
    amt = (cnt[0] * rng.integers(100, 20000, (b, nb)) / 100.0)
    frd = np.minimum(rng.integers(0, 3, (b, nb)), cnt[1])
    as_t = lambda a, dt=np.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a, dt), device=dev)
    return dict(
        c_rows=(as_t(bd, np.int32), as_t(cnt[0]), as_t(amt)),
        t_rows=(as_t(bd, np.int32), as_t(cnt[1]), as_t(frd)),
        day=as_t(np.full(b, 20200), np.int32),
        tod_s=as_t(rng.integers(0, 86400, b), np.int32),
        amount=as_t(rng.integers(100, 30000, b) / 100.0),
        scaler_mean=as_t(rng.normal(size=N_FEAT)),
        scaler_scale=as_t(1.0 + rng.random(N_FEAT)))


@pytest.mark.parametrize("rows", [1, 300, 4096])
def test_fused_forest_kernel_matches_plain_version(cuda, rows):
    g = to_gemm(synthetic_ensemble(13, 6, N_FEAT, seed=2, device=cuda),
                N_FEAT)
    args = _gathered(np.random.default_rng(rows), rows, cuda)
    leaves = []
    for z_mode in ("f32", "bf16", "int8"):
        tables = fk.to_kernel_tables(g, z_mode)
        before = fk.fused_forest_leaf_sum.launches
        leaf, feats = fk.fused_forest_leaf_sum(tables, **args)
        torch.cuda.synchronize()
        assert fk.fused_forest_leaf_sum.launches == before + 1
        pleaf, pfeats = fk.fused_forest_leaf_sum_plain(tables, **args)
        assert torch.equal(feats, pfeats)
        torch.testing.assert_close(leaf, pleaf, rtol=0.0, atol=ATOL_LEAF)
        assert torch.equal(leaf / 13 >= 0.5, pleaf / 13 >= 0.5)
        leaves.append(leaf)
    assert torch.equal(leaves[0], leaves[1])
    assert torch.equal(leaves[0], leaves[2])


def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    g = to_gemm(synthetic_ensemble(3, 3, N_FEAT, seed=1, device=cuda),
                N_FEAT)
    tables = fk.to_kernel_tables(g, "int8")
    args = _gathered(np.random.default_rng(0), 8, cuda)
    with pytest.raises(ValueError, match="day"):
        fk.fused_forest_leaf_sum(tables, **{**args,
                                            "day": args["day"].long()})
    with pytest.raises(ValueError, match="windows"):
        fk.fused_forest_leaf_sum(tables, **args, windows=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("n_trees,max_depth", [(10, 5), (1, 12)])
def test_engine_on_cuda_matches_cpu_engine(cuda, n_trees, max_depth):
    """Depth 5 is admitted to the fused kernel; depth 12 is not (its
    tables exceed the kernel's shared memory), so it takes the unfused
    step on the card."""
    cfg = Config(data=DataConfig(n_customers=120, n_terminals=240,
                                 n_days=45, seed=7),
                 features=FeatureConfig(customer_capacity=128,
                                        terminal_capacity=256),
                 runtime=RuntimeConfig(batch_buckets=(256, 1024)))
    _, _, txs = generate_dataset(cfg.data)
    txs = txs.slice(slice(0, 3000))
    ens = synthetic_ensemble(n_trees, max_depth, N_FEAT, seed=3,
                             device="cpu")
    probe = ScoringEngine(cfg, "forest", ens,
                          fit_scaler(np.zeros((2, N_FEAT)), device="cpu"),
                          device="cpu")
    feats = probe.process_batch(
        ReplaySource(txs, START, batch_rows=1024).poll_batch()).features
    sinks = {}
    for dev in ("cpu", "cuda"):
        eng = ScoringEngine(cfg, "forest", ens,
                            fit_scaler(feats, device=dev), device=dev)
        admitted = eng.tables is not None
        assert admitted == (max_depth <= 8)
        sinks[dev] = MemorySink()
        before = fk.fused_forest_leaf_sum.launches
        stats = eng.run(ReplaySource(txs, START, batch_rows=1000),
                        sinks[dev])
        assert fk.fused_forest_leaf_sum.launches - before \
            == (stats["batches"] if admitted and dev == "cuda" else 0)
    got, want = sinks["cuda"].concat(), sinks["cpu"].concat()
    for k in want:
        if k == "processed_at_us":
            continue
        if k == "prediction":
            np.testing.assert_allclose(got[k], want[k], rtol=0.0,
                                       atol=ATOL_PROB)
            assert np.array_equal(got[k] >= 0.5, want[k] >= 0.5)
        elif "avg_amount" in k:  # the card's index_add_ adds in any order
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL_AMOUNT)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
