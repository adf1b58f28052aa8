"""Tests that need an NVIDIA card: each kernel (fused forest, leaf sum,
fused logreg) against its plain version — the fused kernels on
feature-state tables and slots, at several NB and with repeated slots —
the wrappers' refusals, and the engine of each model kind on CUDA against
the engine on the CPU.

They import neither jax nor the JAX package, so they also run on a machine
that has only PyTorch and the CUDA toolkit (the suite's ``conftest.py``
imports jax, hence ``--noconftest`` there):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

The checkpoint tests restore on the card what the CPU wrote (and the
reverse), check that a restore writes into the engine's own tensors, and
run a supervised crash and stall on the card against its uninterrupted
run. The zoo's cases run the mlp and autoencoder engines (with the
in-step SGD, sync-free) and the sequence engine (naive and blockwise
attention, its step under ``set_sync_debug_mode("error")``) on the card
against CPU engines. Without a card they skip. Tolerances: features bit-identical (kernel and
plain version add the window buckets in the same order, with IEEE division
and no FMA contraction); leaf sums within ``atol=1e-5`` of the plain
version with identical decisions, and bit-identical across the z modes
(z is an exact integer in each) — bit-identical to the plain version too
on the serving-size forests (both add the trees in order); logreg probabilities within ``1e-6`` of
the plain version (the kernel's ``expf`` and PyTorch's sigmoid differ by
ulps). Engine against engine: amount averages within ``rtol=1e-6`` (the
card's ``index_add_`` adds a day's amounts in any order), probabilities
within ``1e-7`` (forest) and ``1e-6`` (logreg, gbt: a sigmoid of sums that
carry that order), the rest bit-identical. The offline side: a trained
booster's ``predict_proba`` through the leaf-sum kernel equal to the plain
version exactly, Adam on the card within ``atol=1e-5`` of the CPU, and
the feature replay bit for bit on whole-dollar amounts. The sharded
engine (4 and 8 shards co-located on the card): the leaf-sum kernel
inside the sharded step equal to its plain version on the chunk, the
engine against the same shards on the CPU (hot key and full exchange
bucket included), and its two captured signatures replayed against eager
dispatch bit for bit. The tiered store across shards: the stacked
admission on the card equal to the CPU, the sharded exact step,
compaction and promotion free of host syncs, their four captured
signatures replayed against eager dispatch (and the CPU) bit for bit,
and the leaf sum inside the exact step equal to its plain version. The
demo pipeline (``runtime/pipeline.py``) on the card against the CPU
device: the forest, logreg trained on each device, and the forest on 2
shards — counts and flags equal, the stream AUC within 1e-6, and the
path's own kernel the only one launched.
"""

import time

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
    ragged_ensemble,
    synthetic_ensemble,
    to_gemm,
)
from real_time_fraud_detection_system_tpu_torch.models.gbt import (
    synthetic_gbt,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler,
)
from real_time_fraud_detection_system_tpu_torch.ops import forest_kernels as fk
from real_time_fraud_detection_system_tpu_torch.ops import score_kernels as sk
from real_time_fraud_detection_system_tpu_torch.ops import (
    sequence_kernels as sqk,
)
from real_time_fraud_detection_system_tpu_torch.ops.windows import (
    WindowState,
)
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
ATOL_SIGMOID = 1e-6
RTOL_AMOUNT = 1e-6
START = 1_743_465_600


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _state_args(rng, b, dev, nb=40, caps=(2048, 4096), ids=None):
    """Feature-state tables and a batch's slots into them: stamps within
    the last ~45 days (some empty), small counts, cent amounts, fraud sums
    no larger than the counts; slots drawn with repeats from the first
    ``ids`` slots of each table (all of it by default), slot 0 and the
    last slot included."""
    tables, slots = [], []
    for cap, n_ids in zip(caps, ids or caps):
        bd = (20200 - rng.integers(-1, 46, (cap, nb))).astype(np.int32)
        bd[rng.random((cap, nb)) < 0.3] = -1
        cnt = rng.integers(0, 30, (cap, nb)).astype(np.float32)
        amt = (cnt * rng.integers(100, 20000, (cap, nb)) / 100.0)
        frd = np.minimum(rng.integers(0, 3, (cap, nb)), cnt)
        tables.append(WindowState(*(
            torch.as_tensor(np.asarray(a, dt), device=dev)
            for a, dt in ((bd, np.int32), (cnt, np.float32),
                          (amt, np.float32), (frd, np.float32)))))
        slot = rng.integers(0, n_ids, b)
        slot[:2] = (cap - 1, 0)[:b]
        slots.append(torch.as_tensor(slot, dtype=torch.int64, device=dev))
    as_t = lambda a, dt=np.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a, dt), device=dev)
    return dict(
        customer=tables[0], terminal=tables[1],
        cust_slot=slots[0], term_slot=slots[1],
        day=as_t(np.full(b, 20200), np.int32),
        tod_s=as_t(rng.integers(0, 86400, b), np.int32),
        amount=as_t(rng.integers(100, 30000, b) / 100.0),
        scaler_mean=as_t(rng.normal(size=N_FEAT)),
        scaler_scale=as_t(1.0 + rng.random(N_FEAT)))


@pytest.mark.parametrize("rows", [1, 300, 4096])
def test_fused_forest_kernel_matches_plain_version(cuda, rows):
    g = to_gemm(synthetic_ensemble(13, 6, N_FEAT, seed=2, device=cuda),
                N_FEAT)
    args = _state_args(np.random.default_rng(rows), rows, cuda)
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
    args = _state_args(np.random.default_rng(0), 8, cuda)
    with pytest.raises(ValueError, match="day"):
        fk.fused_forest_leaf_sum(tables, **{**args,
                                            "day": args["day"].long()})
    with pytest.raises(ValueError, match="windows"):
        fk.fused_forest_leaf_sum(tables, **args, windows=(1, 2, 3, 4, 5))


@pytest.mark.parametrize("n_trees,max_depth", [(10, 5), (1, 12)])
def test_engine_on_cuda_matches_cpu_engine(cuda, n_trees, max_depth):
    """Both depths take the fused kernel: its block holds only the feature
    tile in shared memory and reads the node tables from device memory,
    so depth does not limit its admission."""
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
        assert eng.tables is not None and eng.leaf_tables is None
        sinks[dev] = MemorySink()
        before = (fk.fused_forest_leaf_sum.launches, fk.leaf_sum.launches)
        stats = eng.run(ReplaySource(txs, START, batch_rows=1000),
                        sinks[dev])
        on_card = stats["batches"] if dev == "cuda" else 0
        assert fk.fused_forest_leaf_sum.launches - before[0] == on_card
        assert fk.leaf_sum.launches == before[1]
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


@pytest.mark.parametrize("rows", [1, 300, 4096])
def test_leaf_sum_kernel_matches_plain_version(cuda, rows):
    g = to_gemm(synthetic_ensemble(13, 6, N_FEAT, seed=4, device=cuda),
                N_FEAT)
    rng = np.random.default_rng(rows)
    x = torch.as_tensor(rng.normal(size=(rows, N_FEAT)).astype(np.float32),
                        device=cuda)
    leaves = []
    for z_mode in ("f32", "bf16", "int8"):
        tables = fk.to_kernel_tables(g, z_mode)
        before = fk.leaf_sum.launches
        leaf = fk.leaf_sum(tables, x)
        torch.cuda.synchronize()
        assert fk.leaf_sum.launches == before + 1
        want = fk.leaf_sum_plain(tables, x)
        torch.testing.assert_close(leaf, want, rtol=0.0, atol=ATOL_LEAF)
        assert torch.equal(leaf / 13 >= 0.5, want / 13 >= 0.5)
        # a row padded to Fp by the caller scores the same
        xp = torch.nn.functional.pad(x, (0, 1))
        assert torch.equal(fk.leaf_sum(tables, xp), leaf)
        leaves.append(leaf)
    assert torch.equal(leaves[0], leaves[1])
    assert torch.equal(leaves[0], leaves[2])


FORESTS = {  # (trees, depth, ragged): the flagship shape, irregular trees
    # of depths 1..8 and 1..12, and complete trees deeper than any the
    # fused kernel was admitted before the descent (depth 10)
    "complete-depth8": (100, 8, False),
    "ragged-depth8": (100, 8, True),
    "ragged-depth12": (100, 12, True),
    "complete-depth11": (10, 11, False),
}


@pytest.mark.parametrize("rows", [300, 65536])
@pytest.mark.parametrize("forest", sorted(FORESTS))
def test_forest_kernels_equal_plain_versions_at_serving_size(cuda, forest,
                                                             rows):
    """Both forest kernels against their plain versions, bit for bit with
    identical decisions, in every z mode; the ragged forests have leaves
    at every depth from 1 to their depth, and trees of different depths
    side by side, so a wrong child link or trip count shows."""
    n_trees, depth, ragged = FORESTS[forest]
    make = ragged_ensemble if ragged else synthetic_ensemble
    g = to_gemm(make(n_trees, depth, N_FEAT, seed=1, device=cuda), N_FEAT)
    rng = np.random.default_rng(rows)
    args = _state_args(rng, rows, cuda)
    x = torch.as_tensor(rng.normal(size=(rows, N_FEAT)).astype(np.float32),
                        device=cuda)
    sums = {"fused": [], "leaf": []}
    for z_mode in ("f32", "bf16", "int8"):
        tables = fk.to_kernel_tables(g, z_mode)
        before = (fk.fused_forest_leaf_sum.launches, fk.leaf_sum.launches)
        leaf, feats = fk.fused_forest_leaf_sum(tables, **args)
        lsum = fk.leaf_sum(tables, x)
        torch.cuda.synchronize()
        assert (fk.fused_forest_leaf_sum.launches,
                fk.leaf_sum.launches) == (before[0] + 1, before[1] + 1)
        pleaf, pfeats = fk.fused_forest_leaf_sum_plain(tables, **args)
        assert torch.equal(feats, pfeats)
        assert torch.equal(leaf, pleaf)
        assert torch.equal(lsum, fk.leaf_sum_plain(tables, x))
        sums["fused"].append(leaf)
        sums["leaf"].append(lsum)
    for got in sums.values():
        assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    share = float((sums["leaf"][0] / n_trees >= 0.5).float().mean())
    assert 0 < share < 1


@pytest.mark.parametrize("rows", [1, 300, 4096])
def test_fused_score_kernel_matches_plain_version(cuda, rows):
    rng = np.random.default_rng(rows)
    args = _state_args(rng, rows, cuda)
    args.update(
        valid=torch.as_tensor(rng.random(rows) < 0.9, device=cuda),
        w=torch.as_tensor(rng.normal(0, 0.3, N_FEAT).astype(np.float32),
                          device=cuda),
        b=torch.tensor(-1.5, device=cuda))
    before = sk.fused_featurize_score.launches
    probs, feats = sk.fused_featurize_score(**args)
    torch.cuda.synchronize()
    assert sk.fused_featurize_score.launches == before + 1
    pprobs, pfeats = sk.fused_featurize_score_plain(**args)
    assert torch.equal(feats, pfeats)
    torch.testing.assert_close(probs, pprobs, rtol=0.0, atol=ATOL_SIGMOID)
    assert torch.equal(probs >= 0.5, pprobs >= 0.5)
    assert bool((probs[~args["valid"]] == 0).all())


def _both_fused(cuda, args, n_trees=13):
    """Both fused kernels on ``args``, each against its plain version:
    features bit-identical, leaf sums bit-identical, probabilities within
    ATOL_SIGMOID; returns the kernels' (features, leaf sums, probs)."""
    g = to_gemm(synthetic_ensemble(n_trees, 6, N_FEAT, seed=2, device=cuda),
                N_FEAT)
    tables = fk.to_kernel_tables(g, "int8")
    rng = np.random.default_rng(9)
    b = args["day"].shape[0]
    sargs = dict(args,
                 valid=torch.as_tensor(rng.random(b) < 0.9, device=cuda),
                 w=torch.as_tensor(rng.normal(0, 0.3, N_FEAT)
                                   .astype(np.float32), device=cuda),
                 b=torch.tensor(-1.5, device=cuda))
    before = (fk.fused_forest_leaf_sum.launches,
              sk.fused_featurize_score.launches)
    leaf, feats = fk.fused_forest_leaf_sum(tables, **args)
    probs, sfeats = sk.fused_featurize_score(**sargs)
    torch.cuda.synchronize()
    assert (fk.fused_forest_leaf_sum.launches,
            sk.fused_featurize_score.launches) == (before[0] + 1,
                                                   before[1] + 1)
    pleaf, pfeats = fk.fused_forest_leaf_sum_plain(tables, **args)
    pprobs, _ = sk.fused_featurize_score_plain(**sargs)
    assert torch.equal(feats, pfeats) and torch.equal(sfeats, pfeats)
    assert torch.equal(leaf, pleaf)
    torch.testing.assert_close(probs, pprobs, rtol=0.0, atol=ATOL_SIGMOID)
    return feats, leaf, probs


@pytest.mark.parametrize("nb", [1, 5, 37, 38, 40, 41])
def test_fused_kernels_read_rows_of_any_nb(cuda, nb):
    """NB = 38 is the 7-day delay + the 30-day window + 1; 1 and 5 fit in
    less than one chunk of the loader, 37 and 41 leave a ragged last chunk
    and runs that start off 8-byte boundaries."""
    _both_fused(cuda, _state_args(np.random.default_rng(nb), 300, cuda,
                                  nb=nb))


@pytest.mark.parametrize("n_ids", [1, 3, 40])
def test_fused_kernels_read_repeated_slots(cuda, n_ids):
    """Rows of a batch that share a slot read the same run: with the same
    day they get the same window features, in both kernels."""
    args = _state_args(np.random.default_rng(n_ids), 4096, cuda,
                     ids=(n_ids, n_ids))
    feats, _, _ = _both_fused(cuda, args)
    key = args["cust_slot"] * 4096 + args["term_slot"]
    first = {}
    for i, k in enumerate(key.tolist()):
        first.setdefault(k, i)
    want = feats[torch.as_tensor([first[k] for k in key.tolist()],
                                 device=cuda)]
    assert torch.equal(feats[:, 3:], want[:, 3:])


def test_new_wrappers_refuse_what_their_kernels_do_not_take(cuda):
    g = to_gemm(synthetic_ensemble(3, 3, N_FEAT, seed=1, device=cuda),
                N_FEAT)
    tables = fk.to_kernel_tables(g, "int8")
    x = torch.zeros((8, N_FEAT), device=cuda)
    with pytest.raises(ValueError, match="^x:"):
        fk.leaf_sum(tables, x.double())
    with pytest.raises(ValueError, match="^x:"):
        fk.leaf_sum(tables, torch.zeros((8, 17), device=cuda))
    with pytest.raises(ValueError, match="^x:"):
        fk.leaf_sum(tables, torch.zeros((16, N_FEAT), device=cuda)[::2])
    # 512 features (no data: a stride-0 view) need a 256 KB feature tile,
    # past the 227 KB a block may have
    one = torch.zeros((1, 1, 1), device=cuda)
    wide = tables._replace(gemm=tables.gemm._replace(
        sel=one.expand(10, 512, 8)))
    with pytest.raises(ValueError, match="shared-memory"):
        fk.leaf_sum(wide, x)
    args = _state_args(np.random.default_rng(0), 8, cuda)
    args.update(valid=torch.ones(8, dtype=torch.bool, device=cuda),
                w=torch.zeros(N_FEAT, device=cuda),
                b=torch.tensor(0.0, device=cuda))
    with pytest.raises(ValueError, match="^valid:"):
        sk.fused_featurize_score(**{**args, "valid": args["valid"].int()})
    with pytest.raises(ValueError, match="^b:"):
        sk.fused_featurize_score(**{**args, "b": args["b"].reshape(1)})
    with pytest.raises(ValueError, match="^w:"):
        sk.fused_featurize_score(**{**args, "w": args["w"][:14]})
    with pytest.raises(ValueError, match="windows"):
        sk.fused_featurize_score(**args, windows=(1, 2, 3, 4, 5))
    with pytest.raises(ValueError, match="^cust_slot:"):
        sk.fused_featurize_score(**{**args,
                                    "cust_slot": args["cust_slot"].int()})
    with pytest.raises(ValueError, match="^term_slot:"):
        fk.fused_forest_leaf_sum(tables, **{
            **{k: v for k, v in args.items() if k not in ("valid", "w", "b")},
            "term_slot": args["term_slot"][:4]})
    bad = args["terminal"]._replace(fraud=args["terminal"].fraud.double())
    with pytest.raises(ValueError, match="^terminal.fraud:"):
        sk.fused_featurize_score(**{**args, "terminal": bad})
    wrong_nb = args["customer"]._replace(
        count=args["customer"].count[:, :39].contiguous())
    with pytest.raises(ValueError, match="^customer.count:"):
        sk.fused_featurize_score(**{**args, "customer": wrong_nb})
    count = args["customer"].count
    shifted = torch.zeros(count.numel() + 1, device=cuda)[1:].view(
        count.shape)  # contiguous, 4 bytes past a 16-byte boundary
    with pytest.raises(ValueError, match="^customer.count: .*aligned"):
        fk.fused_forest_leaf_sum(tables, **{
            **{k: v for k, v in args.items() if k not in ("valid", "w", "b")},
            "customer": args["customer"]._replace(count=shifted)})


@pytest.mark.parametrize("kind", ["logreg", "gbt"])
def test_logreg_and_gbt_engines_on_cuda_match_cpu_engine(cuda, kind):
    cfg = Config(data=DataConfig(n_customers=120, n_terminals=240,
                                 n_days=45, seed=7),
                 features=FeatureConfig(customer_capacity=128,
                                        terminal_capacity=256),
                 runtime=RuntimeConfig(batch_buckets=(256, 1024)))
    _, _, txs = generate_dataset(cfg.data)
    txs = txs.slice(slice(0, 3000))
    rng = np.random.default_rng(5)
    if kind == "logreg":
        params = LogRegParams(
            torch.as_tensor(rng.normal(0, 0.8, N_FEAT).astype(np.float32)),
            torch.tensor(-1.0))
    else:
        params = synthetic_gbt(10, 5, N_FEAT, seed=3, device="cpu")
    probe = ScoringEngine(cfg, kind, params,
                          fit_scaler(np.zeros((2, N_FEAT)), device="cpu"),
                          device="cpu")
    feats = probe.process_batch(
        ReplaySource(txs, START, batch_rows=1024).poll_batch()).features
    counters = (sk.fused_featurize_score, fk.leaf_sum,
                fk.fused_forest_leaf_sum)
    own = 0 if kind == "logreg" else 1
    sinks = {}
    for dev in ("cpu", "cuda"):
        eng = ScoringEngine(cfg, kind, params, fit_scaler(feats, device=dev),
                            device=dev)
        assert eng.tables is None
        assert (eng.leaf_tables is not None) == (kind == "gbt")
        sinks[dev] = MemorySink()
        before = [c.launches for c in counters]
        stats = eng.run(ReplaySource(txs, START, batch_rows=1000),
                        sinks[dev])
        launched = [c.launches - n for c, n in zip(counters, before)]
        want = [0, 0, 0]
        if dev == "cuda":
            want[own] = stats["batches"]
        assert launched == want
    got, want = sinks["cuda"].concat(), sinks["cpu"].concat()
    assert want["prediction"].std() > 0
    for k in want:
        if k == "processed_at_us":
            continue
        if k == "prediction":
            np.testing.assert_allclose(got[k], want[k], rtol=0.0,
                                       atol=ATOL_SIGMOID)
            assert np.array_equal(got[k] >= 0.5, want[k] >= 0.5)
        elif "avg_amount" in k:  # the card's index_add_ adds in any order
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL_AMOUNT)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _whole_dollar_stream(n_rows=6000):
    """A small generated stream whose amounts are whole dollars: float32
    sums of them are exact in any order, so the card's atomic adds give
    the same state on every run and two runs compare bit for bit."""
    cfg = Config(data=DataConfig(n_customers=300, n_terminals=600,
                                 n_days=30, seed=11),
                 features=FeatureConfig(customer_capacity=512,
                                        terminal_capacity=1024),
                 runtime=RuntimeConfig(batch_buckets=(256, 1024)))
    _, _, txs = generate_dataset(cfg.data)
    txs = txs.slice(slice(0, n_rows))
    txs.amount_cents = np.round(txs.amount_cents / 100).astype(np.int64) \
        * 100
    return cfg, txs


@pytest.mark.parametrize("kind", ["forest", "logreg"])
def test_pipeline_depths_equal_depth_one_bit_for_bit_on_cuda(cuda, kind):
    """Depths 2 and 3 keep batches in flight through the pinned staging
    ring (depth + 1 buffers per bucket, reused many times over) and the
    side-stream result copies into pinned blocks; a buffer reused too
    early, or a result that shares memory with a later batch's, would
    change the sink's rows. Coalesced small polls equal the same batches
    polled whole, and blocking result copies (``fetch_overlap`` off) the
    side-stream ones."""
    import dataclasses

    cfg, txs = _whole_dollar_stream()
    rng = np.random.default_rng(2)
    params = (synthetic_ensemble(10, 5, N_FEAT, seed=3, device="cpu")
              if kind == "forest" else
              LogRegParams(torch.as_tensor(rng.normal(0, 0.8, N_FEAT)
                                           .astype(np.float32)),
                           torch.tensor(-1.0)))
    scaler = fit_scaler(rng.normal(5, 3, (64, N_FEAT)), device=cuda)

    def serve(depth, coalesce=0, poll=1000, overlap=True):
        rcfg = dataclasses.replace(cfg.runtime, pipeline_depth=depth,
                                   coalesce_rows=coalesce,
                                   fetch_overlap=overlap)
        eng = ScoringEngine(dataclasses.replace(cfg, runtime=rcfg), kind,
                            params, scaler, device=cuda)
        sink = MemorySink()
        stats = eng.run(ReplaySource(txs, START, batch_rows=poll), sink)
        assert stats["pipeline_depth"] == depth
        assert stats["rows"] == txs.n
        out = sink.concat()
        out.pop("processed_at_us")
        return out, [len(b["tx_id"]) for b in sink.batches]

    base, sizes = serve(1)
    assert base["prediction"].std() > 0
    for depth, coalesce, poll, overlap in ((2, 0, 1000, True),
                                           (3, 0, 1000, True),
                                           (2, 1000, 250, True),
                                           (2, 0, 1000, False)):
        got, got_sizes = serve(depth, coalesce, poll, overlap)
        assert got_sizes == sizes
        for k in base:
            np.testing.assert_array_equal(got[k], base[k],
                                          err_msg=f"{k} at depth {depth}")


@pytest.mark.parametrize("features,kind", [
    ({"key_mode": "hash"}, "forest"), ({"key_mode": "hash"}, "logreg"),
    ({"key_mode": "hash"}, "gbt"), ({"customer_source": "cms"}, "forest"),
    ({"customer_source": "cms"}, "gbt"),
    ({"customer_source": "cms"}, "logreg")])
def test_hash_and_sketch_engines_on_cuda_match_cpu_engine(cuda, features,
                                                          kind):
    """Hash keys take each kind's fused kernel; the customer sketch serves
    the tree kinds through the leaf-sum kernel and logreg through its
    plain predict. Whole-dollar amounts: the sketch's and the tables'
    sums are exact in any order, so every column is bit-identical but the
    probabilities (the kernels' sigmoid and the trees' order, 1e-6)."""
    import dataclasses

    cfg, txs = _whole_dollar_stream(3000)
    cfg = dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, cms_width=1 << 10, **features))
    rng = np.random.default_rng(4)
    params = {
        "forest": synthetic_ensemble(10, 5, N_FEAT, seed=3, device="cpu"),
        "gbt": synthetic_gbt(10, 5, N_FEAT, seed=3, device="cpu"),
        "logreg": LogRegParams(torch.as_tensor(
            rng.normal(0, 0.8, N_FEAT).astype(np.float32)),
            torch.tensor(-1.0)),
    }[kind]
    scaler = rng.normal(5, 3, (64, N_FEAT))
    sinks, launched = {}, {}
    for dev in ("cpu", "cuda"):
        eng = ScoringEngine(cfg, kind, params, fit_scaler(scaler, device=dev),
                            device=dev)
        sinks[dev] = MemorySink()
        before = {f: f.launches for f in (fk.fused_forest_leaf_sum,
                                          fk.leaf_sum,
                                          sk.fused_featurize_score)}
        stats = eng.run(ReplaySource(txs, START, batch_rows=1000),
                        sinks[dev])
        launched[dev] = {f.__name__: f.launches - n
                         for f, n in before.items()}
    sketch = features.get("customer_source") == "cms"
    own = {"forest": "leaf_sum" if sketch else "fused_forest_leaf_sum",
           "gbt": "leaf_sum",
           "logreg": None if sketch else "fused_featurize_score"}[kind]
    assert launched["cpu"] == {k: 0 for k in launched["cpu"]}
    assert launched["cuda"] == {k: stats["batches"] if k == own else 0
                                for k in launched["cuda"]}
    got, want = sinks["cuda"].concat(), sinks["cpu"].concat()
    for k in want:
        if k == "processed_at_us":
            continue
        if k == "prediction":
            np.testing.assert_allclose(got[k], want[k], rtol=0.0,
                                       atol=ATOL_SIGMOID)
            assert np.array_equal(got[k] >= 0.5, want[k] >= 0.5)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


class _IndexedSink:
    """Results by ``batch_index``: a replay overwrites its entry (the card
    machine has no pyarrow for the Parquet sink)."""

    def __init__(self):
        self.batches = {}

    def append(self, res):
        self.batches[res.batch_index] = (res.tx_id.copy(), res.probs.copy(),
                                         res.features.copy())

    def truncate_after(self, batch_index):
        for i in [i for i in self.batches if i > batch_index]:
            del self.batches[i]


def _recovery_models(kind):
    rng = np.random.default_rng(6)
    return {
        "forest": synthetic_ensemble(10, 5, N_FEAT, seed=3, device="cpu"),
        "gbt": synthetic_gbt(10, 5, N_FEAT, seed=3, device="cpu"),
        "logreg": LogRegParams(torch.as_tensor(
            rng.normal(0, 0.8, N_FEAT).astype(np.float32)),
            torch.tensor(-1.0)),
    }[kind]


@pytest.mark.parametrize("kind,features", [
    ("forest", {}), ("gbt", {}), ("logreg", {}),
    ("forest", {"customer_source": "cms"})])
def test_restore_on_cuda_equals_restore_on_cpu(cuda, tmp_path, kind,
                                               features):
    """A checkpoint the CPU engine wrote restores on the card bit for bit,
    into the card engine's own tensors (same addresses, on the card), and
    the card engine then serves what the CPU engine restored from it
    serves; the card's own checkpoint restores on the CPU bit for bit."""
    import dataclasses

    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import Checkpointer
    from real_time_fraud_detection_system_tpu_torch.utils.tree import leaves_with_path as _leaves

    cfg, txs = _whole_dollar_stream(4000)
    cfg = dataclasses.replace(
        cfg, features=dataclasses.replace(cfg.features, cms_width=1 << 10,
                                          **features),
        runtime=dataclasses.replace(cfg.runtime, checkpoint_every_batches=2))
    params = _recovery_models(kind)
    scaler = np.random.default_rng(4).normal(5, 3, (64, N_FEAT))

    def engine(dev):
        return ScoringEngine(cfg, kind, params, fit_scaler(scaler, dev),
                             device=dev)

    def leaves(state):
        return [(p, t) for tree in (state.feature_state, state.params,
                                    state.scaler)
                for p, t in _leaves(tree)]

    for writer, reader in (("cpu", "cuda"), ("cuda", "cpu")):
        ckpt = Checkpointer(str(tmp_path / writer))
        w = engine(writer)
        w.run(ReplaySource(txs, START, batch_rows=1000), checkpointer=ckpt,
              max_batches=2)
        for dev in (reader, writer):
            r = engine(dev)
            ptrs = [t.data_ptr() for _, t in leaves(r.state)
                    if isinstance(t, torch.Tensor)]
            assert ckpt.restore(r.state) is not None
            assert [t.data_ptr() for _, t in leaves(r.state)
                    if isinstance(t, torch.Tensor)] == ptrs
            for (path, got), (_, want) in zip(leaves(r.state),
                                              leaves(w.state)):
                if isinstance(got, torch.Tensor):
                    assert got.device.type == dev, path
                    assert torch.equal(got.cpu(), want.cpu()), path
                else:
                    assert got == want, path
        outs = {}
        for dev in ("cpu", "cuda"):
            r = engine(dev)
            ckpt.restore(r.state)
            src = ReplaySource(txs, START, batch_rows=1000)
            src.seek(r.state.offsets)
            sink = MemorySink()
            r.run(src, sink)
            outs[dev] = sink.concat()
        for k in outs["cpu"]:
            if k == "processed_at_us":
                continue
            if k == "prediction":
                np.testing.assert_allclose(outs["cuda"][k], outs["cpu"][k],
                                           rtol=0.0, atol=ATOL_SIGMOID)
            else:
                np.testing.assert_array_equal(outs["cuda"][k],
                                              outs["cpu"][k], err_msg=k)


def test_restore_of_other_params_rederives_the_tables_on_cuda(cuda,
                                                              tmp_path):
    """A card engine built with other weights restores a checkpoint: the
    weights land in its own tensors and the next step's kernel descends
    the restored forest (its tables are re-derived)."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )

    cfg, txs = _whole_dollar_stream(3000)
    scaler = fit_scaler(np.random.default_rng(4).normal(5, 3, (64, N_FEAT)),
                        device=cuda)
    p1 = synthetic_ensemble(10, 5, N_FEAT, seed=1, device="cpu")
    p2 = synthetic_ensemble(10, 5, N_FEAT, seed=2, device="cpu")
    ref = ScoringEngine(cfg, "forest", p1, scaler, device=cuda)
    ref_sink = _IndexedSink()
    ref.run(ReplaySource(txs, START, batch_rows=1000), ref_sink)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    first = ScoringEngine(cfg, "forest", p1, scaler, device=cuda)
    first.run(ReplaySource(txs, START, batch_rows=1000), max_batches=1)
    ckpt.save(first.state)
    other = ScoringEngine(cfg, "forest", p2, scaler, device=cuda)
    sel = other.state.params.sel
    ptr = sel.data_ptr()
    ckpt.restore(other.state)
    assert other.state.params.sel is sel and sel.data_ptr() == ptr
    src = ReplaySource(txs, START, batch_rows=1000)
    src.seek(other.state.offsets)
    sink = _IndexedSink()
    before = fk.fused_forest_leaf_sum.launches
    other.run(src, sink)
    assert fk.fused_forest_leaf_sum.launches - before == 2
    assert torch.equal(other.tables.nodes, ref.tables.nodes)
    for i in (2, 3):
        for a, b in zip(sink.batches[i], ref_sink.batches[i]):
            np.testing.assert_array_equal(a, b)


def test_supervised_crash_and_stall_on_cuda_equal_the_clean_run(cuda,
                                                                tmp_path):
    """A crash and a stall under the supervisor on the card: the results
    by batch index and the final feature state equal the uninterrupted
    card run bit for bit (whole-dollar amounts), with one restart of each
    cause; the abandoned incarnation's engine is released once its hang
    ends, and the kernel libraries are loaded once for all the engines."""
    import dataclasses
    import gc
    import threading
    import weakref

    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import Checkpointer
    from real_time_fraud_detection_system_tpu_torch.utils.tree import leaves_with_path as _leaves
    from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
        FlakySource,
        HangingSource,
        run_with_recovery,
    )

    cfg, txs = _whole_dollar_stream(6000)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, checkpoint_every_batches=2))
    params = synthetic_ensemble(10, 5, N_FEAT, seed=3, device="cpu")
    scaler = fit_scaler(np.random.default_rng(4).normal(5, 3, (64, N_FEAT)),
                        device=cuda)
    engines = []

    def make_engine():
        eng = ScoringEngine(cfg, "forest", params, scaler, device=cuda)
        engines.append(weakref.ref(eng))
        return eng

    clean = ScoringEngine(cfg, "forest", params, scaler, device=cuda)
    want = _IndexedSink()
    clean.run(ReplaySource(txs, START, batch_rows=1000), want)
    hang = HangingSource(FlakySource(
        ReplaySource(txs, START, batch_rows=1000), fail_at=(3,)),
        hang_at=(7,), max_hang_s=60.0)
    got = _IndexedSink()
    final = {}

    def keep():
        final["eng"] = make_engine()
        return final["eng"]

    try:
        stats = run_with_recovery(keep, hang,
                                  Checkpointer(str(tmp_path / "ck")),
                                  sink=got, max_restarts=3,
                                  stall_timeout_s=3.0)
    finally:
        hang.release.set()
        for t in threading.enumerate():
            if t.name == "engine-incarnation" \
                    and t is not threading.current_thread():
                t.join(30.0)
                assert not t.is_alive()
    assert stats["restarts"] == 2 and stats["batches"] == 6
    assert sorted(got.batches) == sorted(want.batches)
    for i in want.batches:
        for a, b in zip(got.batches[i], want.batches[i]):
            np.testing.assert_array_equal(a, b)
    for (path, a), (_, b) in zip(_leaves(final["eng"].state.feature_state),
                                 _leaves(clean.state.feature_state)):
        assert a.device.type == "cuda" and torch.equal(a, b), path
    last = final.pop("eng")
    gc.collect()
    assert sum(r() is not None for r in engines) == 1
    del last
    assert fk._library.cache_info().currsize == 1


def test_a_kernel_that_cannot_build_raises_from_the_engine(cuda, tmp_path,
                                                           monkeypatch):
    """A card engine loads its kernels when it is built: with no nvcc
    where the toolkit should be, the constructor raises ``RuntimeError``,
    so the supervisor (which builds engines outside its restarts) raises
    it at once, with no restart counted."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.ops import cuda_lib
    from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
        run_with_recovery,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        get_registry,
    )

    cfg, txs = _whole_dollar_stream(2000)
    params = synthetic_ensemble(10, 5, N_FEAT, seed=3, device="cpu")
    scaler = fit_scaler(np.random.default_rng(4).normal(5, 3, (64, N_FEAT)),
                        device=cuda)
    monkeypatch.setattr(cuda_lib, "_nvcc",
                        lambda: str(tmp_path / "no-cuda" / "bin" / "nvcc"))
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", tmp_path / "build")
    fk._library.cache_clear()
    reg = get_registry()
    before = reg.family_total("rtfds_engine_restarts_total") or 0.0
    try:
        with pytest.raises(RuntimeError, match="cannot build"):
            ScoringEngine(cfg, "forest", params, scaler, device=cuda)
        with pytest.raises(RuntimeError, match="cannot build"):
            run_with_recovery(
                lambda: ScoringEngine(cfg, "forest", params, scaler,
                                      device=cuda),
                ReplaySource(txs, START, batch_rows=1000),
                Checkpointer(str(tmp_path / "ck")), max_restarts=3)
    finally:
        fk._library.cache_clear()
    assert (reg.family_total("rtfds_engine_restarts_total") or 0.0) == before


def _keydir_pair(cuda, dir_cap, slot_cap):
    from real_time_fraud_detection_system_tpu_torch.ops import keydir

    return (keydir.init_keydir(dir_cap, slot_cap, "cpu"),
            keydir.init_keydir(dir_cap, slot_cap, cuda))


def _same_keydir(a, b):
    for name in ("keys", "slots", "free", "free_top"):
        got, want = getattr(b, name).cpu(), getattr(a, name)
        assert got.dtype == want.dtype, name
        assert torch.equal(got.view(torch.int32) if name == "keys" else got,
                           want.view(torch.int32) if name == "keys"
                           else want), name


@pytest.mark.parametrize("n_probes", [1, 8])
def test_admit_slots_on_cuda_equals_cpu_bit_for_bit(cuda, n_probes):
    """The claim rounds (scatter-min through the sign flip), the owner
    pick and the grants in cumsum order run on the card as on the CPU:
    slots, admitted masks and every directory leaf bit for bit, through
    duplicates, uint32 edge keys, probe overflow, free-stack exhaustion
    and reclaims, at a batch the size of the serving bucket."""
    from real_time_fraud_detection_system_tpu_torch.ops import keydir

    rng = np.random.default_rng(n_probes)
    cpu, gpu = _keydir_pair(cuda, 1 << 15, 1 << 14)
    for step in range(6):
        keys = rng.integers(0, 2 ** 32, 65536, dtype=np.uint64).astype(
            np.uint32)
        keys[:30000] = rng.integers(0, 12000, 30000)  # duplicates
        keys[30000:30004] = [2 ** 31 - 1, 2 ** 31, 0xFFFFFFFE, 0xFFFFFFFF]
        valid = rng.random(65536) < 0.95
        tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
        _, cs, ca = keydir.admit_slots(cpu, tk, tv, n_probes)
        _, gs, ga = keydir.admit_slots(gpu, tk.to(cuda), tv.to(cuda),
                                       n_probes)
        assert torch.equal(gs.cpu(), cs) and torch.equal(ga.cpu(), ca)
        _same_keydir(cpu, gpu)
        dead = torch.from_numpy(rng.random(1 << 15) < 0.3)
        _, _, cn = keydir.reclaim_entries(cpu, dead)
        _, _, gn = keydir.reclaim_entries(gpu, dead.to(cuda))
        assert int(gn) == int(cn)
        _same_keydir(cpu, gpu)
    assert int(cpu.free_top) < (1 << 14)


@pytest.mark.parametrize("kind", ["forest", "gbt", "logreg"])
def test_exact_engine_on_cuda_matches_cpu_engine(cuda, kind):
    """``key_mode="exact"`` with a hot tier smaller than the key universe
    (sketch-tier reads), compaction every 2 batches, whole-dollar
    amounts: every column bit for bit but the probabilities (1e-6), the
    directories and window tables bit for bit, and the tree kinds launch
    the leaf-sum kernel once per batch, the fused kernels never."""
    import dataclasses

    cfg, txs = _whole_dollar_stream(4000)
    cfg = dataclasses.replace(cfg, features=dataclasses.replace(
        cfg.features, key_mode="exact", customer_capacity=128,
        terminal_capacity=256, cms_width=1 << 10, compact_every=2))
    rng = np.random.default_rng(4)
    params = {
        "forest": synthetic_ensemble(10, 5, N_FEAT, seed=3, device="cpu"),
        "gbt": synthetic_gbt(10, 5, N_FEAT, seed=3, device="cpu"),
        "logreg": LogRegParams(torch.as_tensor(
            rng.normal(0, 0.8, N_FEAT).astype(np.float32)),
            torch.tensor(-1.0)),
    }[kind]
    scaler = rng.normal(5, 3, (64, N_FEAT))
    sinks, states, launched = {}, {}, {}
    for dev in ("cpu", "cuda"):
        eng = ScoringEngine(cfg, kind, params, fit_scaler(scaler, device=dev),
                            device=dev)
        assert eng.tables is None
        sinks[dev] = MemorySink()
        before = {f: f.launches for f in (fk.fused_forest_leaf_sum,
                                          fk.leaf_sum,
                                          sk.fused_featurize_score)}
        stats = eng.run(ReplaySource(txs, START, batch_rows=1000),
                        sinks[dev])
        launched[dev] = {f.__name__: f.launches - n
                         for f, n in before.items()}
        states[dev] = eng.state.feature_state
    own = None if kind == "logreg" else "leaf_sum"
    assert launched["cuda"] == {k: stats["batches"] if k == own else 0
                                for k in launched["cuda"]}
    got, want = sinks["cuda"].concat(), sinks["cpu"].concat()
    for k in want:
        if k == "processed_at_us":
            continue
        if k == "prediction":
            np.testing.assert_allclose(got[k], want[k], rtol=0.0,
                                       atol=ATOL_SIGMOID)
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    for table in ("customer_dir", "terminal_dir"):
        _same_keydir(getattr(states["cpu"], table),
                     getattr(states["cuda"], table))
    for table in ("customer", "terminal"):
        for name in ("bucket_day", "count", "amount", "fraud"):
            assert torch.equal(getattr(getattr(states["cuda"], table),
                                       name).cpu(),
                               getattr(getattr(states["cpu"], table), name))


def test_cold_tier_on_cuda_equals_cpu(cuda, tmp_path):
    """Demotion, the returning keys' promotion and the next touch on the
    card equal the same flow on the CPU: features, probabilities, the
    counters and every directory leaf."""
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    def cols(cust, term, day):
        cust = np.asarray(cust, np.int64)
        n = len(cust)
        us = (day * 86400 + np.arange(n) % 86400).astype(np.int64) \
            * 1_000_000
        return {"tx_id": np.arange(n, dtype=np.int64), "tx_datetime_us": us,
                "customer_id": cust,
                "terminal_id": np.asarray(term, np.int64),
                "tx_amount_cents": np.full(n, 1200, np.int64),
                "kafka_ts_ms": us // 1000}

    a, b, day = np.arange(0, 48), np.arange(1000, 1032), 20200
    batches = [cols(a, a + 10000, day), cols(a, a + 10000, day),
               cols(b, b + 10000, day + 2), cols(b, b + 10000, day + 3),
               cols(b, b + 10000, day + 4),
               cols(a[:16], a[:16] + 10000, day + 5)]
    params = LogRegParams(torch.linspace(-0.1, 0.1, N_FEAT),
                          torch.tensor(-0.5))
    out = {}
    for dev in ("cpu", "cuda"):
        cfg = Config(features=FeatureConfig(
            customer_capacity=128, terminal_capacity=128, cms_width=1 << 12,
            key_mode="exact", compact_every=2,
            cold_store=str(tmp_path / dev), cold_demote_slots=16,
            cold_highwater=0.25), runtime=RuntimeConfig(batch_buckets=(64,)))
        reg = MetricsRegistry()
        eng = ScoringEngine(cfg, "logreg", params,
                            fit_scaler(np.ones((2, N_FEAT)), device=dev),
                            device=dev, metrics=reg)
        res = [eng.process_batch({k: v.copy() for k, v in c.items()})
               for c in batches]
        assert eng.drain_promotions(timeout_s=30.0)
        res.append(eng.process_batch({k: v.copy() for k, v in
                                      batches[-1].items()}))
        counts = {n: reg.get(n).value for n in (
            "rtfds_feature_cold_demotions_total",
            "rtfds_feature_cold_promotions_total")}
        assert all(v > 0 for v in counts.values())
        out[dev] = (res, counts, eng.state.feature_state)
        eng.fence_cold()
    for r_cpu, r_gpu in zip(out["cpu"][0], out["cuda"][0]):
        np.testing.assert_array_equal(r_gpu.features, r_cpu.features)
        np.testing.assert_allclose(r_gpu.probs, r_cpu.probs, rtol=0.0,
                                   atol=ATOL_SIGMOID)
    assert out["cpu"][1] == out["cuda"][1]
    for table in ("customer_dir", "terminal_dir"):
        _same_keydir(getattr(out["cpu"][2], table),
                     getattr(out["cuda"][2], table))


def test_exact_step_compaction_and_promotion_never_sync_on_cuda(cuda):
    """The exact step (admission, the window and sketch updates, both
    tiers' reads), the direct step's window update, compaction with and
    without demotion, and promotion run under
    ``torch.cuda.set_sync_debug_mode("error")``: no ``.item()``, no
    boolean index, no ``nonzero``, no read-back of a 0-d index."""
    from real_time_fraud_detection_system_tpu_torch.core import batch as cb
    from real_time_fraud_detection_system_tpu_torch.features import online

    fcfg = FeatureConfig(key_mode="exact", customer_capacity=64,
                         terminal_capacity=64, cms_width=1 << 8,
                         cold_highwater=0.25)
    dcfg = FeatureConfig(customer_capacity=512, terminal_capacity=512)
    est = online.init_feature_state(fcfg, cuda)
    dst = online.init_feature_state(dcfg, cuda)
    rng = np.random.default_rng(7)
    batches = []
    for d in range(4):
        packed = cb.pack_batch(cb.make_batch(
            customer_id=rng.integers(0, 300, 1000),
            terminal_id=rng.integers(0, 300, 1000),
            tx_datetime_us=(np.full(1000, 20200 + d, np.int64) * 86400
                            + rng.integers(0, 86400, 1000)) * 1_000_000,
            amount_cents=rng.integers(1, 500, 1000) * 100,
            label=rng.integers(-1, 2, 1000), pad_to=1024))
        batches.append(cb.unpack_batch(torch.from_numpy(packed).to(cuda)))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in batches:
            online.update_and_featurize_exact(est, b, fcfg)
            online.update_and_featurize(dst, b, dcfg)
        online.compact_feature_state(est, 20203, fcfg)
        _, _, payload = online.compact_feature_state(est, 20204, fcfg,
                                                     demote_slots=32)
        _, stats = online.promote_rows(est, payload, fcfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert int(stats[:, 0].sum()) > 0


# -- the learning loop on the card ----------------------------------------

def _labeled_batches(n_batches=4, rows=1000, seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_batches):
        n = rows
        out.append({
            "tx_id": np.arange(d * n, (d + 1) * n, dtype=np.int64),
            "tx_datetime_us": (np.full(n, 20200 + 3 * d, np.int64) * 86400
                               + rng.integers(0, 86400, n)) * 1_000_000,
            "customer_id": rng.integers(0, 300, n).astype(np.int64),
            "terminal_id": rng.integers(0, 300, n).astype(np.int64),
            "tx_amount_cents": (rng.integers(1, 500, n) * 100)
            .astype(np.int64),
            "kafka_ts_ms": np.zeros(n, np.int64),
            "label": rng.integers(-1, 2, n).astype(np.int32)})
    return out


def _learning_cfg(**features):
    return Config(features=FeatureConfig(customer_capacity=512,
                                         terminal_capacity=512,
                                         cms_width=1 << 10, **features),
                  runtime=RuntimeConfig(batch_buckets=(1024,)))


def _logreg_model(dev):
    rng = np.random.default_rng(9)
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )

    return (LogRegParams(torch.tensor(rng.normal(0, 0.3, 15)
                                      .astype(np.float32), device=dev),
                         torch.tensor(-1.0, device=dev)),
            Scaler(torch.zeros(15, device=dev),
                   torch.full((15,), 50.0, device=dev)))


def test_in_step_sgd_on_cuda_is_in_place_sync_free_and_equals_cpu(cuda):
    """The fused logreg kernel serves while the in-step SGD rewrites ``w``
    and ``b`` in place: the same tensors (``data_ptr``) after every batch,
    the update itself under ``set_sync_debug_mode("error")``, and params
    and probabilities equal a CPU engine's (params within ``atol=2e-6``,
    probabilities ``1e-6``: the gradient's sums in another order)."""
    from real_time_fraud_detection_system_tpu_torch.core import batch as cb

    cfg = _learning_cfg()
    batches = _labeled_batches()
    out = {}
    for dev in ("cpu", cuda):
        params, scaler = _logreg_model(dev)
        eng = ScoringEngine(cfg, "logreg", params, scaler, device=dev,
                            online_lr=0.05)
        ptr = eng.state.params.w.data_ptr()
        before = sk.fused_featurize_score.launches
        res = [eng.process_batch(dict(c)) for c in batches]
        assert eng.state.params.w.data_ptr() == ptr
        out[str(dev)] = (res, eng, sk.fused_featurize_score.launches - before)
    cpu, gpu = out["cpu"], out[str(cuda)]
    assert gpu[2] == len(batches) and cpu[2] == 0
    for a, b in zip(cpu[1].state.params, gpu[1].state.params):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=2e-6)
    for rc, rg in zip(cpu[0], gpu[0]):
        np.testing.assert_allclose(rg.probs, rc.probs, atol=ATOL_SIGMOID)
    eng = gpu[1]
    packed = cb.pack_batch(cb.make_batch(
        customer_id=batches[0]["customer_id"],
        terminal_id=batches[0]["terminal_id"],
        tx_datetime_us=batches[0]["tx_datetime_us"],
        amount_cents=batches[0]["tx_amount_cents"],
        label=batches[0]["label"], pad_to=1024))
    batch = cb.unpack_batch(torch.from_numpy(packed).to(cuda))
    x = torch.randn(1024, 15, device=cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eng._online_sgd(batch, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def test_swap_on_cuda_copies_in_place_and_rederives_the_tables(cuda):
    cfg = _learning_cfg()
    params, scaler = _logreg_model(cuda)
    eng = ScoringEngine(cfg, "forest", synthetic_ensemble(8, 4, 15, seed=1,
                                                          device=cuda),
                        scaler, device=cuda)
    eng.process_batch(dict(_labeled_batches(1)[0]))
    tables, epoch = eng.tables, eng.state.params_epoch
    leaf = eng.state.params.leaf_val
    eng.swap_params(synthetic_ensemble(8, 4, 15, seed=2, device=cuda))
    assert eng.state.params_epoch == epoch + 1
    assert eng.state.params.leaf_val is leaf  # the same form: in place
    assert eng.state.params_crcs is None
    nodes = tables.nodes.clone()
    res = eng.process_batch(dict(_labeled_batches(2)[1]))
    # re-derived from the new params, into the same tensors (the graphs
    # of a precompiled engine read them by pointer)
    assert eng.tables is tables
    assert not torch.equal(eng.tables.nodes, nodes)
    ref = ScoringEngine(cfg, "forest", synthetic_ensemble(
        8, 4, 15, seed=2, device=cuda), scaler, device=cuda)
    ref.process_batch(dict(_labeled_batches(1)[0]))
    want = ref.process_batch(dict(_labeled_batches(2)[1]))
    np.testing.assert_array_equal(res.probs, want.probs)


@pytest.mark.parametrize("mode", ["direct", "exact"])
def test_feedback_scatters_on_cuda_equal_cpu(cuda, mode):
    """``apply_state_feedback`` on the card lands the same labels as on
    the CPU, bit for bit (0/1 adds are exact in any order); in exact mode
    the hits in the dense rows and the misses in the sketch's fraud
    column, the directory untouched."""
    features = {"key_mode": mode}
    if mode == "exact":
        features.update(customer_capacity=64, terminal_capacity=64)
    cfg = Config(features=FeatureConfig(**{
        "customer_capacity": 512, "terminal_capacity": 512,
        "cms_width": 1 << 10, **features}),
        runtime=RuntimeConfig(batch_buckets=(1024,)))
    batches = _labeled_batches()
    rng = np.random.default_rng(5)
    picks = [rng.integers(0, 4000, 1500) for _ in range(3)]
    out = {}
    for dev in ("cpu", cuda):
        params, scaler = _logreg_model(dev)
        eng = ScoringEngine(cfg, "logreg", params, scaler, device=dev)
        for c in batches:
            eng.process_batch({k: v for k, v in c.items() if k != "label"})
        keys = np.array(eng.state.feature_state.terminal_dir.keys.cpu()) \
            if mode == "exact" else None
        for idx in picks:
            term = np.concatenate([c["terminal_id"] for c in batches])[idx]
            day = (np.concatenate([c["tx_datetime_us"] for c in batches])
                   [idx] // (86400 * 1_000_000)).astype(np.int32)
            eng.apply_state_feedback(term, day, (idx % 3 == 0).astype(
                np.int32) - (idx % 11 == 0))
        fs = eng.state.feature_state
        out[str(dev)] = (fs, keys)
    cpu, gpu = out["cpu"], out[str(cuda)]
    for name in ("fraud", "count", "bucket_day"):
        np.testing.assert_array_equal(
            getattr(gpu[0].terminal, name).cpu().numpy(),
            getattr(cpu[0].terminal, name).numpy(), err_msg=name)
    assert float(cpu[0].terminal.fraud.sum()) > 0
    if mode == "exact":
        np.testing.assert_array_equal(
            gpu[0].terminal_cms.fraud.cpu().numpy(),
            cpu[0].terminal_cms.fraud.numpy())
        assert float(cpu[0].terminal_cms.fraud.sum()) > 0
        np.testing.assert_array_equal(
            gpu[0].terminal_dir.keys.cpu().numpy(), gpu[1])


def test_shadow_and_learner_on_cuda(cuda, tmp_path):
    """A forest candidate dual-scores through the leaf-sum kernel (one
    launch per batch, equal to its plain version), and the streaming
    learner trains its own copy on its own stream: the engine's tensors
    untouched, its candidate equal to a CPU learner's."""
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        predict_proba,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
        ShadowScorer,
        StreamingLearner,
    )

    cfg = _learning_cfg()
    shadow = ShadowScorer("forest", cfg, capacity=1 << 12, device=cuda)
    ens = synthetic_ensemble(100, 8, 15, seed=4, device="cpu")
    params, scaler = _logreg_model("cpu")
    shadow.set_candidate(2, ens, scaler)
    x = np.random.default_rng(0).normal(0, 50, (1000, 15)).astype(
        np.float32)
    before = fk.leaf_sum.launches
    shadow.score_batch(np.arange(1000), x, np.zeros(1000, np.float32))
    assert fk.leaf_sum.launches - before == 1
    want = predict_proba(to_gemm(ens, 15), transform(
        scaler, torch.from_numpy(x)), "f32").numpy()
    np.testing.assert_allclose(shadow._cand_p[:1000], want, atol=ATOL_LEAF)
    feats = np.random.default_rng(1).normal(size=(512, 15)).astype(
        np.float32)
    y = (feats[:, 0] > 0).astype(np.int32)
    got = {}
    for dev in ("cpu", cuda):
        p, s = _logreg_model(dev)
        learner = StreamingLearner("logreg", p, s, cfg, make_model_registry(
            str(tmp_path / str(dev).replace(":", ""))),
            publish_every_labels=256, device=dev)
        learner.submit(feats, y)
        assert learner.drain(60.0)
        assert learner.take_published() == 1
        assert torch.equal(p.w, _logreg_model(dev)[0].w)  # never written
        got[str(dev)] = learner._params
        learner.close()
    for a, b in zip(got["cpu"], got[str(cuda)]):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=2e-6)


# -- the rest of the model zoo: mlp, autoencoder, sequence ---------------

def _zoo_model(kind, dev):
    """Seeded mlp / autoencoder weights and a standardizing scaler for
    ``_labeled_batches`` (amounts in dollars up to 500, counts in tens)."""
    from real_time_fraud_detection_system_tpu_torch.models.autoencoder \
        import init_autoencoder
    from real_time_fraud_detection_system_tpu_torch.models.mlp import (
        init_mlp,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )

    params = (init_mlp(15, (64, 32), seed=5, device=dev) if kind == "mlp"
              else init_autoencoder(15, (32, 8), seed=5, device=dev))
    scale = torch.tensor([150, 1, 1, 2, 150, 5, 150, 8, 150, 2, 1, 4, 1, 8,
                          1], dtype=torch.float32, device=dev)
    return params, Scaler(torch.zeros(15, device=dev), scale)


@pytest.mark.parametrize("kind", ["mlp", "autoencoder"])
@pytest.mark.parametrize("lr", [0.0, 0.05])
def test_zoo_engines_on_cuda_match_cpu_engine(cuda, kind, lr):
    """The unfused step (no kernel launches) with the in-step SGD: params
    written in place, the update sync-free, params within ``atol=1e-6``
    and probabilities ``1e-5`` of a CPU engine (products in another order,
    as against the JAX package in ``tests/test_torch_zoo.py``)."""
    from real_time_fraud_detection_system_tpu_torch.core import batch as cb
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    cfg = _learning_cfg()
    batches = _labeled_batches()
    out = {}
    counters = (sk.fused_featurize_score, fk.leaf_sum,
                fk.fused_forest_leaf_sum)
    for dev in ("cpu", cuda):
        params, scaler = _zoo_model(kind, dev)
        eng = ScoringEngine(cfg, kind, params, scaler, device=dev,
                            online_lr=lr)
        ptrs = [t.data_ptr() for t in tree.leaves(eng.state.params)]
        before = [c.launches for c in counters]
        res = [eng.process_batch(dict(c)) for c in batches]
        assert [c.launches for c in counters] == before
        assert [t.data_ptr() for t in tree.leaves(eng.state.params)] == ptrs
        out[str(dev)] = (res, eng)
    (rc, ec), (rg, eg) = out["cpu"], out[str(cuda)]
    for a, b in zip(tree.leaves(ec.state.params),
                    tree.leaves(eg.state.params)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), atol=1e-6)
    for a, b in zip(rc, rg):
        np.testing.assert_array_equal(b.features, a.features)
        np.testing.assert_allclose(b.probs, a.probs, atol=1e-5)
    if lr > 0:
        packed = cb.pack_batch(cb.make_batch(
            customer_id=batches[0]["customer_id"],
            terminal_id=batches[0]["terminal_id"],
            tx_datetime_us=batches[0]["tx_datetime_us"],
            amount_cents=batches[0]["tx_amount_cents"],
            label=batches[0]["label"], pad_to=1024))
        batch = cb.unpack_batch(torch.from_numpy(packed).to(cuda))
        x = torch.randn(1024, 15, device=cuda)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eg._online_sgd(batch, x)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("k,block", [(8, 128), (40, 16)])
def test_sequence_engine_on_cuda_matches_cpu_engine(cuda, k, block):
    """The history state and the transformer on the card against a CPU
    engine: ``pos``, ``count`` and ``last_t`` equal on rows ``[:C]`` (row
    ``C`` is the sink, written in no fixed order), events within
    ``atol=1e-6``, probabilities ``1e-5``; the step never syncs. Naive
    attention (K=8) scores every row through the fused kernel, blockwise
    (K=40 over blocks of 16) every row through the plain forward, as the
    engine's ``SEQUENCE_ROWS`` counter by path counts them."""
    from real_time_fraud_detection_system_tpu_torch.core import batch as cb
    from real_time_fraud_detection_system_tpu_torch.features.history import (
        update_and_score,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
    )

    cfg = Config(features=FeatureConfig(customer_capacity=256,
                                        terminal_capacity=256,
                                        history_len=k, seq_attn_block=block),
                 runtime=RuntimeConfig(batch_buckets=(1024,)))
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        SEQUENCE_ROWS,
    )
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    batches = _labeled_batches(n_batches=4)
    out = {}
    for dev in ("cpu", cuda):
        params = init_transformer(d_model=32, n_heads=2, n_layers=2,
                                  d_ff=64, seed=2, device=dev)
        eng = ScoringEngine(cfg, "sequence", params,
                            Scaler(torch.zeros(15, device=dev),
                                   torch.ones(15, device=dev)), device=dev,
                            metrics=MetricsRegistry())
        out[str(dev)] = ([eng.process_batch(dict(c)) for c in batches], eng)
    (rc, ec), (rg, eg) = out["cpu"], out[str(cuda)]
    path = "fused" if block >= k else "plain"
    rows = sum(len(c["tx_id"]) for c in batches)
    for p in ("fused", "plain"):
        series = eg.metrics.get(SEQUENCE_ROWS, path=p)
        assert series.value == (rows if p == path else 0), p
    for a, b in zip(rc, rg):
        np.testing.assert_allclose(b.probs, a.probs, atol=1e-5)
        assert not b.features.any()
    assert np.concatenate([r.probs for r in rc]).std() > 0
    hc, hg = ec.state.feature_state, eg.state.feature_state
    for name in ("pos", "count", "last_t"):
        np.testing.assert_array_equal(getattr(hg, name).cpu().numpy()[:-1],
                                      getattr(hc, name).numpy()[:-1])
    np.testing.assert_allclose(hg.events.cpu().numpy()[:-1],
                               hc.events.numpy()[:-1], atol=1e-6)
    packed = cb.pack_batch(cb.make_batch(
        customer_id=batches[0]["customer_id"],
        terminal_id=batches[0]["terminal_id"],
        tx_datetime_us=batches[0]["tx_datetime_us"] + 400 * 86_400_000_000,
        amount_cents=batches[0]["tx_amount_cents"], pad_to=1024))
    batch = cb.unpack_batch(torch.from_numpy(packed).to(cuda))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        update_and_score(hg, eg.state.params, batch, cfg.features)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# -- the precompiled step: one CUDA graph per dispatch signature ------------

class _Batches:
    """A source over fixed column batches (copies, so a run never
    mutates them)."""

    def __init__(self, batches):
        self._batches = batches
        self._i = 0

    def poll_batch(self):
        if self._i == len(self._batches):
            return None
        self._i += 1
        return {k: v.copy() for k, v in self._batches[self._i - 1].items()}

    @property
    def offsets(self):
        return [self._i]


# case -> (kind, features, online_lr, the kernel each batch launches)
GRAPH_CASES = {
    "forest": ("forest", {}, 0.0, "fused_forest_leaf_sum"),
    "logreg": ("logreg", {}, 0.0, "fused_featurize_score"),
    "logreg-sgd": ("logreg", {}, 0.05, "fused_featurize_score"),
    "gbt": ("gbt", {}, 0.0, "leaf_sum"),
    "cms-forest": ("forest", {"customer_source": "cms"}, 0.0, "leaf_sum"),
    "exact-forest": ("forest", {"key_mode": "exact", "compact_every": 2},
                     0.0, "leaf_sum"),
    "mlp-sgd": ("mlp", {}, 0.05, None),
    "autoencoder": ("autoencoder", {}, 0.0, None),
    "sequence": ("sequence", {}, 0.0, "fused_last_logit"),
}


def _wrappers():
    return {"fused_forest_leaf_sum": fk.fused_forest_leaf_sum,
            "leaf_sum": fk.leaf_sum,
            "fused_featurize_score": sk.fused_featurize_score,
            "fused_last_logit": sqk.fused_last_logit}


def _graph_model(kind, dev):
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
    )

    _, scaler = _logreg_model(dev)
    if kind == "forest":
        return synthetic_ensemble(10, 5, N_FEAT, seed=3, device=dev), scaler
    if kind == "gbt":
        return synthetic_gbt(20, 4, N_FEAT, seed=3, device=dev), scaler
    if kind == "logreg":
        return _logreg_model(dev)
    if kind == "sequence":
        return init_transformer(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                                seed=2, device=dev), scaler
    return _zoo_model(kind, dev)


def _state_leaves(eng):
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    out = []
    for t in (eng.state.feature_state, eng.state.params):
        for path, leaf in tree.leaves_with_path(t):
            if isinstance(leaf, torch.Tensor):
                # a history state's row C is a sink written in no fixed
                # order: rows [:C] only
                if eng.kind == "sequence" and t is eng.state.feature_state:
                    leaf = leaf[:-1]
                out.append((path, leaf.clone()))
    return out


def _serve_graphs(cuda, case, depth, precompile, batches, **runtime):
    import dataclasses

    kind, features, lr, _ = GRAPH_CASES[case]
    cfg = Config(features=FeatureConfig(customer_capacity=512,
                                        terminal_capacity=512,
                                        cms_width=1 << 10, **features),
                 runtime=RuntimeConfig(batch_buckets=(256, 1024),
                                       pipeline_depth=depth))
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, **runtime))
    params, scaler = _graph_model(kind, cuda)
    eng = ScoringEngine(cfg, kind, params, scaler, device=cuda,
                        online_lr=lr)
    first = eng.process_batch(dict(batches[0]))
    manifest = None
    if precompile:
        before = _state_leaves(eng)
        counters = (eng.state.batches_done, eng.state.rows_done,
                    eng.state.params_epoch)
        manifest = eng.precompile()
        torch.cuda.synchronize()
        # precompile changes no state: its warmup ran on scratch copies
        for (p, a), (_, b) in zip(before, _state_leaves(eng)):
            assert torch.equal(a, b), p
        assert counters == (eng.state.batches_done, eng.state.rows_done,
                            eng.state.params_epoch)
    launches0 = {n: w.launches for n, w in _wrappers().items()}
    sink = []

    class _Sink:
        def append(self, res):
            sink.append(res)

    eng.run(_Batches(batches[1:]), _Sink())
    torch.cuda.synchronize()
    launches = {n: w.launches - launches0[n]
                for n, w in _wrappers().items()}
    return eng, [first] + sink, launches, manifest


def _graph_batches():
    # five 1,000-row batches (bucket 1024) and a 200-row one (bucket 256)
    batches = _labeled_batches(n_batches=6)
    batches[3] = {k: v[:200] for k, v in batches[3].items()}
    return batches


@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_graph_replay_equals_eager_bit_for_bit(cuda, case, depth):
    """Every kind's step captured (the fused kernels, the in-step SGD's
    autograd, the leaf sum, the exact path and its compaction, the mlp,
    the autoencoder, the sequence step's sorts) and replayed at depths
    1, 2 and 3: outputs and state bit-identical to eager dispatch on
    whole-dollar data, precompile leaving the state alone, no recapture,
    and each kernel counted once per batch at replay."""
    batches = _graph_batches()
    eager, want, lw, _ = _serve_graphs(cuda, case, depth, False, batches)
    graphs, got, lg, man = _serve_graphs(cuda, case, depth, True, batches)
    inv = graphs.dispatch_inventory()
    assert man["graphs"] == len(inv) == len(graphs._graphs)
    assert man["pool_bytes"] is None or man["pool_bytes"] > 0
    reg = graphs.metrics
    assert graphs._captures.recaptures == 0
    assert reg.get("cuda_graph_captures_total").value >= len(inv)
    assert len(got) == len(want) == len(batches)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.probs, a.probs)
        np.testing.assert_array_equal(b.features, a.features)
    for (p, a), (_, b) in zip(_state_leaves(eager), _state_leaves(graphs)):
        assert torch.equal(a, b), p
    own = GRAPH_CASES[case][3]
    n = len(batches) - 1
    for name in lw:
        assert lg[name] == lw[name] == (n if name == own else 0), name


def test_device_memory_gauges_read_the_allocator_on_cuda(cuda):
    """The engine's ``rtfds_device_memory_bytes`` gauges hold the caching
    allocator's bytes in use and its peak, sampled on their cadence."""
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    cfg = Config(features=FeatureConfig(customer_capacity=512,
                                        terminal_capacity=512),
                 runtime=RuntimeConfig(batch_buckets=(1024,)))
    params, scaler = _graph_model("forest", cuda)
    reg = MetricsRegistry()
    eng = ScoringEngine(cfg, "forest", params, scaler, device=cuda,
                        metrics=reg)
    batches = _labeled_batches(n_batches=eng._devmem.EVERY + 1)
    eng.run(_Batches(batches))
    assert eng._devmem.samples == 2
    idx = str(torch.device(cuda).index or 0)
    in_use = reg.get("rtfds_device_memory_bytes", device=idx,
                     kind="in_use").value
    peak = reg.get("rtfds_device_memory_bytes", device=idx,
                   kind="peak").value
    assert 0 < in_use <= peak <= torch.cuda.max_memory_allocated(cuda)


def test_recapture_with_the_learner_training_beside_it(cuda, tmp_path):
    """A swap to mlp params of other widths recaptures every graph in the
    middle of a run while the streaming learner trains on its own stream
    on another thread: the capture holds the learner idle, both go on,
    and the recaptured graphs serve what an eager engine serves."""
    import threading

    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
    )
    from real_time_fraud_detection_system_tpu_torch.io.registry import (
        make_model_registry,
    )
    from real_time_fraud_detection_system_tpu_torch.models.mlp import (
        init_mlp,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.learner import (
        LearningLoop,
        StreamingLearner,
    )

    batches = _labeled_batches(n_batches=6)
    wide = init_mlp(15, (128, 64), seed=6, device=cuda)
    out = {}
    for precompile in (False, True):
        cfg = Config(features=FeatureConfig(customer_capacity=512,
                                            terminal_capacity=512),
                     runtime=RuntimeConfig(batch_buckets=(1024,),
                                           precompile=precompile))
        params, scaler = _zoo_model("mlp", cuda)
        eng = ScoringEngine(cfg, "mlp", params, scaler, device=cuda)
        learner = StreamingLearner(
            "mlp", params, scaler, cfg,
            make_model_registry(str(tmp_path / f"l{precompile}")),
            publish_every_labels=1 << 30, window_rows=4096, device=cuda)
        learning = LearningLoop(
            make_model_registry(str(tmp_path / f"r{precompile}")), cfg,
            "mlp", model=TrainedModel(kind="mlp", scaler=scaler,
                                      params=params),
            learner=learner, device=cuda)
        rng = np.random.default_rng(0)
        x = rng.normal(0, 50, (4096, 15)).astype(np.float32)
        y = rng.integers(0, 2, 4096).astype(np.int32)
        stop = threading.Event()
        errors = []

        def feed():
            # submit re-raises (and clears) a worker failure: keep it
            try:
                while not stop.is_set():
                    learner.submit(x, y)
                    time.sleep(0.001)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        sink = []

        class _Sink:
            def append(self, res):
                sink.append(res)

        try:
            eng.run(_Batches(batches[:3]), _Sink(), learning=learning)
            eng.swap_params(wide)
            eng.run(_Batches(batches[3:]), _Sink(), learning=learning)
            torch.cuda.synchronize()
        finally:
            stop.set()
            feeder.join()
            assert learner.drain(60.0)
            learning.close()
        assert errors == [] and learner.labels_total > 0
        out[precompile] = (sink, eng)
    (se, ee), (sg, eg) = out[False], out[True]
    assert eg._captures.recaptures == len(eg.dispatch_inventory())
    for a, b in zip(se, sg):
        np.testing.assert_array_equal(b.probs, a.probs)
        np.testing.assert_array_equal(b.features, a.features)


@pytest.mark.parametrize("runtime", [
    dict(emit_threshold=0.3, emit_cap_fraction=0.5),
    dict(emit_threshold=1e-6, emit_cap_fraction=0.001),
    dict(emit_dtype="bfloat16"),
    dict(emit_features=False),
], ids=["selective", "selective-overflow", "bf16", "alerts-only"])
def test_graph_emission_modes_equal_eager(cuda, runtime):
    batches = _graph_batches()
    _, want, _, _ = _serve_graphs(cuda, "forest", 2, False, batches,
                                  **runtime)
    eng, got, _, _ = _serve_graphs(cuda, "forest", 2, True, batches,
                                   **runtime)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.probs, a.probs)
        np.testing.assert_array_equal(b.features, a.features)
    if "emit_cap_fraction" in runtime and runtime["emit_cap_fraction"] < 0.1:
        assert eng.selective_overflows > 0


def test_no_recapture_across_buckets_compaction_and_a_swap(cuda, tmp_path):
    """Every bucket and the compaction and promotion passes replay their
    graphs; a swap to params of the same form copies them in place (no
    recapture); another form recaptures every signature once, counted."""
    kind, features, _, _ = GRAPH_CASES["exact-forest"]
    cfg = Config(features=FeatureConfig(
        customer_capacity=64, terminal_capacity=64, cms_width=1 << 8,
        key_mode="exact", compact_every=2, cold_store=str(tmp_path / "c"),
        cold_demote_slots=16, cold_highwater=0.25),
        runtime=RuntimeConfig(batch_buckets=(256, 1024, 4096),
                              precompile=True))
    params, scaler = _graph_model("forest", cuda)
    eng = ScoringEngine(cfg, "forest", params, scaler, device=cuda)
    rng = np.random.default_rng(1)
    batches = []
    for i, n in enumerate((100, 900, 3000, 200, 1000, 4000)):
        b = _labeled_batches(1, rows=n, seed=i)[0]
        b["tx_datetime_us"] = b["tx_datetime_us"] + i * 86_400_000_000
        b["customer_id"] = rng.integers(0, 2000, n).astype(np.int64)
        batches.append(b)
    eng.run(_Batches(batches))
    keys = {s.key for s in eng.dispatch_inventory()}
    assert keys == set(eng._graphs) and ("promote",) in keys
    assert eng._captures.recaptures == 0
    captures = eng._captures.captures
    eng.swap_params(synthetic_ensemble(10, 5, N_FEAT, seed=4, device=cuda))
    eng.run(_Batches(batches[:2]))
    assert eng._captures.captures == captures
    eng.swap_params(synthetic_ensemble(10, 7, N_FEAT, seed=4, device=cuda))
    eng.run(_Batches(batches[:2]))
    assert eng._captures.recaptures == len(keys)
    eng.fence_cold()


def test_overload_cycle_replays_captured_graphs_only(cuda):
    """A full climb (shed, forced largest bucket, alerts-only, deferral)
    and descent under a scripted backlog: every batch replays a captured
    graph, and nothing is captured again."""
    from real_time_fraud_detection_system_tpu_torch.config import (
        OverloadConfig,
    )

    # the CPU ladder test's script (tests/test_torch_overload.py): a
    # backlog of 24 polls of 256 rows against lag_high_rows=4000
    batches = _labeled_batches(n_batches=24, rows=256)
    cfg = Config(features=FeatureConfig(customer_capacity=512,
                                        terminal_capacity=512),
                 runtime=RuntimeConfig(
                     batch_buckets=(256,), precompile=True,
                     autobatch=True,
                     overload=OverloadConfig(
                         enabled=True, spill_path="", lag_high_rows=4000,
                         climb_dwell_batches=2, descend_dwell_batches=2)))
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        MetricsRegistry,
    )

    params, scaler = _graph_model("forest", cuda)
    eng = ScoringEngine(cfg, "forest", params, scaler, device=cuda,
                        metrics=MetricsRegistry())
    lag = eng.metrics.gauge("rtfds_source_lag_rows")
    src = _Batches(batches)
    poll = src.poll_batch

    def poll_with_lag():
        cols = poll()
        lag.set(256 * (len(batches) - src._i))
        return cols

    src.poll_batch = poll_with_lag
    # the warmup's launches (on scratch copies) count where they run
    eng.precompile()
    before = fk.fused_forest_leaf_sum.launches
    stats = eng.run(src)
    assert stats["rows"] == 256 * len(batches)
    assert eng.metrics.get("rtfds_shed_rows_total").value > 0
    assert eng.metrics.get("rtfds_overload_rung").value == 0
    assert eng._captures.recaptures == 0
    assert fk.fused_forest_leaf_sum.launches - before == stats["batches"]


def test_nan_guard_under_graphs_equals_eager(cuda, tmp_path):
    """The guard's twins are copied around the replay, outside the graph:
    a NaN score (a poisoned step) rolls the state back and re-scores the
    batch without the row, as under eager dispatch."""
    from real_time_fraud_detection_system_tpu_torch.io.sink import (
        DeadLetterSink,
    )

    batches = _labeled_batches(n_batches=4)
    bad_tx = int(batches[2]["tx_id"][5])
    out = {}
    for precompile in (False, True):
        cfg = Config(features=FeatureConfig(customer_capacity=512,
                                            terminal_capacity=512),
                     runtime=RuntimeConfig(batch_buckets=(1024,),
                                           nan_guard=True,
                                           precompile=precompile))
        params, scaler = _logreg_model(cuda)
        dlq = DeadLetterSink(str(tmp_path / f"dlq{precompile}.jsonl"))
        eng = ScoringEngine(cfg, "logreg", params, scaler, device=cuda,
                            dead_letter=dlq, online_lr=0.05)
        eng.precompile() if precompile else None
        graph = eng._graphs.get(("step", 7, 1024))
        marker = float(batches[2]["tx_amount_cents"][5]) / 100.0

        def poison(out_, packed):
            amount = packed[4].view(torch.float32)
            hit = (amount == marker) & (
                torch.arange(amount.shape[0], device=cuda) == 5)
            return out_._replace(probs=torch.where(
                hit, torch.full_like(out_.probs, float("nan")),
                out_.probs))

        if graph is not None:
            replay = graph.replay
            graph.replay = lambda *a: poison(replay(*a), graph.inputs[0])
        else:
            step = eng._step
            eng._step = lambda packed: poison(step(packed), packed)
        sink = []

        class _Sink:
            def append(self, res):
                sink.append(res)

        eng.run(_Batches(batches), _Sink())
        out[precompile] = (sink, dlq.tx_ids(), eng)
    (se, de, ee), (sg, dg, eg) = out[False], out[True]
    assert de == dg == [bad_tx]
    for a, b in zip(se, sg):
        np.testing.assert_array_equal(b.probs, a.probs)
        np.testing.assert_array_equal(b.features, a.features)
    for (p, a), (_, b) in zip(_state_leaves(ee), _state_leaves(eg)):
        assert torch.equal(a, b), p


def _whole_dollar_txs(n_rows=6000):
    _, _, txs = generate_dataset(DataConfig(n_customers=200, n_terminals=400,
                                            n_days=20, seed=5))
    txs = txs.slice(slice(0, n_rows))
    txs.amount_cents = np.round(txs.amount_cents / 100).astype(np.int64) * 100
    return txs


def _ingest_cfg(depth, precompile):
    return Config(features=FeatureConfig(customer_capacity=512,
                                         terminal_capacity=512),
                  runtime=RuntimeConfig(batch_buckets=(256, 1024),
                                        pipeline_depth=depth,
                                        precompile=precompile))


@pytest.mark.parametrize("precompile", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
def test_prefetch_on_cuda_is_bit_identical_to_unprefetched(cuda, depth,
                                                           precompile):
    """The same whole-dollar stream served with and without a
    ``PrefetchSource`` on the card: every output bit for bit, the fused
    forest kernel once per batch both times (the producer thread does
    host work only)."""
    from real_time_fraud_detection_system_tpu_torch.runtime.prefetch import (
        PrefetchSource,
    )

    txs = _whole_dollar_txs()
    params, scaler = _graph_model("forest", cuda)
    outs = []
    for prefetch in (0, 3):
        eng = ScoringEngine(_ingest_cfg(depth, precompile), "forest",
                            params, scaler, device=cuda)
        src = ReplaySource(txs, START, batch_rows=1000)
        if prefetch:
            src = PrefetchSource(src, max_batches=prefetch)
        if precompile:
            eng.precompile()
        sink = MemorySink()
        before = fk.fused_forest_leaf_sum.launches
        try:
            stats = eng.run(src, sink)
        finally:
            if prefetch:
                src.close()
        torch.cuda.synchronize()
        assert fk.fused_forest_leaf_sum.launches - before == stats["batches"]
        out = sink.concat()
        out.pop("processed_at_us")
        outs.append(out)
    for k in outs[0]:
        assert np.array_equal(outs[0][k], outs[1][k]), k


def test_nvtx_ranges_open_only_on_cuda(cuda, monkeypatch):
    """With the tracer on, a CUDA engine's spans push and pop one NVTX
    range each, named ``rtfds.<phase>#<batch>``, on the thread that opened
    them; a CPU engine in the same process pushes none."""
    import threading

    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        get_tracer,
    )

    pushed, popped = [], []
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda msg: pushed.append(
                            (msg, threading.get_ident())))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: popped.append(threading.get_ident()))
    tracer = get_tracer()
    was = tracer.enabled
    tracer.configure(enabled=True)
    try:
        txs = _whole_dollar_txs(2000)
        params, scaler = _graph_model("forest", cuda)
        eng = ScoringEngine(_ingest_cfg(2, False), "forest", params, scaler,
                            device=cuda)
        assert eng._nvtx is True
        eng.run(ReplaySource(txs, START, batch_rows=1000), MemorySink())
        names = [m for m, _ in pushed]
        for phase in ("source_poll", "host_prep", "dispatch", "result_wait",
                      "sink_write"):
            assert f"rtfds.{phase}#1" in names, phase
        assert len(pushed) == len(popped)
        assert {t for _, t in pushed} == set(popped) == {
            threading.get_ident()}
        n = len(pushed)
        cpu_params, cpu_scaler = _graph_model("forest", "cpu")
        cpu = ScoringEngine(_ingest_cfg(2, False), "forest", cpu_params,
                            cpu_scaler, device="cpu")
        assert cpu._nvtx is False
        cpu.run(ReplaySource(txs, START, batch_rows=1000), MemorySink())
        assert len(pushed) == n
    finally:
        tracer.configure(enabled=was)
        tracer.clear()


@pytest.mark.parametrize("precompile", [False, True])
def test_device_track_on_cuda_follows_the_host_dispatch(cuda, precompile):
    """With the tracer on, an exact forest engine on the card records one
    ``device/step`` per batch and one ``device/compact`` per compaction,
    eager or replayed: each with a positive duration, launched by its
    host span (``dispatch/replay``, ``state_compact``) and starting after
    it began and after the device span before it ended, in the order of
    those host spans; the run's ``trace`` entry
    counts them, and the digest's device idle by span adds up to the
    gaps between them."""
    from real_time_fraud_detection_system_tpu_torch.utils.trace import (
        get_tracer,
        summarize_chrome,
    )

    tracer = get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracer.configure(enabled=True)
    try:
        params, scaler = _graph_model("forest", cuda)
        cfg = Config(features=FeatureConfig(
            key_mode="exact", customer_capacity=512, terminal_capacity=1024,
            compact_every=2),
            runtime=RuntimeConfig(batch_buckets=(1024,), pipeline_depth=2,
                                  precompile=precompile))
        eng = ScoringEngine(cfg, "forest", params, scaler, device=cuda)
        stats = eng.run(ReplaySource(_whole_dollar_txs(6000), START,
                                     batch_rows=1000), MemorySink())
        trace = tracer.export_chrome()
    finally:
        tracer.configure(enabled=was)
        tracer.clear()
    events = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    host = {e["args"]["id"]: e for e in events if e["cat"] != "device"}
    dev = sorted((e for e in events if e["cat"] == "device"),
                 key=lambda e: e["ts"])
    launcher = {"device/step": "dispatch/replay",
                "device/compact": "state_compact"}
    assert [sum(d["name"] == n for d in dev) for n in launcher] == [
        stats["batches"], stats["batches"] // 2]
    for d in dev:
        h = host[d["args"]["launched_by"]]
        assert d["dur"] > 0 and h["name"] == launcher[d["name"]]
        # the anchor puts the card's clock on the host's within a few µs
        assert d["ts"] >= h["ts"] - 50.0
    order = [host[d["args"]["launched_by"]]["ts"] for d in dev]
    assert order == sorted(order)
    # one stream: a replay's first node runs after the work before it
    for prev, d in zip(dev, dev[1:]):
        assert d["ts"] >= prev["ts"] + prev["dur"] - 1.0, (prev, d)
    device = stats["trace"]["device"]
    assert {k: v["count"] for k, v in device.items()} == {
        "device/step": stats["batches"],
        "device/compact": stats["batches"] // 2}
    gaps, end = 0.0, dev[0]["ts"]
    for d in dev:
        gaps += max(0.0, d["ts"] - end)
        end = max(end, d["ts"] + d["dur"])
    digest = summarize_chrome(trace)
    assert sum(digest["device_idle_by_span"].values()) == pytest.approx(
        gaps / 1e3, abs=1e-3 * (len(dev) + 1))
    assert digest["device_window_ms"] == pytest.approx(
        digest["device_busy_ms"] + gaps / 1e3, abs=1e-3 * (len(dev) + 1))


def test_cpu_scorer_on_cuda_rescores_the_card_features(cuda):
    """``scorer="cpu"`` on the card: the step (and its fused kernel) runs
    as ever, and every probability is the host's ``predict_proba_np`` of
    the features the card emitted, within ``1e-7`` of the card's own
    forest scores."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
    )

    txs = _whole_dollar_txs(3000)
    params, scaler = _graph_model("forest", "cpu")
    model = TrainedModel("forest", scaler, params)
    dev_params, dev_scaler = _graph_model("forest", cuda)
    runs = []
    for scorer in ("tpu", "cpu"):
        eng = ScoringEngine(_ingest_cfg(2, False), "forest", dev_params,
                            dev_scaler, device=cuda, scorer=scorer,
                            cpu_model=model if scorer == "cpu" else None)
        sink = MemorySink()
        before = fk.fused_forest_leaf_sum.launches
        stats = eng.run(ReplaySource(txs, START, batch_rows=1000), sink)
        torch.cuda.synchronize()
        assert fk.fused_forest_leaf_sum.launches - before == stats["batches"]
        runs.append(sink.concat())
    card, host = runs
    np.testing.assert_allclose(host["prediction"], card["prediction"],
                               rtol=0.0, atol=ATOL_PROB)
    assert np.array_equal(host["tx_id"], card["tx_id"])


def _offline_xy(n=6000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, N_FEAT)).astype(np.float32)
    logit = x[:, 0] - 0.5 * x[:, 1] + 0.3 * x[:, 2] - 2.0
    y = (rng.random(n) < 1 / (1 + np.exp(-logit))).astype(np.float32)
    return x, y


def test_trained_gbt_predict_proba_launches_leaf_sum_on_cuda(cuda):
    """A booster trained into the card's memory predicts through the
    leaf-sum kernel (one launch per call), equal to the plain version's
    leaf sums exactly and to the same model's CPU predict within
    ``1e-6`` (a sigmoid of the same sums)."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
    )
    from real_time_fraud_detection_system_tpu_torch.models.gbt import (
        train_gbt,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        transform,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    x, y = _offline_xy()
    cpu = TrainedModel("gbt", fit_scaler(x, device="cpu"),
                       train_gbt(x, y, n_trees=6, max_depth=6, device="cpu"))
    card = TrainedModel("gbt", cpu.scaler.to(cuda), tree.to(cpu.params, cuda))
    rows = np.random.default_rng(1).normal(size=(5000, N_FEAT)).astype(
        np.float32)
    before = fk.leaf_sum.launches
    p = card.predict_proba(rows)
    assert fk.leaf_sum.launches - before == 1
    params, tables = card._device_route()
    xs = transform(card.scaler, torch.as_tensor(rows, device=cuda))
    leaf = fk.leaf_sum(tables, xs)
    assert torch.equal(leaf, fk.leaf_sum_plain(tables, xs))
    np.testing.assert_array_equal(
        p, torch.sigmoid(params.base_score + leaf).cpu().numpy())
    np.testing.assert_allclose(p, cpu.predict_proba(rows), rtol=0.0,
                               atol=ATOL_SIGMOID)


@pytest.mark.parametrize("kind", ["logreg", "mlp"])
def test_train_on_cuda_matches_cpu(cuda, kind):
    """Minibatch Adam on the card reaches the CPU's parameters within
    ``atol=1e-5`` (the same update; the reductions of a batch's gradient
    add in other orders)."""
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        train_logreg,
    )
    from real_time_fraud_detection_system_tpu_torch.models.mlp import (
        train_mlp,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    x, y = _offline_xy()
    train = (train_logreg if kind == "logreg"
             else lambda *a, **k: train_mlp(*a, hidden=(16, 8), **k))
    got = train(x, y, batch_size=512, epochs=3, pos_weight=2.0, seed=5,
                device=cuda)
    want = train(x, y, batch_size=512, epochs=3, pos_weight=2.0, seed=5,
                 device="cpu")
    for a, b in zip(tree.leaves(got), tree.leaves(want)):
        assert a.is_cuda
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-5)


def test_replay_on_cuda_equals_cpu_on_whole_dollars(cuda):
    """The offline replay on the card: features and the final state bit
    for bit against the CPU's on whole-dollar amounts (float32 sums of
    whole dollars are exact in any order)."""
    from real_time_fraud_detection_system_tpu_torch.features import offline
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    txs = _whole_dollar_txs(20000)
    fcfg = FeatureConfig(customer_capacity=256, terminal_capacity=512)
    got, gstate = offline._replay(txs, fcfg, "2025-04-01", 4096, False,
                                  True, cuda)
    want, wstate = offline._replay(txs, fcfg, "2025-04-01", 4096, False,
                                   True, "cpu")
    assert got.tobytes() == want.tobytes()
    warm = offline.warm_start_state(txs, fcfg, chunk=4096, device=cuda)
    for a, b, c in zip(tree.leaves(gstate), tree.leaves(wstate),
                       tree.leaves(warm)):
        assert torch.equal(a.cpu(), b) and torch.equal(a, c)


# -- the sharded engine: N shards co-located on the card ---------------------


def _sharded_batches(hot_shares=(0.0,) * 5):
    """Whole-dollar labeled batches of 1,000 rows, ``hot_shares[i]`` of
    batch i's rows on one customer (at 64 rows per shard its shard spills
    into routed chunks whose customer exchange needs the full bucket; a
    balanced batch spills into compact routed chunks)."""
    batches = _labeled_batches(n_batches=len(hot_shares))
    rng = np.random.default_rng(21)
    for b, share in zip(batches, hot_shares):
        hot = rng.random(len(b["tx_id"])) < share
        b["customer_id"] = np.where(hot, 7, b["customer_id"])
    return batches


HOT = (0.6, 0.0, 0.6, 0.0, 0.6)


def _sharded_engine(dev, kind, n_dev, lr=0.0, rows_per_shard=0):
    import dataclasses

    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    cfg = _learning_cfg()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, max_batch_rows=1024))
    params, scaler = _graph_model(kind, dev)
    return ShardedScoringEngine(cfg, kind, params, scaler, n_devices=n_dev,
                                device=dev, online_lr=lr,
                                rows_per_shard=rows_per_shard)


@pytest.mark.parametrize("n_dev", [4, 8])
def test_sharded_step_leaf_sum_matches_plain_version_on_the_chunk(
        cuda, monkeypatch, n_dev):
    """Inside the sharded step the forest scores the whole ``[n_dev ·
    rows_per_shard]`` chunk with one leaf-sum launch; on that chunk's
    scaled features the kernel equals ``leaf_sum_plain`` (both add the
    trees in order)."""
    from real_time_fraud_detection_system_tpu_torch.runtime import engine

    seen = []
    proba = engine.leaf_sum_proba

    def spy(tables, x, base=None):
        seen.append((tables, x))
        return proba(tables, x, base)

    monkeypatch.setattr(engine, "leaf_sum_proba", spy)
    eng = _sharded_engine(cuda, "forest", n_dev)
    before = fk.leaf_sum.launches
    eng.process_batch(_sharded_batches()[0])
    assert fk.leaf_sum.launches - before == 1 and len(seen) == 1
    tables, x = seen[0]
    assert x.shape[0] == n_dev * eng.rows_per_shard
    assert torch.equal(fk.leaf_sum(tables, x), fk.leaf_sum_plain(tables, x))


@pytest.mark.parametrize("kind,lr", [("forest", 0.0), ("logreg", 0.05)])
def test_sharded_engine_on_cuda_matches_cpu_engine(cuda, kind, lr):
    """Four shards on the card against four on the CPU, hot key (routed
    chunks, the full exchange bucket) included: features and state bit for
    bit on whole dollars, probabilities within 1e-7 (forest) and 1e-6
    (logreg after the in-step SGD)."""
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    batches = _sharded_batches(HOT)
    outs = []
    for dev in (cuda, torch.device("cpu")):
        eng = _sharded_engine(dev, kind, 4, lr, rows_per_shard=64)
        sink = []

        class _Sink:
            def append(self, res):
                sink.append(res)

        stats = eng.run(_Batches(batches), _Sink())
        outs.append((eng, sink, stats))
    (ge, got, gs), (ce, want, cs) = outs
    assert gs["full_exchange_chunks"] == cs["full_exchange_chunks"] > 0
    for a, b in zip(got, want):
        assert np.array_equal(a.features, b.features)
        np.testing.assert_allclose(a.probs, b.probs, rtol=0.0,
                                   atol=ATOL_PROB if kind == "forest"
                                   else ATOL_SIGMOID)
    for a, b in zip(tree.leaves(ge.state.feature_state),
                    tree.leaves(ce.state.feature_state)):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("kind,lr", [("forest", 0.0), ("logreg", 0.05)])
def test_sharded_graph_replay_equals_eager_on_cuda(cuda, kind, lr):
    """``precompile`` captures both signatures (owner-local and routed);
    replay serves every compact chunk (both graphs replayed), the
    full-bucket chunks run eagerly, and outputs and state equal eager
    dispatch bit for bit."""
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    batches = _sharded_batches(HOT)
    runs = []
    replays = {}
    for precompile in (False, True):
        eng = _sharded_engine(cuda, kind, 4, lr, rows_per_shard=64)
        if precompile:
            man = eng.precompile()
            assert man["graphs"] == 2
            assert sorted(eng._graphs) == [("sharded", False),
                                           ("sharded", True)]
            for key, g in eng._graphs.items():
                replays[key] = 0

                def counted(*a, _replay=g.replay, _key=key):
                    replays[_key] += 1
                    return _replay(*a)

                g.replay = counted
        sink = []

        class _Sink:
            def append(self, res):
                sink.append(res)

        before = fk.leaf_sum.launches
        stats = eng.run(_Batches(batches), _Sink())
        torch.cuda.synchronize()
        runs.append((eng, sink, stats, fk.leaf_sum.launches - before))
    (ee, want, es, el), (ge, got, gs, gl) = runs
    assert gs["full_exchange_chunks"] == es["full_exchange_chunks"] > 0
    assert all(n > 0 for n in replays.values()), replays
    assert gl == el
    assert ge._m_aot_fallbacks.value == 0
    for a, b in zip(got, want):
        assert np.array_equal(a.features, b.features)
        assert np.array_equal(a.probs, b.probs)
    for a, b in zip(tree.leaves(ge.state.feature_state)
                    + tree.leaves(ge.state.params),
                    tree.leaves(ee.state.feature_state)
                    + tree.leaves(ee.state.params)):
        assert torch.equal(a, b)


# -- the tiered store across shards on the card --------------------------------


def test_stacked_admission_on_cuda_equals_cpu_bit_for_bit(cuda):
    """``admit_slots_stacked`` (every shard's rows in one pass, probe
    positions offset per shard, grants ranked per shard) on the card as on
    the CPU: slots, admitted masks and every leaf of the directory stack,
    through duplicates, uint32 edge keys, stacks that run dry and
    reclaims on each shard's view, at the serving bucket's size."""
    from real_time_fraud_detection_system_tpu_torch.ops import keydir

    rng = np.random.default_rng(5)
    n, width = 4, 16384
    cpu = keydir.init_stacked_keydir(1 << 13, 1 << 12, n, "cpu")
    gpu = keydir.init_stacked_keydir(1 << 13, 1 << 12, n, cuda)
    for _ in range(5):
        keys = rng.integers(0, 2 ** 32, (n, width),
                            dtype=np.uint64).astype(np.uint32)
        keys[:, :8000] = rng.integers(0, 6000, (n, 8000))
        keys[0, 8000:8004] = [2 ** 31 - 1, 2 ** 31, 0xFFFFFFFE, 0xFFFFFFFF]
        valid = rng.random((n, width)) < 0.95
        tk, tv = torch.from_numpy(keys), torch.from_numpy(valid)
        _, cs, ca = keydir.admit_slots_stacked(cpu, tk, tv)
        _, gs, ga = keydir.admit_slots_stacked(gpu, tk.to(cuda),
                                               tv.to(cuda))
        assert torch.equal(gs.cpu(), cs) and torch.equal(ga.cpu(), ca)
        _same_keydir(cpu, gpu)
        dead = torch.from_numpy(rng.random((n, 1 << 13)) < 0.3)
        for s in range(n):
            keydir.reclaim_entries(keydir.KeyDirectory(*[x[s] for x in cpu]),
                                   dead[s])
            keydir.reclaim_entries(keydir.KeyDirectory(*[x[s] for x in gpu]),
                                   dead[s].to(cuda))
        _same_keydir(cpu, gpu)
    assert bool((cpu.free_top < (1 << 12)).all())


def _cold_sharded_engine(dev, tmp, name, kind="logreg"):
    """A 4-shard exact engine with a small hot tier, compaction every 2
    batches and a cold store: demotions and promotions on every path."""
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    cfg = Config(
        features=FeatureConfig(
            key_mode="exact", customer_capacity=128, terminal_capacity=128,
            cms_width=1 << 12, compact_every=2,
            cold_store=str(tmp / name), cold_demote_slots=16,
            cold_highwater=0.25, cold_promote_queue=64),
        runtime=RuntimeConfig(batch_buckets=(64,), max_batch_rows=64))
    params, scaler = _graph_model(kind, dev)
    return ShardedScoringEngine(cfg, kind, params, scaler, n_devices=4,
                                device=dev)


def _cold_stream():
    """Early keys demoted under pressure, later keys pushing occupancy
    past the high-water mark, then 16 of the early keys returning."""
    def cols(cust, day):
        cust = np.asarray(cust, np.int64)
        n = len(cust)
        us = (day * 86400 + np.arange(n) % 86400).astype(np.int64) \
            * 1_000_000
        return {"tx_id": np.arange(n, dtype=np.int64), "tx_datetime_us": us,
                "customer_id": cust, "terminal_id": cust + 10000,
                "tx_amount_cents": np.full(n, 1200, np.int64),
                "kafka_ts_ms": us // 1000}

    a, b = np.arange(0, 48), np.arange(1000, 1032)
    return [cols(a, 20200), cols(a, 20200), cols(b, 20202),
            cols(b, 20203), cols(b, 20204), cols(a[:16], 20205)]


def test_sharded_exact_graphs_replay_equal_eager_on_cuda(cuda, tmp_path):
    """The sharded exact engine's four signatures — both step variants,
    ``("compact",)`` (with the cold tier's demotions) and
    ``("promote",)`` — captured as CUDA graphs: the compaction and
    promotion graphs replay, and outputs, the whole state and the cold
    counters equal eager dispatch bit for bit; both equal the same
    engine on the CPU."""
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    runs = []
    replays = {}
    for dev, precompile in ((cuda, False), (cuda, True),
                            (torch.device("cpu"), False)):
        eng = _cold_sharded_engine(dev, tmp_path,
                                   f"cold-{dev.type}-{precompile}")
        if precompile:
            man = eng.precompile()
            assert sorted(eng._graphs, key=str) == sorted(
                [("sharded", False), ("sharded", True), ("compact",),
                 ("promote",)], key=str)
            assert man["graphs"] == 4
            for key, g in eng._graphs.items():
                replays[key] = 0

                def counted(*a, _replay=g.replay, _key=key):
                    replays[_key] += 1
                    return _replay(*a)

                g.replay = counted
        out = []
        for cols in _cold_stream():
            out.append(eng.process_batch(cols))
            eng.drain_promotions(timeout_s=30.0)
        runs.append((eng, out))
        eng.fence_cold()
    (ee, want), (ge, got), (ce, cpu_out) = runs
    assert replays[("compact",)] > 0 and replays[("promote",)] > 0, replays
    assert ge._m_aot_fallbacks.value == 0
    assert ge._m_cold_dem.value == ee._m_cold_dem.value > 0
    assert ge._m_cold_prom.value == ee._m_cold_prom.value > 0
    for a, b, c in zip(got, want, cpu_out):
        assert np.array_equal(a.features, b.features)
        assert np.array_equal(a.probs, b.probs)
        assert np.array_equal(a.features, c.features)
        np.testing.assert_allclose(a.probs, c.probs, rtol=0.0,
                                   atol=ATOL_SIGMOID)
    for a, b, c in zip(tree.leaves(ge.state.feature_state),
                       tree.leaves(ee.state.feature_state),
                       tree.leaves(ce.state.feature_state)):
        assert torch.equal(a, b) and torch.equal(a.cpu(), c)


def test_sharded_exact_step_and_passes_never_sync_on_cuda(cuda):
    """The sharded exact step (the stacked admission, the owner exchange,
    both tiers' reads, the tier counts), the per-shard compaction with
    demotion and the per-shard promotion run under
    ``torch.cuda.set_sync_debug_mode("error")``."""
    from real_time_fraud_detection_system_tpu_torch.core import batch as cb
    from real_time_fraud_detection_system_tpu_torch.features import online
    from real_time_fraud_detection_system_tpu_torch.models.logreg import (
        logreg_predict_proba,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        mesh as pmesh,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        step as pstep,
    )

    cfg = Config(features=FeatureConfig(
        key_mode="exact", customer_capacity=256, terminal_capacity=256,
        cms_width=1 << 8, cold_highwater=0.25))
    mesh = pmesh.make_mesh(4, devices=[cuda] * 4)
    fs = pmesh.shard_feature_state(
        online.init_feature_state(cfg.features, cuda, n_shards=4), mesh)
    params, scaler = _logreg_model(cuda)
    steps = {r: pstep.make_sharded_step(cfg, logreg_predict_proba,
                                        mesh=mesh, route_customers=r,
                                        packed=True) for r in (False, True)}
    compact = pstep.make_sharded_compact(cfg, mesh, demote_slots=32)
    promote = pstep.make_sharded_promote(cfg, mesh)
    rng = np.random.default_rng(7)
    chunks = []
    for d in range(4):
        cols = {"customer_id": rng.integers(0, 600, 1000),
                "terminal_id": rng.integers(0, 600, 1000),
                "tx_datetime_us": (np.full(1000, 20200 + d, np.int64) * 86400
                                   + rng.integers(0, 86400, 1000))
                * 1_000_000,
                "tx_amount_cents": rng.integers(1, 500, 1000) * 100,
                "label": rng.integers(-1, 2, 1000)}
        # ~250 rows a shard against 200: every batch spills a routed chunk
        for part, _, _ in pstep.partition_batch_spill(cols, 4, 200):
            packed = cb.pack_batch(cb.make_batch(
                customer_id=part["customer_id"],
                terminal_id=part["terminal_id"],
                tx_datetime_us=part["tx_datetime_us"],
                amount_cents=part["tx_amount_cents"],
                label=np.where(part["__valid__"], part["label"], -1),
            )._replace(valid=part["__valid__"]))
            chunks.append((torch.from_numpy(packed).to(cuda),
                           part["__routed__"]))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tiers = [steps[r](fs, params, scaler, p, full=(r, True))[4]
                 for p, r in chunks]
        compact(fs, 20203)
        _, rec, payload = compact(fs, 20204)
        _, stats = promote(fs, payload)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert any(r for _, r in chunks)
    tier = sum(t.cpu() for t in tiers)
    assert tier.shape == (4, 2) and bool((tier > 0).all())
    assert int(rec.sum()) > 0 and int(stats[:, :, 0].sum()) > 0


def test_exact_sharded_step_leaf_sum_matches_plain_version_on_the_chunk(
        cuda, monkeypatch):
    """Under ``key_mode="exact"`` the sharded step still scores the whole
    chunk with one leaf-sum launch, equal to ``leaf_sum_plain`` on that
    chunk's scaled features."""
    import dataclasses

    from real_time_fraud_detection_system_tpu_torch.runtime import engine
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    seen = []
    proba = engine.leaf_sum_proba

    def spy(tables, x, base=None):
        seen.append((tables, x))
        return proba(tables, x, base)

    monkeypatch.setattr(engine, "leaf_sum_proba", spy)
    cfg = _learning_cfg(key_mode="exact")
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, max_batch_rows=1024))
    params, scaler = _graph_model("forest", cuda)
    eng = ShardedScoringEngine(cfg, "forest", params, scaler, n_devices=4,
                               device=cuda)
    before = fk.leaf_sum.launches
    eng.process_batch(_sharded_batches()[0])
    assert fk.leaf_sum.launches - before == 1 and len(seen) == 1
    tables, x = seen[0]
    assert x.shape[0] == 4 * eng.rows_per_shard
    assert torch.equal(fk.leaf_sum(tables, x), fk.leaf_sum_plain(tables, x))


# -- the fleet of processes (its engines, exchange and adoption on the card)


def _fleet_engine(dev, topo, key_mode="direct", n_dev=2):
    import dataclasses

    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    cfg = _learning_cfg(key_mode=key_mode)
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, max_batch_rows=1024))
    params, scaler = _graph_model("forest", dev)
    return ShardedScoringEngine(cfg, "forest", params, scaler,
                                n_devices=n_dev, device=dev, topology=topo)


def _fleet_batches(n_proc=2, local=2):
    """Whole-dollar batches, terminals co-partitioned with customers (the
    fleet's exactness contract)."""
    batches = _labeled_batches(n_batches=3)
    n = n_proc * local
    for b in batches:
        b.pop("label")
        b["terminal_id"] = (b["terminal_id"] // n) * n + b["customer_id"] % n
    return batches


@pytest.mark.parametrize("key_mode", ["direct", "exact"])
def test_fleet_engines_on_cuda_match_the_cpu_fleet(cuda, key_mode):
    """Each process of a 2 × 2 fleet on the card against the same process
    on the CPU: features and every state leaf bit for bit (whole dollars),
    probabilities within 1e-7; the leaf-sum kernel once per chunk."""
    from real_time_fraud_detection_system_tpu_torch.runtime.distributed \
        import ProcessTopology
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    for pid in (0, 1):
        topo = ProcessTopology(2, pid, 2)
        got = []
        for dev in (cuda, torch.device("cpu")):
            eng = _fleet_engine(dev, topo, key_mode)
            fk.leaf_sum.launches = 0
            outs = [eng.process_batch(
                {k: v[topo.owns(b["customer_id"])] for k, v in b.items()})
                for b in _fleet_batches()]
            if dev == cuda:
                torch.cuda.synchronize()
                assert fk.leaf_sum.launches == eng.chunks_done
            got.append((eng, outs))
        (ge, g), (ce, c) = got
        for a, b in zip(g, c):
            assert np.array_equal(a.features, b.features)
            np.testing.assert_allclose(a.probs, b.probs, rtol=0.0,
                                       atol=ATOL_PROB)
        for a, b in zip(tree.leaves(ge.state.feature_state),
                        tree.leaves(ce.state.feature_state)):
            assert torch.equal(a.cpu(), b)


def test_sketch_exchange_on_cuda_writes_the_serving_sketch_in_place(
        cuda, tmp_path):
    """An exchange round between two fleet engines on the card lands the
    merged terminal sketch in the engine's own tensors (same addresses),
    equal to the CPU fleet's round; the checkpoint form holds locals
    only."""
    from real_time_fraud_detection_system_tpu_torch.runtime.cms_exchange \
        import SketchExchange
    from real_time_fraud_detection_system_tpu_torch.runtime.distributed \
        import ProcessTopology

    sketches = {}
    for dev in (cuda, torch.device("cpu")):
        engines = []
        for pid in (0, 1):
            topo = ProcessTopology(2, pid, 2)
            eng = _fleet_engine(dev, topo, "exact")
            eng.cms_exchange = SketchExchange(str(tmp_path / str(dev)), pid,
                                              2, timeout_s=0.0)
            for b in _fleet_batches():
                eng.process_batch({k: v[topo.owns(b["customer_id"])]
                                   for k, v in b.items()})
            engines.append(eng)
        for eng in engines + engines[:1]:
            ptrs = [t.data_ptr() for t in eng.state.feature_state.terminal_cms]
            locals_ = eng.checkpoint_state().feature_state.terminal_cms
            eng._maybe_exchange_cms()
            assert ptrs == [t.data_ptr()
                            for t in eng.state.feature_state.terminal_cms]
        sketches[dev.type] = [
            ([t.cpu() for t in e.state.feature_state.terminal_cms],
             [torch.as_tensor(np.asarray(t.cpu() if hasattr(t, "cpu")
                                         else t))
              for t in e.checkpoint_state().feature_state.terminal_cms])
            for e in engines]
        assert locals_ is not None
    for (a_live, a_ck), (b_live, b_ck) in zip(sketches["cuda"],
                                              sketches["cpu"]):
        assert all(torch.equal(x, y) for x, y in zip(a_live, b_live))
        assert all(torch.equal(x, y) for x, y in zip(a_ck, b_ck))


def test_single_process_checkpoint_adopts_into_a_fleet_on_cuda(cuda,
                                                              tmp_path):
    """The 1→P leg on the card: a one-process checkpoint restored by each
    fleet process, re-sliced to its residue block in place, then serving
    the same features as the CPU's adoption."""
    from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
        Checkpointer,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.distributed \
        import ProcessTopology

    batches = _fleet_batches()
    src = _fleet_engine(torch.device("cpu"), None, "exact", n_dev=4)
    for b in batches[:2]:
        src.process_batch(dict(b))
    ck = Checkpointer(str(tmp_path))
    ck.save(src.state)
    for pid in (0, 1):
        topo = ProcessTopology(2, pid, 2)
        outs = []
        for dev in (cuda, torch.device("cpu")):
            eng = _fleet_engine(dev, topo, "exact")
            ptrs = [t.data_ptr() for t in
                    eng.state.feature_state.terminal_dir]
            assert ck.restore(eng.state) is not None
            eng._ensure_layout()
            assert (eng.state.process_count, eng.state.process_id) == (2, pid)
            assert ptrs == [t.data_ptr() for t in
                            eng.state.feature_state.terminal_dir]
            outs.append(eng.process_batch(
                {k: v[topo.owns(batches[2]["customer_id"])]
                 for k, v in batches[2].items()}))
        assert np.array_equal(outs[0].features, outs[1].features)


# -- the sequence kind over shards and the parallel library ----------------

def _seq_stream(n_batches, rows, n_cust, hot=None, seed=3):
    """Rows of ``n_cust`` customers over one day per batch (a ``hot``
    customer takes half of them, so chunks spill), times sorted."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_batches):
        t_s = (20000 + i) * 86400 + np.sort(rng.integers(0, 86400, rows))
        cust = rng.integers(0, n_cust, rows)
        if hot is not None:
            cust[rng.random(rows) < 0.5] = hot
        out.append({
            "tx_id": np.arange(i * rows, (i + 1) * rows, dtype=np.int64),
            "tx_datetime_us": t_s * 1_000_000,
            "customer_id": cust.astype(np.int64),
            "terminal_id": rng.integers(0, 64, rows).astype(np.int64),
            "tx_amount_cents": rng.integers(100, 90000, rows),
            "kafka_ts_ms": t_s * 1000})
    return out


@pytest.mark.parametrize("route", [False, True], ids=["local", "routed"])
def test_sharded_sequence_step_on_cuda_matches_cpu(cuda, route):
    """The stacked history step (owner-local, and routed through the
    exchange) on the card against the CPU: ``pos``, ``count``, ``last_t``
    equal off the blocks' sinks, events within ``1e-6``, probabilities
    within ``1e-5``; the step never syncs."""
    from real_time_fraud_detection_system_tpu_torch.core import batch as cb
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        sequence_step as ss,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    n, bl = 4, 256
    cfg = Config(features=FeatureConfig(customer_capacity=1024,
                                        terminal_capacity=256,
                                        history_len=16))
    rng = np.random.default_rng(5)
    cust = rng.integers(0, 300, n * bl)
    if not route:
        cust = cust - cust % n + np.repeat(np.arange(n), bl)
    t_s = 20000 * 86400 + np.sort(rng.integers(0, 7200, n * bl))
    packed = cb.pack_batch(cb.make_batch(
        customer_id=cust, terminal_id=np.zeros(n * bl, np.int64),
        tx_datetime_us=t_s * 1_000_000,
        amount_cents=rng.integers(100, 90000, n * bl))._replace(
            valid=rng.random(n * bl) < 0.9))
    order = rng.permutation(n * bl).astype(np.int32)
    out = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(n, devices=[dev] * n)
        params = init_transformer(d_model=32, n_heads=2, n_layers=2,
                                  d_ff=64, seed=2, device=dev)
        state = ss.init_sharded_history_state(cfg, mesh)
        step = ss.make_sharded_sequence_step(cfg, mesh, route=route)
        batch = cb.unpack_batch(torch.from_numpy(packed).to(dev))
        okey = torch.from_numpy(order).to(dev)
        step(state, params, batch, okey)  # a history to read
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            _, probs = step(state, params, batch, okey)
        finally:
            if on_card:
                torch.cuda.set_sync_debug_mode(0)
        out[str(dev)] = (probs.cpu().numpy(), [t.cpu().numpy()
                                               for t in state])
    (pc, sc), (pg, sg) = out["cpu"], out[str(cuda)]
    np.testing.assert_allclose(pg, pc, atol=1e-5)
    np.testing.assert_allclose(sg[0][:, :-1], sc[0][:, :-1], atol=1e-6)
    for a, b in zip(sg[1:], sc[1:]):
        np.testing.assert_array_equal(a[:, :-1], b[:, :-1])


def test_sharded_sequence_engine_on_cuda_matches_cpu(cuda):
    """The 4-shard sequence engine on the card, a hot customer spilling
    into routed chunks, against the same engine on the CPU and the single
    engine on the card (probabilities within ``1e-5``)."""
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.sharded_engine \
        import ShardedScoringEngine

    cfg = Config(features=FeatureConfig(customer_capacity=1024,
                                        terminal_capacity=256,
                                        history_len=16),
                 runtime=RuntimeConfig(batch_buckets=(1024,),
                                       max_batch_rows=1024))
    batches = _seq_stream(3, 1024, 500, hot=7)
    res = {}
    for name, dev, n in (("cpu", "cpu", 4), ("cuda", cuda, 4),
                         ("single", cuda, 0)):
        params = init_transformer(d_model=32, n_heads=2, n_layers=2,
                                  d_ff=64, seed=2, device=dev)
        sc = Scaler(torch.zeros(15, device=dev), torch.ones(15, device=dev))
        eng = (ShardedScoringEngine(cfg, "sequence", params, sc,
                                    n_devices=n, device=dev,
                                    rows_per_shard=256) if n
               else ScoringEngine(cfg, "sequence", params, sc, device=dev))
        rs = [eng.process_batch(dict(c)) for c in batches]
        res[name] = [r.probs[np.argsort(r.tx_id)] for r in rs]
        if n:
            assert eng.chunks_done > len(batches)  # spill chunks ran
    for a, b, c in zip(res["cpu"], res["cuda"], res["single"]):
        np.testing.assert_allclose(b, a, atol=1e-5)
        np.testing.assert_allclose(b, c, atol=1e-5)


def test_sequence_parallel_attention_on_cuda_matches_cpu(cuda):
    """Ring and Ulysses attention over 8 shards and the sequence-parallel
    forward on the card against the CPU (within ``1e-5``, TF32 off), and
    a bf16 ring within ``0.1`` of the float32 one."""
    from real_time_fraud_detection_system_tpu_torch.models.sequence import (
        init_transformer,
        make_sp_logits_fn,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        ring_attention as ra,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        make_mesh,
    )

    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, (2, 256, 8, 16))
                                .astype(np.float32)) for _ in range(3))
    x = torch.from_numpy(rng.normal(0, 1, (2, 256, 8)).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(8, devices=[dev] * 8)
        params = init_transformer(d_model=32, n_heads=2, n_layers=2,
                                  d_ff=64, seed=3, device="cpu")
        res[str(dev)] = [t.cpu() for t in (
            ra.make_ring_attention_sharded(mesh)(q, k, v),
            ra.make_ulysses_attention_sharded(mesh, block_size=64)(q, k, v),
            make_sp_logits_fn(mesh)(
                tuple_to(params, dev), x.to(dev)))]
    for a, b in zip(res["cpu"], res[str(cuda)]):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)
    mesh = make_mesh(8, devices=[cuda] * 8)
    r16 = ra.make_ring_attention_sharded(mesh)(
        *(t.to(cuda, torch.bfloat16) for t in (q, k, v)))
    assert r16.dtype == torch.bfloat16
    np.testing.assert_allclose(r16.float().cpu().numpy(),
                               res["cpu"][0].numpy(), atol=0.1)


def tuple_to(params, dev):
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    return tree.to(params, dev)


def test_tensor_expert_pipeline_on_cuda_match_cpu(cuda):
    """One tensor-parallel MLP step (8 shards, and dp × tp 2 × 4), one
    expert-parallel apply and one pipeline pass on the card against their
    CPU runs and their unsharded forms: within ``1e-5``, or ``1e-6`` of
    the output's largest magnitude where that is larger (eight residual
    blocks grow the pipeline's activations to a few hundred, and cuBLAS
    and the CPU's products differ in the last bits at that scale)."""
    from real_time_fraud_detection_system_tpu_torch.models.mlp import (
        init_mlp,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        expert_parallel as ep,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        pipeline_parallel as pp,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel import (
        tensor_parallel as tp,
    )
    from real_time_fraud_detection_system_tpu_torch.parallel.distributed \
        import make_hybrid_mesh
    from real_time_fraud_detection_system_tpu_torch.parallel.mesh import (
        make_mesh,
    )
    from real_time_fraud_detection_system_tpu_torch.utils import tree

    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 1, (256, 15)).astype(np.float32))
    y = torch.from_numpy((rng.random(256) < 0.3).astype(np.int32))
    xe = torch.from_numpy(rng.normal(0, 1, (256, 16)).astype(np.float32))
    xp = torch.from_numpy(rng.normal(0, 1, (64, 32)).astype(np.float32))
    mlp = init_mlp(15, (64, 32), seed=1, device="cpu")
    moe = ep.init_moe(16, 32, 8, seed=2, device="cpu")
    stack = pp.init_stack(32, 8, seed=3, device="cpu")
    res = {}
    for dev in ("cpu", cuda):
        mesh = make_mesh(8, devices=[dev] * 8)
        grid = make_hybrid_mesh(2, 4, dcn_axis="dp", ici_axis="tp",
                                devices=[dev] * 8)
        outs = []
        for m, kw in ((mesh, {}), (grid, dict(axis="tp", dp_axis="dp"))):
            sh, step = tp.make_tp_step(m, tree.to(mlp, dev), lr=0.5, **kw)
            new, loss = step(sh, x, y)
            outs += [t.cpu() for t in tree.leaves(new)] + [loss.cpu()]
        sh, apply_fn = ep.make_ep_apply(mesh, moe)
        outs += [apply_fn(sh, xe).cpu(),
                 ep.moe_apply_dense(sh, xe.to(dev)).cpu()]
        sh, run = pp.make_pipeline(mesh, stack, n_micro=4)
        outs += [run(sh, xp).cpu(), pp.stack_apply(sh, xp.to(dev)).cpu()]
        res[str(dev)] = outs
    def close(got, want):
        want = want.numpy()
        np.testing.assert_allclose(
            got.numpy(), want, rtol=0,
            atol=max(1e-5, 1e-6 * float(np.abs(want).max())))

    for a, b in zip(res["cpu"], res[str(cuda)]):
        close(b, a)
    g = res[str(cuda)]
    close(g[-4], g[-3])
    close(g[-2], g[-1])


def _demo_config(n_customers=80, n_terminals=160):
    from real_time_fraud_detection_system_tpu_torch.config import TrainConfig

    return Config(
        data=DataConfig(n_customers=n_customers, n_terminals=n_terminals,
                        n_days=40, seed=3),
        features=FeatureConfig(customer_capacity=256, terminal_capacity=512,
                               cms_width=1 << 10),
        train=TrainConfig(delta_train_days=15, delta_delay_days=5,
                          delta_test_days=5, epochs=2, batch_size=512),
        runtime=RuntimeConfig(batch_buckets=(1024, 4096),
                              max_batch_rows=4096))


@pytest.mark.parametrize("kind,n_devices,own", [
    ("forest", 1, "fused_forest_leaf_sum"),
    ("logreg", 1, "fused_featurize_score"),
    ("forest", 2, "leaf_sum")], ids=["forest", "logreg", "forest-2"])
def test_demo_on_cuda_equals_the_cpu_demo(cuda, kind, n_devices, own):
    """``run_demo`` on the card against the CPU device at a small size:
    the forest from seeded weights, logreg trained on each device; the
    counts and flags equal, the stream AUC within 1e-6, and the path's
    kernel launched on the card (the plain version on the CPU)."""
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
        dump_model_bytes,
        load_model_bytes,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.pipeline import (
        run_demo,
    )

    data = None
    if kind == "forest":
        data = dump_model_bytes(TrainedModel(
            "forest", fit_scaler(np.random.default_rng(0).normal(
                50, 20, (64, 15)), device="cpu"),
            synthetic_ensemble(12, 5, 15, seed=2, device="cpu")))
    wrappers = {"fused_forest_leaf_sum": fk.fused_forest_leaf_sum,
                "leaf_sum": fk.leaf_sum,
                "fused_featurize_score": sk.fused_featurize_score}
    out = {}
    for dev in (cuda, "cpu"):
        for w in wrappers.values():
            w.launches = 0
        model = (load_model_bytes(data, device=dev) if data is not None
                 else None)
        out[str(dev)] = run_demo(_demo_config(), model=model,
                                 model_kind=kind, batch_rows=1024,
                                 n_devices=n_devices, device=dev)
        launches = {k: w.launches for k, w in wrappers.items()}
        if dev == cuda:
            assert launches[own] > 0
            assert all(n == 0 for k, n in launches.items() if k != own)
    got, want = out[str(cuda)], out["cpu"]
    for k in ("customers", "terminals", "warm_rows", "streamed_rows",
              "raw_tx_rows", "flagged_at_0.5"):
        assert got[k] == want[k], k
    assert got["stream_auc"] == pytest.approx(want["stream_auc"], abs=1e-6)
