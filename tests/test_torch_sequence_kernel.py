"""The sequence step's serving transformer kernel (``csrc/fused_sequence.cu``)
on the card against its plain version, ``transformer_last_logit`` with
naive causal attention: at the main path's shapes, at the edges of its
support, inside a captured CUDA graph, after an in-place swap, and in the
engine; and the wrapper's refusals. Without a card they skip.

They import neither jax nor the JAX package (run on the card with
``python -m pytest --noconftest -m gpu tests/test_torch_sequence_kernel.py``).

Tolerances: logits within ``2e-5`` and probabilities within ``1e-5`` of
the plain version. Both compute in float32, but the kernel adds its
products in another order than PyTorch's matmuls, einsums and reductions,
and rounds each product-add once (``__fmaf_rn``) where a matmul may not;
over two blocks of 32-wide sums and norms that moves a logit by ~1e-6.
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
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    init_transformer,
    transformer_last_logit,
)
from real_time_fraud_detection_system_tpu_torch.ops import (
    sequence_kernels as sqk,
)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    SEQUENCE_ROWS,
    ScoringEngine,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    MetricsRegistry,
)

pytestmark = pytest.mark.gpu

ATOL_LOGIT = 2e-5
ATOL_PROB = 1e-5
MAIN = dict(rows=65536, k=32, n_heads=2, n_layers=2, d_ff=64, n_in=8)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _params(dev, n_heads=2, n_layers=2, d_ff=64, n_in=8, seed=0):
    """The init's weights with random norms and biases (the init's ones
    and zeros would hide a gain or bias read from the wrong place)."""
    p = init_transformer(d_model=32, n_heads=n_heads, n_layers=n_layers,
                         d_ff=d_ff, n_in=n_in, seed=seed, device="cpu")
    gen = torch.Generator().manual_seed(seed + 100)
    out = []
    for path, leaf in tree.leaves_with_path(p):
        name = path.rsplit(".", 1)[-1].strip("[]'\"")
        if name.endswith("_g"):
            leaf = 1.0 + 0.2 * torch.randn(leaf.shape, generator=gen)
        elif name.endswith("_b") or name in ("b1", "b2"):
            leaf = 0.2 * torch.randn(leaf.shape, generator=gen)
        out.append(leaf.contiguous())
    return tree.to(tree.unflatten(p, out), dev)


def _inputs(dev, rows, k, n_in=8, seed=0):
    rng = np.random.default_rng(seed)
    hist = rng.normal(size=(rows, k, n_in)).astype(np.float32)
    hist[:, 0, 2] = 0.0
    qpos = rng.integers(0, k, rows).astype(np.int32)
    qpos[:4] = [0, k - 1, 0, k - 1][:rows]
    return (torch.as_tensor(hist, device=dev),
            torch.as_tensor(qpos, device=dev))


def _compare(params, hist, qpos):
    z = sqk.fused_last_logit(params, hist, qpos)
    torch.cuda.synchronize()
    want = transformer_last_logit(params, hist, qpos)
    assert z.shape == want.shape and z.dtype == torch.float32
    assert bool(torch.isfinite(z).all())
    dz = float((z - want).abs().max())
    dp = float((torch.sigmoid(z) - torch.sigmoid(want)).abs().max())
    assert dz <= ATOL_LOGIT, dz
    assert dp <= ATOL_PROB, dp
    return z


def test_kernel_matches_plain_at_the_main_path_shapes(cuda):
    m = MAIN
    params = _params(cuda, m["n_heads"], m["n_layers"], m["d_ff"],
                     m["n_in"])
    assert sqk.kernel_support(params, m["k"]) is None
    hist, qpos = _inputs(cuda, m["rows"], m["k"])
    n0 = sqk.fused_last_logit.launches
    z = _compare(params, hist, qpos)
    assert sqk.fused_last_logit.launches == n0 + 1
    assert float(z.std()) > 0.1
    # full histories, the steady state of a stream
    _compare(params, hist, torch.full_like(qpos, m["k"] - 1))


# (rows, k, n_heads, n_layers, d_ff, n_in): a ragged last tile, one and
# three layers, K 16 and 64 (two warps a row), a d_ff that is no multiple
# of 32, more event channels, one row
EDGES = [
    (1000 + 7, 32, 2, 2, 64, 8),
    (3001, 32, 2, 1, 64, 8),
    (3001, 32, 2, 3, 64, 8),
    (2049, 16, 2, 2, 64, 8),
    (2049, 64, 2, 2, 64, 8),
    (2049, 64, 2, 3, 128, 8),
    (1500, 32, 2, 2, 50, 8),
    (1500, 32, 2, 2, 96, 13),
    (1, 32, 2, 2, 64, 8),
]


@pytest.mark.parametrize("rows,k,n_heads,n_layers,d_ff,n_in", EDGES)
def test_kernel_matches_plain_at_the_edges(cuda, rows, k, n_heads,
                                           n_layers, d_ff, n_in):
    params = _params(cuda, n_heads, n_layers, d_ff, n_in, seed=rows)
    assert sqk.kernel_support(params, k) is None
    hist, qpos = _inputs(cuda, rows, k, n_in, seed=k)
    _compare(params, hist, qpos)
    _compare(params, hist, torch.zeros_like(qpos))
    _compare(params, hist, torch.full_like(qpos, k - 1))


def test_kernel_replays_in_a_graph_and_reads_swapped_params(cuda):
    """Captured once, replayed: the same logits as an eager launch; after
    the leaves are overwritten in place (what ``swap_params`` does for a
    swap of the same form) a replay computes with the new values."""
    params = _params(cuda)
    other = _params(cuda, seed=7)
    hist, qpos = _inputs(cuda, 4096, 32)
    eager = sqk.fused_last_logit(params, hist, qpos)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        sqk.fused_last_logit(params, hist, qpos)  # warm the library
    torch.cuda.current_stream().wait_stream(s)
    graph = torch.cuda.CUDAGraph()
    c0 = sqk.fused_last_logit.captured
    with torch.cuda.graph(graph):
        out = sqk.fused_last_logit(params, hist, qpos)
    assert sqk.fused_last_logit.captured == c0 + 1
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for dst, src in zip(tree.leaves(params), tree.leaves(other)):
        dst.copy_(src)
    graph.replay()
    torch.cuda.synchronize()
    want = transformer_last_logit(other, hist, qpos)
    assert float((out - want).abs().max()) <= ATOL_LOGIT
    assert not torch.equal(out, eager)


def _batches(n_batches=3, rows=1000, seed=5):
    rng = np.random.default_rng(seed)
    out = []
    for d in range(n_batches):
        out.append({
            "tx_id": np.arange(d * rows, (d + 1) * rows, dtype=np.int64),
            "tx_datetime_us": (np.full(rows, 20200 + d, np.int64) * 86400
                               + rng.integers(0, 86400, rows)) * 1_000_000,
            "customer_id": rng.integers(0, 200, rows).astype(np.int64),
            "terminal_id": rng.integers(0, 300, rows).astype(np.int64),
            "tx_amount_cents": (rng.integers(1, 500, rows) * 100)
            .astype(np.int64),
            "kafka_ts_ms": np.zeros(rows, np.int64),
            "label": np.full(rows, -1, np.int32)})
    return out


def test_engine_swap_between_replays_reaches_the_kernel(cuda):
    """A precompiled sequence engine on the card and a CPU engine serve
    the same batches with a swap of the same form between them: the
    graphs are kept (no recapture), each replay launches the kernel once,
    every row is counted on the fused path, and the probabilities agree
    before and after the swap."""
    cfg = Config(features=FeatureConfig(customer_capacity=256,
                                        terminal_capacity=256,
                                        history_len=32),
                 runtime=RuntimeConfig(batch_buckets=(1024,)))
    batches = _batches()
    scaler = {d: Scaler(torch.zeros(15, device=d), torch.ones(15, device=d))
              for d in ("cpu", cuda)}
    probs = {}
    for dev in ("cpu", cuda):
        eng = ScoringEngine(cfg, "sequence", _params(dev), scaler[dev],
                            device=dev, metrics=MetricsRegistry())
        if dev != "cpu":
            assert eng._seq_path == "fused"
            eng.precompile()
            n0 = sqk.fused_last_logit.launches
        got = [eng.process_batch(dict(batches[0])).probs]
        eng.swap_params(_params(dev, seed=11))
        got += [eng.process_batch(dict(b)).probs for b in batches[1:]]
        probs[str(dev)] = got
        if dev != "cpu":
            assert eng._captures.recaptures == 0
            assert sqk.fused_last_logit.launches - n0 == len(batches)
            reg = eng.metrics
            fused = reg.get(SEQUENCE_ROWS, path="fused")
            plain = reg.get(SEQUENCE_ROWS, path="plain")
            assert fused.value == sum(len(b["tx_id"]) for b in batches)
            assert plain.value == 0
    for a, b in zip(probs["cpu"], probs[str(cuda)]):
        np.testing.assert_allclose(b, a, atol=ATOL_PROB)


def test_wrapper_refuses_what_the_kernel_does_not_take(cuda):
    hist, qpos = _inputs(cuda, 64, 32)
    wide = init_transformer(d_model=64, n_heads=2, device=cuda)
    with pytest.raises(ValueError, match="d_model"):
        sqk.fused_last_logit(wide, torch.zeros(64, 32, 8, device=cuda),
                             qpos)
    four = init_transformer(d_model=32, n_heads=4, device=cuda)
    with pytest.raises(ValueError, match="n_heads"):
        sqk.fused_last_logit(four, hist, qpos)
    params = _params(cuda)
    with pytest.raises(ValueError, match="history length"):
        sqk.fused_last_logit(params, torch.zeros(4, 65, 8, device=cuda),
                             torch.zeros(4, dtype=torch.int32, device=cuda))
    with pytest.raises(ValueError, match="hist"):
        sqk.fused_last_logit(params, hist.double(), qpos)
    with pytest.raises(ValueError, match="channels"):
        sqk.fused_last_logit(params, torch.zeros(64, 32, 9, device=cuda),
                             qpos)
    with pytest.raises(ValueError, match="qpos"):
        sqk.fused_last_logit(params, hist, qpos.float())
    half = tree.map(lambda t: t.half(), params)
    with pytest.raises(ValueError, match="float32"):
        sqk.fused_last_logit(half, hist, qpos)
    # a qpos off the row reads NaN, the rest of the batch is scored
    bad = qpos.clone()
    bad[3] = 32
    z = sqk.fused_last_logit(params, hist, bad)
    torch.cuda.synchronize()
    assert math.isnan(float(z[3]))
    keep = torch.arange(64, device=cuda) != 3
    want = transformer_last_logit(params, hist, qpos)
    assert float((z[keep] - want[keep]).abs().max()) <= ATOL_LOGIT
