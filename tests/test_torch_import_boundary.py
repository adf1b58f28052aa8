"""The port stands alone: it imports neither jax nor the JAX package.

One check imports the port in a fresh interpreter where ``import jax``
fails, and serves a batch on the CPU; the other reads the port's sources
and ``chip_smoke.py`` for an import of jax or a dotted reference into the
JAX package.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "real_time_fraud_detection_system_tpu_torch"

_SERVE_WITHOUT_JAX = r"""
import sys
sys.modules["jax"] = None  # any import of jax now raises ImportError
import numpy as np
from real_time_fraud_detection_system_tpu_torch.config import (
    Config, DataConfig, FeatureConfig, RuntimeConfig)
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.io.sink import MemorySink
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble)
from real_time_fraud_detection_system_tpu_torch.models.scaler import (
    fit_scaler)
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    ScoringEngine)
from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
    ReplaySource)
import real_time_fraud_detection_system_tpu_torch.weights  # noqa: F401

cfg = Config(data=DataConfig(n_customers=40, n_terminals=80, n_days=10),
             features=FeatureConfig(customer_capacity=64,
                                    terminal_capacity=128),
             runtime=RuntimeConfig(batch_buckets=(256,)))
_, _, txs = generate_dataset(cfg.data)
eng = ScoringEngine(cfg, "forest", synthetic_ensemble(3, 3, device="cpu"),
                    fit_scaler(np.ones((2, 15)), device="cpu"), device="cpu")
sink = MemorySink()
stats = eng.run(ReplaySource(txs, 1_743_465_600, batch_rows=200), sink,
                max_batches=1)
assert stats["batches"] == 1 and len(sink.concat()["prediction"]) == 200
assert not any(m.split(".")[0] in ("jax", "real_time_fraud_detection_system_tpu")
               for m, mod in sys.modules.items() if mod is not None)
print("served without jax")
"""


def test_port_serves_a_batch_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr
    assert "served without jax" in proc.stdout


_FORBIDDEN = [
    re.compile(r"^\s*(import\s+jax|from\s+jax\b)", re.M),
    re.compile(r"real_time_fraud_detection_system_tpu\."),
]


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PORT.rglob("*")
           if p.suffix in (".py", ".cu") and "_build" not in p.parts)
    + ["chip_smoke.py"])
def test_sources_name_neither_jax_nor_the_jax_package(path):
    text = (ROOT / path).read_text()
    for pattern in _FORBIDDEN:
        assert not pattern.search(text), (path, pattern.pattern)
