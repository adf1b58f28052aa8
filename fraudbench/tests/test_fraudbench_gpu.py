"""On the card: a short window of each cell through the whole harness,
``correct`` true and the control false. Skips without a card; run on the
chip with ``python -m pytest -m gpu fraudbench/tests``."""

import pytest
import torch

from fraudbench.harness import run_cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return "cuda"


@pytest.mark.gpu
def test_cell_on_the_card(card, small_cell):
    cell, small = small_cell
    out = run_cell(cell, 2 ** 31 + 5, 2.0, True, device=card,
                   overrides=small, control=True)
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0
    limits = {k: c["limit"] for k, c in out["checks"].items()}
    assert any(v > limits[k] for k, v in out["control"].items())
