"""Small sizes at which the benchmark's cells run on the CPU: the same
code as on the card, the program's plain path, at a few hundred rows a
batch. The forest's directory probes twice and holds its keys at load
at most one half, so keys miss admission; its windows span a few days
and its cards buy less than once a day, so cards that rest longer are
reclaimed in every window."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FOREST_SMALL = {
    "traffic": {"n_cards": 512, "tx_per_card_day": [0, 1],
                "batch_rows": 256, "warm_days": 24, "pool_days": 48},
    "features": {"customer_capacity": 512, "terminal_capacity": 1024,
                 "cms_width": 256, "keydir_probes": 2, "windows": [1, 2, 3],
                 "delay_days": 1},
    "runtime": {"batch_buckets": [256], "max_batch_rows": 256},
}
SEQUENCE_SMALL = {
    "traffic": {"n_cards": 2048, "batch_rows": 256, "warm_days": 1,
                "pool_days": 2},
    "features": {"customer_capacity": 2048, "terminal_capacity": 256},
    "runtime": {"batch_buckets": [256], "max_batch_rows": 256},
}
CELLS = {
    "forest_t100_exact.cards1m": FOREST_SMALL,
    "forest_t100_exact.cards64k": FOREST_SMALL,
    "sequence_k32.cards1m": SEQUENCE_SMALL,
}


@pytest.fixture(params=sorted(CELLS))
def small_cell(request):
    return request.param, CELLS[request.param]
