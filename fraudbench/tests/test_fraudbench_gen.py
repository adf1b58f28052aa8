"""The generator repeats draw for draw per seed, and its laws are the
source simulator's as the port's ``data/generator.py`` draws them."""

import json

import numpy as np
import torch

from fraudbench.gen.simulator import Stream, Traffic
from fraudbench.harness import BENCH

SMALL = {**json.loads((BENCH / "traffic" / "cards64k.json").read_text()),
         "n_cards": 5000, "batch_rows": 10000, "warm_days": 20,
         "pool_days": 10}


def _traffic(**kw) -> Traffic:
    return Traffic.from_json({**SMALL, **kw})


def _cols(stream: Stream) -> dict:
    return {k: getattr(stream, k) for k in ("customer_id", "terminal_id",
                                            "tod_s", "amount_cents",
                                            "label")}


def test_same_seed_same_stream():
    a = _cols(Stream(_traffic(), 2 ** 31 + 12345, "cpu"))
    b = _cols(Stream(_traffic(), 2 ** 31 + 12345, "cpu"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_other_seed_other_stream():
    a = Stream(_traffic(), 7, "cpu")
    b = Stream(_traffic(), 8, "cpu")
    assert not np.array_equal(a.customer_id, b.customer_id)


def test_laws_are_the_sources():
    """At the source's own scale (5,000 cards, 10,000 terminals) the
    stream's rates, amounts, times and fraud share are those of the
    port's generator of the source's simulator."""
    from real_time_fraud_detection_system_tpu_torch.config import DataConfig
    from real_time_fraud_detection_system_tpu_torch.data.generator import (
        generate_dataset,
    )

    t = _traffic()
    st = Stream(t, 3, "cpu")
    days = t.warm_days + t.pool_days
    ref = generate_dataset(DataConfig(n_days=days, seed=3))[-1]
    ours = {"per_card_day": len(st.customer_id) / t.n_cards / days,
            "amount": st.amount_cents.mean() / 100,
            "amount_median": np.median(st.amount_cents) / 100,
            "tod": st.tod_s.mean(), "tod_std": st.tod_s.std(),
            "fraud": st.label.mean()}
    tod = ref.tx_time_seconds % 86400
    theirs = {"per_card_day": ref.n / 5000 / days,
              "amount": ref.amount_cents.mean() / 100,
              "amount_median": np.median(ref.amount_cents) / 100,
              "tod": tod.mean(), "tod_std": tod.std(),
              "fraud": ref.tx_fraud.mean()}
    # the source drops the ~3% of times drawn outside the day; a day here
    # holds the mean rate's rows
    assert abs(ours["per_card_day"] / theirs["per_card_day"] - 1) < 0.06
    for k in ("amount", "amount_median", "tod", "tod_std"):
        assert abs(ours[k] / theirs[k] - 1) < 0.03, (k, ours, theirs)
    assert abs(ours["fraud"] / theirs["fraud"] - 1) < 0.3, (ours, theirs)
    # the busiest card is no hot key: its rate is U(0, 4)'s at most
    counts = np.bincount(st.customer_id, minlength=t.n_cards)
    assert counts.max() / days < 8
    assert st.tod_s.min() >= 0 and st.tod_s.max() < 86400


def test_terminals_lie_within_the_radius():
    t = _traffic()
    gen = torch.Generator().manual_seed(11)
    from fraudbench.gen.simulator import _Places

    places = _Places(t, gen, "cpu")
    cards = torch.randint(0, t.n_cards, (20000,), generator=gen)
    cards = cards[places.has_terminal[cards]]
    term = places.terminals(cards, gen)
    d2 = (places.tx[term] - places.cx[cards]) ** 2 \
        + (places.ty[term] - places.cy[cards]) ** 2
    assert bool((d2 < t.radius ** 2).all())
    # uniform over the card's in-radius set: one card's draws cover it
    c = int(cards[0])
    within = torch.nonzero((places.tx - places.cx[c]) ** 2
                           + (places.ty - places.cy[c]) ** 2
                           < t.radius ** 2).flatten()
    draws = places.terminals(torch.full((200 * within.numel(),), c), gen)
    hist = torch.bincount(draws, minlength=t.n_terminals)[within]
    assert set(draws.unique().tolist()) == set(within.tolist())
    assert hist.min() > 100 and hist.max() < 310


def test_a_day_is_whole_batches():
    import pytest

    with pytest.raises(ValueError):
        _traffic(n_cards=5001)


def test_replayed_pool_keeps_days_going():
    t = _traffic(n_cards=2048, batch_rows=512, warm_days=3, pool_days=4)
    st = Stream(t, 3, "cpu")
    r, warm = t.batch_rows, t.warm_batches
    rows = st.device_rows(st.n_batches + 8, "cpu")
    days = rows["batch_day"].tolist()
    assert days == sorted(days) and days[-1] > days[st.n_batches - 1]
    # the pool's replay: the same cards, later days
    g = st.n_batches + 1
    np.testing.assert_array_equal(
        rows["customer_id"][g * r:(g + 1) * r].numpy(),
        st.customer_id[(warm + 1) * r:(warm + 2) * r])
    assert torch.equal(rows["amount"][:r], torch.from_numpy(
        (st.amount_cents[:r] / 100.0).astype(np.float32)))
