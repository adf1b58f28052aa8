"""The benchmark's traffic generator: a stream of card transactions drawn
by the laws of the reference's simulator, made from a seed and a traffic
file's parameters.

The laws are those of ``fraud_detection_model/data_generator.ipynb``
(the Fraud Detection Handbook's simulator, as the port's
``data/generator.py`` states them):

- cards: a place ~ U(0, grid)^2, a mean amount ~ U(``mean_amount``), a
  standard deviation ``std_per_mean`` times it, a daily rate ~
  U(``tx_per_card_day``);
- terminals (``terminals_per_card`` per card): a place ~ U(0, grid)^2;
  a card buys at the terminals strictly within ``radius`` of it, each
  alike, and a card with none buys nothing;
- per day: each card's transactions by its rate (the day's rows are a
  fixed number, ``n_cards`` times the mean rate, each drawn to a card in
  proportion to its rate: Poisson counts conditioned on their sum); a
  time of day ~ Normal(``tod_mean_s``, ``tod_std_s``) kept inside the
  day; an amount ~ Normal(card's mean, card's deviation), a negative
  draw redrawn ~ U(0, 2 · mean), in cents; the day's rows in time order;
- fraud: an amount over ``fraud_amount_over``; each day
  ``fraud_terminals_per_10k`` of every 10,000 terminals compromised for
  ``fraud_terminal_days`` days (all their rows fraud); each day
  ``fraud_cards_per_5k`` of every 5,000 cards compromised for
  ``fraud_card_days`` days, each of their rows then fraud with
  probability ``fraud_card_share`` and its amount times
  ``fraud_card_amount_times`` (the source takes that share of them).

A day is ``day_every = n_cards · mean rate / batch_rows`` whole batches.
The draws run on ``device`` from one ``torch.Generator`` seeded with the
run's seed, one day at a time: the same seed and device give the same
stream.

A stream is ``warm_days`` days that set-up serves, then a pool of
``pool_days`` that the timed window replays. A window that outruns the
pool goes on through the pool again, its days shifted past the pool's
last and its ids past the stream's last (:meth:`Stream.cycle`), so the
stream never ends and never goes back in time.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

SECONDS_PER_DAY = 86400
# the most rounds of the terminal draw's rejection before it gives up
MAX_ROUNDS = 10_000


@dataclasses.dataclass(frozen=True)
class Traffic:
    """A traffic file's parameters (``fraudbench/traffic/<name>.json``)."""

    name: str
    n_cards: int
    terminals_per_card: float
    tx_per_card_day: tuple
    mean_amount: tuple
    std_per_mean: float
    tod_mean_s: float
    tod_std_s: float
    grid: float
    radius: float
    fraud_amount_over: float
    fraud_terminals_per_10k: float
    fraud_terminal_days: int
    fraud_cards_per_5k: float
    fraud_card_days: int
    fraud_card_share: float
    fraud_card_amount_times: float
    batch_rows: int
    day0: int
    warm_days: int
    pool_days: int
    rate_tx_per_s: Optional[float] = None

    @property
    def n_terminals(self) -> int:
        return max(int(round(self.n_cards * self.terminals_per_card)), 1)

    @property
    def rows_per_day(self) -> float:
        lo, hi = self.tx_per_card_day
        return self.n_cards * (lo + hi) / 2.0

    @property
    def day_every(self) -> int:
        return int(self.rows_per_day) // self.batch_rows

    @property
    def warm_batches(self) -> int:
        return self.warm_days * self.day_every

    @property
    def pool_batches(self) -> int:
        return self.pool_days * self.day_every

    @classmethod
    def from_json(cls, obj: dict) -> "Traffic":
        fields = {f.name for f in dataclasses.fields(cls)}
        extra = set(obj) - fields - {"why", "source"}
        if extra:
            raise ValueError(f"unknown traffic keys {sorted(extra)}")
        obj = {k: v for k, v in obj.items() if k in fields}
        for k in ("tx_per_card_day", "mean_amount"):
            obj[k] = tuple(obj[k])
        t = cls(**obj)
        if t.day_every < 1 or t.day_every * t.batch_rows != t.rows_per_day:
            raise ValueError("a day's rows (n_cards times the mean daily "
                             "rate) must be a whole number of batches")
        if t.rate_tx_per_s is not None:
            raise ValueError("an open-loop rate is not served yet: "
                             "rate_tx_per_s must be null (saturating)")
        return t


def _uniform(gen, n, lo, hi, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=gen, dtype=torch.float64,
                                       device=device)


class _Places:
    """Cards' and terminals' places, and the draw of a terminal uniform
    over those strictly within ``radius`` of a card: a candidate uniform
    over the terminals of the 3 × 3 grid cells (side ``radius``) around
    the card, kept if within the radius, drawn again if not."""

    def __init__(self, t: Traffic, gen, device):
        n, m, r = t.n_cards, t.n_terminals, t.radius
        self.r2 = r * r
        self.cx = _uniform(gen, n, 0.0, t.grid, device)
        self.cy = _uniform(gen, n, 0.0, t.grid, device)
        self.tx = _uniform(gen, m, 0.0, t.grid, device)
        self.ty = _uniform(gen, m, 0.0, t.grid, device)
        side = max(int(math.ceil(t.grid / r)), 1)

        def cell(x, y):
            i = (x / r).floor().long().clamp_(0, side - 1)
            j = (y / r).floor().long().clamp_(0, side - 1)
            return i, j

        ti, tj = cell(self.tx, self.ty)
        tcell = ti * side + tj
        self.by_cell = torch.argsort(tcell, stable=True)
        count = torch.bincount(tcell, minlength=side * side)
        self.start = torch.cumsum(count, 0) - count
        ci, cj = cell(self.cx, self.cy)
        d = torch.tensor([-1, 0, 1], device=device)
        ni = ci[:, None, None] + d[None, :, None]
        nj = cj[:, None, None] + d[None, None, :]
        inside = ((ni >= 0) & (ni < side) & (nj >= 0) & (nj < side)) \
            .reshape(n, 9)
        ncell = (ni.clamp(0, side - 1) * side
                 + nj.clamp(0, side - 1)).reshape(n, 9)
        # per card: its 9 neighbour cells and their running counts
        self.ncell = ncell.to(torch.int32)
        self.ncount = torch.where(inside, count[ncell], 0).to(torch.int32)
        self.ncum = torch.cumsum(self.ncount, 1, dtype=torch.int64)
        self.has_terminal = self._has_terminal(t.grid, device)

    def _has_terminal(self, grid: float, device) -> torch.Tensor:
        """Whether each card has a terminal strictly within the radius.
        A card whose own cell of side ``radius / 2`` holds a terminal has
        one (the cell's diagonal is under the radius); every other card
        is tested against every terminal."""
        half = self.r2 ** 0.5 / 2.0
        side = int(math.ceil(grid / half)) + 1

        def fine(x, y):
            return (x / half).floor().long() * side + (y / half).floor().long()

        occupied = torch.zeros(side * side, dtype=torch.bool, device=device)
        occupied[fine(self.tx, self.ty)] = True
        has = occupied[fine(self.cx, self.cy)]
        rest = torch.nonzero(~has).flatten()
        for s in range(0, rest.numel(), 1024):
            c = rest[s:s + 1024]
            d2 = ((self.cx[c, None] - self.tx[None, :]) ** 2
                  + (self.cy[c, None] - self.ty[None, :]) ** 2)
            has[c] = (d2 < self.r2).any(1)
        return has

    def terminals(self, card: torch.Tensor, gen) -> torch.Tensor:
        """A terminal for each row's card (every card has one within the
        radius)."""
        out = torch.empty_like(card)
        todo = torch.arange(card.shape[0], device=card.device)
        for _ in range(MAX_ROUNDS):
            if not todo.numel():
                return out
            c = card[todo]
            cum = self.ncum[c]
            total = cum[:, -1]
            k = (torch.rand(c.shape[0], generator=gen, dtype=torch.float64,
                            device=c.device) * total).long()
            k = torch.minimum(k, total - 1)
            slot = (cum <= k[:, None]).sum(1, keepdim=True)
            before = cum.gather(1, slot) - self.ncount[c].gather(1, slot)
            cellid = self.ncell[c].gather(1, slot).long()
            pos = self.start[cellid] + (k[:, None] - before)
            term = self.by_cell[pos[:, 0]]
            d2 = (self.tx[term] - self.cx[c]) ** 2 \
                + (self.ty[term] - self.cy[c]) ** 2
            ok = d2 < self.r2
            out[todo[ok]] = term[ok]
            todo = todo[~ok]
        raise RuntimeError("the terminal draw did not settle")


class Stream:
    """The whole generated stream as host columns (numpy), in batch
    order: ``customer_id``, ``terminal_id``, ``tod_s``, ``amount_cents``
    (int64), ``label`` (int8), over ``n_batches`` batches of
    ``batch_rows`` rows; ``batch_day`` per batch. Row ``i`` has
    ``tx_id = i``."""

    def __init__(self, traffic: Traffic, seed: int, device):
        t = traffic
        self.traffic = t
        self.n_batches = t.warm_batches + t.pool_batches
        n_days = t.warm_days + t.pool_days
        per_day = t.day_every * t.batch_rows
        n = self.n_batches * t.batch_rows
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 63))
        n_cards, n_term = t.n_cards, t.n_terminals
        rate = _uniform(gen, n_cards, *t.tx_per_card_day, device)
        mean = _uniform(gen, n_cards, *t.mean_amount, device)
        std = mean * t.std_per_mean
        places = _Places(t, gen, device)
        rate = torch.where(places.has_terminal, rate, 0.0)
        cdf = torch.cumsum(rate, 0)
        cdf = cdf / cdf[-1]
        mu, sd = t.tod_mean_s, t.tod_std_s
        phi = [0.5 * math.erfc(-(x - mu) / (sd * math.sqrt(2.0)))
               for x in (0.0, float(SECONDS_PER_DAY))]
        k_term = max(int(round(t.fraud_terminals_per_10k * n_term / 1e4)), 1)
        k_card = max(int(round(t.fraud_cards_per_5k * n_cards / 5e3)), 1)
        term_until = torch.full((n_term,), -1, dtype=torch.int64,
                                device=device)
        card_until = torch.full((n_cards,), -1, dtype=torch.int64,
                                device=device)
        over = int(round(t.fraud_amount_over * 100))

        self.customer_id = np.empty(n, np.int64)
        self.terminal_id = np.empty(n, np.int64)
        self.tod_s = np.empty(n, np.int32)
        self.amount_cents = np.empty(n, np.int64)
        self.label = np.empty(n, np.int8)
        for d in range(n_days):
            term_until[torch.randperm(n_term, generator=gen,
                                      device=device)[:k_term]] = \
                d + t.fraud_terminal_days - 1
            card_until[torch.randperm(n_cards, generator=gen,
                                      device=device)[:k_card]] = \
                d + t.fraud_card_days - 1
            u = torch.rand(per_day, generator=gen, dtype=torch.float64,
                           device=device)
            card = torch.searchsorted(cdf, u, right=True).clamp_(
                max=n_cards - 1)
            u = phi[0] + (phi[1] - phi[0]) * torch.rand(
                per_day, generator=gen, dtype=torch.float64, device=device)
            tod = (mu + sd * math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)) \
                .floor().clamp_(0, SECONDS_PER_DAY - 1).to(torch.int32)
            tod, order = torch.sort(tod, stable=True)
            card = card[order]
            amount = mean[card] + std[card] * torch.randn(
                per_day, generator=gen, dtype=torch.float64, device=device)
            redraw = 2.0 * mean[card] * torch.rand(
                per_day, generator=gen, dtype=torch.float64, device=device)
            amount = torch.where(amount < 0, redraw, amount)
            cents = torch.round(amount * 100.0).to(torch.int64)
            term = places.terminals(card, gen)
            label = (cents > over) | (term_until[term] >= d)
            hit = (card_until[card] >= d) & (torch.rand(
                per_day, generator=gen, device=device) < t.fraud_card_share)
            cents = torch.where(
                hit, torch.round(cents.double() * t.fraud_card_amount_times)
                .to(torch.int64), cents)
            label |= hit
            rows = slice(d * per_day, (d + 1) * per_day)
            self.customer_id[rows] = card.cpu().numpy()
            self.terminal_id[rows] = term.cpu().numpy()
            self.tod_s[rows] = tod.cpu().numpy()
            self.amount_cents[rows] = cents.cpu().numpy()
            self.label[rows] = label.to(torch.int8).cpu().numpy()
        self.batch_day = (t.day0 + np.arange(self.n_batches, dtype=np.int64)
                          // t.day_every)

    @property
    def batch_rows(self) -> int:
        return self.traffic.batch_rows

    def cycle(self, c: int) -> dict:
        """The pool's ``c``-th replay (c ≥ 1): its first global batch and
        the shift of its days (its tx ids are global: batch g holds ids
        ``[g · batch_rows, (g + 1) · batch_rows)``)."""
        t = self.traffic
        return {"first_batch": self.n_batches + (c - 1) * t.pool_batches,
                "day_shift": c * t.pool_days}

    def batch_of_global(self, g: int) -> tuple:
        """Global batch ``g`` → (stored batch, day shift)."""
        t = self.traffic
        if g < self.n_batches:
            return g, 0
        c = 1 + (g - self.n_batches) // t.pool_batches
        sh = self.cycle(c)
        return t.warm_batches + (g - sh["first_batch"]), sh["day_shift"]

    def device_rows(self, g_last: int, device) -> dict:
        """Every row of global batches ``[0, g_last]`` as tensors on
        ``device``, for the reference: ``customer_id``, ``terminal_id``
        (int64), ``tod_s``, ``day`` (int64), ``amount`` (the float32
        dollars the program packs: ``cents / 100`` in float64, then
        float32), ``label`` (int64); ``batch_day`` (int64 [g_last + 1])
        and ``batch_rows``."""
        r = self.batch_rows
        stored = min(g_last + 1, self.n_batches)
        up = {k: torch.from_numpy(getattr(self, k)[:stored * r]).to(device)
              for k in ("customer_id", "terminal_id", "tod_s",
                        "amount_cents", "label")}
        days = [int(self.batch_day[g]) for g in range(stored)]
        parts = {k: [v] for k, v in up.items()}
        g = stored
        while g <= g_last:
            b, shift = self.batch_of_global(g)
            n = min(g_last + 1 - g, self.n_batches - b)
            for k, v in up.items():
                parts[k].append(v[b * r:(b + n) * r])
            days += [int(self.batch_day[b + j]) + shift for j in range(n)]
            g += n
        cols = {k: torch.cat(v) if len(v) > 1 else v[0]
                for k, v in parts.items()}
        batch_day = torch.tensor(days, dtype=torch.int64, device=device)
        return {
            "customer_id": cols["customer_id"].to(torch.int64),
            "terminal_id": cols["terminal_id"].to(torch.int64),
            "tod_s": cols["tod_s"].to(torch.int64),
            "amount": (cols["amount_cents"].to(torch.float64) / 100.0)
            .to(torch.float32),
            "label": cols["label"].to(torch.int64),
            "day": batch_day.repeat_interleave(r),
            "batch_day": batch_day,
            "batch_rows": r,
        }
