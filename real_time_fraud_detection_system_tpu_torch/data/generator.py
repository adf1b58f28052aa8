"""Synthetic transaction generator (benchmark load source + training data).

Capability match for the reference simulator
(``fraud_detection_model/data_generator.ipynb``, Fraud-Detection-Handbook
style), with identical distributions and fraud-scenario semantics:

- customer profiles: location ~ U(0,100)^2, ``mean_amount`` ~ U(5,100),
  ``std_amount = mean/2``, ``mean_nb_tx_per_day`` ~ U(0,4)  (· "cell 4");
- terminal profiles: location ~ U(0,100)^2  (· "cell 8");
- customer↔terminal association by Euclidean radius ``r``  (· "cell 12");
- per (customer, day): Poisson(mean_nb_tx) transactions, time ~
  Normal(noon, 20000 s) kept iff within the day, amount ~ Normal(mean, std)
  with negative redraw ~ U(0, 2·mean), terminal uniform over the customer's
  in-radius set  (· "cell 24");
- fraud scenarios (· "cell 42"):
  1. amount > 220 ⇒ fraud;
  2. each day, 2 random terminals compromised for the next 28 days;
  3. each day, 3 random customers compromised for 14 days, ⅓ of their
     transactions get amount ×5 and are marked fraud.

A numpy-only copy of ``real_time_fraud_detection_system_tpu/data/generator.py``
(same draws from the same seed, so both packages replay one dataset).
The implementation is columnar: one vectorized NumPy pass
instead of the reference's per-customer/per-day Python loops, so generating
the full 5000×10000×245-day dataset takes seconds and can feed the benchmark
harness at line rate. Amounts are kept as **int64 cents** end-to-end
(DECIMAL(10,2) fidelity — never silently f32 money).

RNG note: we use ``np.random.default_rng`` streams (PCG64) rather than the
reference's legacy per-customer ``np.random.seed`` — draws are reproducible
under our own seeds but not bit-identical to the reference (the reference
publishes no dataset artifact to match anyway).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from real_time_fraud_detection_system_tpu_torch.config import DataConfig

SECONDS_PER_DAY = 86400
NOON = SECONDS_PER_DAY // 2
TIME_STD = 20000.0


@dataclass
class CustomerProfiles:
    customer_id: np.ndarray  # int64 [C]
    x: np.ndarray  # float64 [C]
    y: np.ndarray  # float64 [C]
    mean_amount: np.ndarray  # float64 [C]
    std_amount: np.ndarray  # float64 [C]
    mean_nb_tx_per_day: np.ndarray  # float64 [C]
    # CSR layout of the in-radius terminal sets
    available_terminals: np.ndarray  # int64 flat indices
    available_offsets: np.ndarray  # int64 [C+1]

    @property
    def n(self) -> int:
        return int(self.customer_id.shape[0])

    def n_terminals_of(self, c: int) -> int:
        return int(self.available_offsets[c + 1] - self.available_offsets[c])


@dataclass
class TerminalProfiles:
    terminal_id: np.ndarray  # int64 [T]
    x: np.ndarray  # float64 [T]
    y: np.ndarray  # float64 [T]

    @property
    def n(self) -> int:
        return int(self.terminal_id.shape[0])


@dataclass
class Transactions:
    """Columnar transaction table, sorted chronologically.

    ``tx_id`` is the row index after the chronological sort, exactly like the
    reference's ``TRANSACTION_ID`` (· generate_dataset).
    """

    tx_id: np.ndarray  # int64 [N]
    tx_time_seconds: np.ndarray  # int64 [N], seconds since start_date
    tx_time_days: np.ndarray  # int32 [N]
    customer_id: np.ndarray  # int64 [N]
    terminal_id: np.ndarray  # int64 [N]
    amount_cents: np.ndarray  # int64 [N]
    tx_fraud: np.ndarray  # int8 [N]
    tx_fraud_scenario: np.ndarray  # int8 [N]

    @property
    def n(self) -> int:
        return int(self.tx_id.shape[0])

    @property
    def amount(self) -> np.ndarray:
        """Amounts as float64 dollars (for model features / metrics only)."""
        return self.amount_cents.astype(np.float64) / 100.0

    def epoch_us(self, start_epoch_s: int) -> np.ndarray:
        """µs-since-unix-epoch timestamps (the Debezium wire unit)."""
        return (start_epoch_s + self.tx_time_seconds) * 1_000_000

    def slice(self, mask_or_idx) -> "Transactions":
        return Transactions(*[getattr(self, f)[mask_or_idx]
                              for f in ("tx_id", "tx_time_seconds", "tx_time_days",
                                        "customer_id", "terminal_id", "amount_cents",
                                        "tx_fraud", "tx_fraud_scenario")])

    def to_pandas(self, start_date: str = "2025-04-01"):
        """The table as the reference's DataFrame columns (pandas is
        imported here, only when this is called)."""
        import pandas as pd

        ts = pd.to_datetime(self.tx_time_seconds, unit="s", origin=start_date)
        return pd.DataFrame(
            {
                "TRANSACTION_ID": self.tx_id,
                "TX_DATETIME": ts,
                "CUSTOMER_ID": self.customer_id,
                "TERMINAL_ID": self.terminal_id,
                "TX_AMOUNT": self.amount,
                "TX_TIME_SECONDS": self.tx_time_seconds,
                "TX_TIME_DAYS": self.tx_time_days,
                "TX_FRAUD": self.tx_fraud.astype(np.int64),
                "TX_FRAUD_SCENARIO": self.tx_fraud_scenario.astype(np.int64),
            }
        )


def generate_customer_profiles(n_customers: int, seed: int = 0) -> CustomerProfiles:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0xC057]))
    x = rng.uniform(0, 100, n_customers)
    y = rng.uniform(0, 100, n_customers)
    mean_amount = rng.uniform(5, 100, n_customers)
    return CustomerProfiles(
        customer_id=np.arange(n_customers, dtype=np.int64),
        x=x,
        y=y,
        mean_amount=mean_amount,
        std_amount=mean_amount / 2.0,
        mean_nb_tx_per_day=rng.uniform(0, 4, n_customers),
        available_terminals=np.zeros(0, dtype=np.int64),
        available_offsets=np.zeros(n_customers + 1, dtype=np.int64),
    )


def generate_terminal_profiles(n_terminals: int, seed: int = 0) -> TerminalProfiles:
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7E12]))
    return TerminalProfiles(
        terminal_id=np.arange(n_terminals, dtype=np.int64),
        x=rng.uniform(0, 100, n_terminals),
        y=rng.uniform(0, 100, n_terminals),
    )


def associate_terminals(
    customers: CustomerProfiles, terminals: TerminalProfiles, radius: float,
    block: int = 1024,
) -> CustomerProfiles:
    """Fill the CSR (available_terminals, available_offsets) in-radius sets.

    Blocked distance computation keeps peak memory at block×T instead of C×T.
    """
    tx = terminals.x
    ty = terminals.y
    counts = np.zeros(customers.n, dtype=np.int64)
    chunks = []
    for s in range(0, customers.n, block):
        e = min(s + block, customers.n)
        d2 = (customers.x[s:e, None] - tx[None, :]) ** 2 + (
            customers.y[s:e, None] - ty[None, :]
        ) ** 2
        within = d2 < radius * radius
        counts[s:e] = within.sum(axis=1)
        rows, cols = np.nonzero(within)
        # rows are already sorted, so cols are grouped per customer in order
        chunks.append(cols.astype(np.int64))
    offsets = np.zeros(customers.n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    customers.available_terminals = (
        np.concatenate(chunks) if chunks else np.zeros(0, dtype=np.int64)
    )
    customers.available_offsets = offsets
    return customers


def generate_transactions(
    customers: CustomerProfiles, n_days: int, seed: int = 0
) -> Transactions:
    """Vectorized transaction synthesis over all (customer, day) pairs."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, 0x7A3B]))
    C = customers.n

    # Number of txs per (customer, day): Poisson(mean_nb_tx_per_day).
    lam = np.broadcast_to(customers.mean_nb_tx_per_day[:, None], (C, n_days))
    nb_tx = rng.poisson(lam)  # [C, D]
    # Customers with no in-radius terminal produce no transactions
    # (reference keeps a tx only when available_terminals is non-empty).
    n_avail = np.diff(customers.available_offsets)
    nb_tx[n_avail == 0, :] = 0

    per_pair = nb_tx.ravel()  # [C*D]
    total = int(per_pair.sum())
    cust = np.repeat(np.arange(C, dtype=np.int64), nb_tx.sum(axis=1))
    day = np.repeat(
        np.broadcast_to(np.arange(n_days, dtype=np.int32), (C, n_days)).ravel(),
        per_pair,
    )

    # Time of day ~ Normal(noon, 20000 s); out-of-day draws are DISCARDED
    # (reference filters, not clips — keeps the same diurnal shape).
    tod = rng.normal(NOON, TIME_STD, total)
    keep = (tod > 0) & (tod < SECONDS_PER_DAY)

    cust = cust[keep]
    day = day[keep]
    tod = tod[keep].astype(np.int64)
    total = cust.shape[0]

    # Amount ~ Normal(mean, std) per customer; negatives redrawn U(0, 2*mean).
    mean = customers.mean_amount[cust]
    amount = rng.normal(mean, customers.std_amount[cust])
    neg = amount < 0
    amount[neg] = rng.uniform(0.0, 2.0 * mean[neg])
    amount_cents = np.round(amount * 100.0).astype(np.int64)

    # Terminal: uniform over the customer's in-radius CSR slice.
    lo = customers.available_offsets[cust]
    hi = customers.available_offsets[cust + 1]
    pick = lo + rng.integers(0, np.maximum(hi - lo, 1))
    terminal = customers.available_terminals[pick] if total else np.zeros(0, np.int64)

    t_seconds = day.astype(np.int64) * SECONDS_PER_DAY + tod
    order = np.argsort(t_seconds, kind="stable")
    return Transactions(
        tx_id=np.arange(total, dtype=np.int64),
        tx_time_seconds=t_seconds[order],
        tx_time_days=day[order].astype(np.int32),
        customer_id=cust[order],
        terminal_id=terminal[order],
        amount_cents=amount_cents[order],
        tx_fraud=np.zeros(total, dtype=np.int8),
        tx_fraud_scenario=np.zeros(total, dtype=np.int8),
    )


def add_frauds(
    customers: CustomerProfiles,
    terminals: TerminalProfiles,
    txs: Transactions,
    cfg: DataConfig = DataConfig(),
) -> Transactions:
    """Apply the three fraud scenarios in-place (same precedence as reference:
    later scenarios overwrite earlier labels on overlapping rows)."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, 0xF4A0]))
    n_days = int(txs.tx_time_days.max()) + 1 if txs.n else 0

    # Scenario 1: amount > threshold.
    thresh_cents = int(round(cfg.scenario1_amount_threshold * 100))
    s1 = txs.amount_cents > thresh_cents
    txs.tx_fraud[s1] = 1
    txs.tx_fraud_scenario[s1] = 1

    # Scenario 2: per start-day compromised terminals for a 28-day span.
    # Vectorized: build per-terminal compromise intervals, then interval test.
    # terminal_compromised[t] holds start days; a tx at (t, d) is fraud iff
    # some start s satisfies s <= d < s + span.
    span2 = cfg.scenario2_compromise_days
    starts2 = np.empty((n_days, cfg.scenario2_terminals_per_day), dtype=np.int64)
    for d in range(n_days):
        starts2[d] = rng.choice(terminals.n, cfg.scenario2_terminals_per_day,
                                replace=False)
    # Map terminal -> sorted list of compromise start days.
    comp_term = starts2.ravel()
    comp_day = np.repeat(np.arange(n_days, dtype=np.int64),
                         cfg.scenario2_terminals_per_day)
    s2_mask = _interval_membership(txs.terminal_id, txs.tx_time_days,
                                   comp_term, comp_day, span2)
    txs.tx_fraud[s2_mask] = 1
    txs.tx_fraud_scenario[s2_mask] = 2

    # Scenario 3: per start-day compromised customers for a 14-day span;
    # a random third of their txs in the window get amount x5 + fraud.
    span3 = cfg.scenario3_compromise_days
    mult = cfg.scenario3_amount_multiplier
    for d in range(n_days):
        comp_cust = rng.choice(customers.n, cfg.scenario3_customers_per_day,
                               replace=False)
        in_window = (
            (txs.tx_time_days >= d)
            & (txs.tx_time_days < d + span3)
            & np.isin(txs.customer_id, comp_cust)
        )
        idx = np.nonzero(in_window)[0]
        k = int(len(idx) * cfg.scenario3_fraction)
        if k == 0:
            continue
        chosen = rng.choice(idx, size=k, replace=False)
        txs.amount_cents[chosen] = (txs.amount_cents[chosen] * mult).astype(np.int64)
        txs.tx_fraud[chosen] = 1
        txs.tx_fraud_scenario[chosen] = 3
    return txs


def _interval_membership(
    keys: np.ndarray, days: np.ndarray,
    comp_keys: np.ndarray, comp_starts: np.ndarray, span: int,
) -> np.ndarray:
    """mask[i] = any(comp_keys==keys[i] and comp_starts<=days[i]<comp_starts+span).

    Sort compromises by (key, start) and for each tx binary-search the key's
    slice, then check whether any start falls in (day-span, day].
    """
    order = np.lexsort((comp_starts, comp_keys))
    ck = comp_keys[order]
    cs = comp_starts[order]
    # Slice boundaries per key value
    left = np.searchsorted(ck, keys, side="left")
    right = np.searchsorted(ck, keys, side="right")
    # Within [left, right), starts are sorted: need any start in (day-span, day]
    lo = np.empty_like(left)
    hi = np.empty_like(left)
    # Positions of the bounds inside the global sorted starts restricted to the
    # key slice: since cs is sorted within each key slice, use per-row search.
    # Vectorized via searchsorted on the full array with offsets is incorrect
    # across slice boundaries, so clamp results into [left, right).
    # Number of starts <= day within slice:
    hi = _searchsorted_within(cs, keys_left=left, keys_right=right,
                              values=days, side="right")
    lo = _searchsorted_within(cs, keys_left=left, keys_right=right,
                              values=days - span, side="right")
    return hi > lo


def _searchsorted_within(
    sorted_vals: np.ndarray, keys_left: np.ndarray, keys_right: np.ndarray,
    values: np.ndarray, side: str,
) -> np.ndarray:
    """Per-row searchsorted of values[i] into sorted_vals[keys_left[i]:keys_right[i]].

    Implemented as a branchless vectorized binary search (≈log2(max slice)
    iterations over all rows at once).
    """
    lo = keys_left.astype(np.int64).copy()
    hi = keys_right.astype(np.int64).copy()
    max_len = int(np.max(keys_right - keys_left)) if len(keys_left) else 0
    iters = max(1, int(np.ceil(np.log2(max_len + 1))) + 1)
    for _ in range(iters):
        mid = (lo + hi) // 2
        active = lo < hi
        mv = sorted_vals[np.minimum(mid, len(sorted_vals) - 1)]
        if side == "right":
            go_right = mv <= values
        else:
            go_right = mv < values
        lo = np.where(active & go_right, mid + 1, lo)
        hi = np.where(active & ~go_right, mid, hi)
    return lo


class ZipfKeySampler:
    """Bounded Zipf(s) key sampler over ``[0, n_keys)`` — the 10M-key
    skewed-corpus mode for feature-state scale runs (the port's copy of
    the JAX package's, draw for draw).

    Real traffic over millions of customers is heavy-tailed: a small hot
    set produces most rows while the long tail trickles. ``P(rank k) ∝
    1/k^skew`` with exact inverse-CDF sampling (one float64 cumsum built
    once, ``searchsorted`` per draw — ~80 MB at 10M keys, no rejection
    distortion like clipped ``np.random.zipf``). ``skew=0`` degenerates
    to uniform. Rank r maps to key ``(r * STRIDE) % n_keys`` (an odd
    stride coprime to any pow2-adjacent universe), so the hot set is
    scattered across the id space instead of sitting in the low ids a
    ``direct``-mode table would accidentally favor.

    Universes past ``_EXACT_MAX`` (16.7M) keep the exact CDF for the
    head ranks only (where essentially all per-rank mass sits) and draw
    tail ranks from the continuous power-law inverse CDF — the 100M-key
    cold-tier benchmark would otherwise pay an 800 MB float64 cumsum
    for ranks whose individual probabilities are < 1e-9.
    """

    _STRIDE = 2654435761  # Knuth multiplicative-hash constant (odd)
    _EXACT_MAX = 1 << 24

    def __init__(self, n_keys: int, skew: float = 1.1):
        if n_keys < 1:
            raise ValueError(f"n_keys must be >= 1, got {n_keys}")
        if skew < 0:
            raise ValueError(f"skew must be >= 0, got {skew}")
        self.n_keys = int(n_keys)
        self.skew = float(skew)
        head = min(self.n_keys, self._EXACT_MAX)
        self._head = head
        w = 1.0 / np.power(np.arange(1, head + 1, dtype=np.float64),
                           skew)
        cdf = np.cumsum(w)
        if self.n_keys > head:
            # tail mass via the continuous integral of x^-skew over
            # (head+1/2, n_keys+1/2] — the midpoint-corrected analogue
            # of the discrete sum
            a, b = head + 0.5, self.n_keys + 0.5
            if abs(skew - 1.0) < 1e-12:
                tail = np.log(b) - np.log(a)
            else:
                e = 1.0 - skew
                tail = (b ** e - a ** e) / e
            total = cdf[-1] + tail
            self._head_frac = cdf[-1] / total
            cdf = cdf / total
        else:
            self._head_frac = 1.0
            cdf = cdf / cdf[-1]
        self._cdf = cdf

    def _tail_ranks(self, u: np.ndarray) -> np.ndarray:
        """Continuous inverse CDF over the tail ranks: ``u`` uniform in
        [0, 1) → 0-based ranks in [head, n_keys)."""
        a, b = self._head + 0.5, self.n_keys + 0.5
        if abs(self.skew - 1.0) < 1e-12:
            x = a * np.power(b / a, u)
        else:
            e = 1.0 - self.skew
            x = np.power(a ** e + u * (b ** e - a ** e), 1.0 / e)
        return np.clip(x.astype(np.int64), self._head, self.n_keys - 1)

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Draw ``n`` keys (int64 [n]) in ``[0, n_keys)``."""
        u = rng.random(n)
        ranks = np.searchsorted(self._cdf, u, side="left")
        if self._head_frac < 1.0:
            in_tail = u >= self._head_frac
            if in_tail.any():
                v = (u[in_tail] - self._head_frac) \
                    / (1.0 - self._head_frac)
                ranks[in_tail] = self._tail_ranks(v)
        return (ranks.astype(np.int64) * self._STRIDE) % self.n_keys


def zipf_stream_cols(
    rng: np.random.Generator,
    n: int,
    customers: ZipfKeySampler,
    n_terminals: int,
    day: int,
    tx_id_start: int = 0,
) -> dict:
    """One micro-batch of engine-ready columns from a Zipf-skewed key
    universe (the ``bench.py detail.state_scale`` load shape): customer
    keys from ``customers``, terminals Zipf-skewed over ``n_terminals``
    with the same exponent, timestamps uniform inside ``day``."""
    cust = customers.sample(rng, n)
    term = (cust * 1_000_003 + rng.integers(0, max(n_terminals // 16, 1),
                                            n)) % n_terminals
    us = ((day * SECONDS_PER_DAY
           + rng.integers(0, SECONDS_PER_DAY, n)).astype(np.int64)
          * 1_000_000)
    return {
        "tx_id": np.arange(tx_id_start, tx_id_start + n, dtype=np.int64),
        "tx_datetime_us": us,
        "customer_id": cust,
        "terminal_id": term.astype(np.int64),
        "tx_amount_cents": rng.integers(100, 50000, n).astype(np.int64),
        "kafka_ts_ms": us // 1000,
    }


def generate_dataset(cfg: DataConfig = DataConfig()):
    """Full pipeline: profiles → association → transactions → frauds.

    Returns ``(customers, terminals, transactions)`` — the same triple as the
    reference's ``generate_dataset`` (· data_generator.ipynb).
    """
    customers = generate_customer_profiles(cfg.n_customers, cfg.seed)
    terminals = generate_terminal_profiles(cfg.n_terminals, cfg.seed)
    associate_terminals(customers, terminals, cfg.radius)
    txs = generate_transactions(customers, cfg.n_days, cfg.seed)
    txs = add_frauds(customers, terminals, txs, cfg)
    return customers, terminals, txs
