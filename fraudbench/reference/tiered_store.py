"""Plain reference of the tiered feature store (``key_mode="exact"``):
which rows the hot tier answers, which the count-min sketch answers, and
the 15 features each row is owed. Plain PyTorch on any device; it
imports nothing of the program under test.

The semantics, as the configuration states them:

- **Key directory.** Per key space a table of ``dir_capacity`` entries
  (twice the hot tier's slots) probed by double hashing
  (``reference/hashing.py``). Per batch, each key that holds no entry
  tries its probe positions in order, one round per position: among the
  keys whose current position is empty, the smallest key (unsigned)
  takes it, the others go on to their next position. A key that finds
  no empty position within ``n_probes`` rounds misses: it holds no slot
  in that batch and the sketch answers its rows. A key that holds an
  entry keeps it until compaction reclaims it.
- **Hot tier.** A key's slot holds every row of the key from the batch
  its entry was claimed in onward (rows of one batch all count,
  "update then query"); a window w at day d sums the rows of days
  ``[d - w + 1, d]`` (terminal windows shifted back by ``delay_days``).
- **Compaction.** Every ``compact_every`` finished batches, behind the
  step that was in flight then, the newest day seen so far ``now``:
  every entry whose key's newest row is older than ``now - (delay_days
  + max(windows))`` is vacated.
- **Sketch tier.** Every row, admitted or not, adds to a per-day
  ``depth × width`` count-min sketch (customers: count and amount;
  terminals: count, amount and fraud labels); a row that missed reads,
  for each day of its window, the least of its key's ``depth`` cells of
  that day, summed over the window's days.

The whole stream runs through the directory batch by batch, and the
rows the check samples are read as their batch passes; the windows'
sums, the hot tier's and the sketch's, come from running sums over the
stream's rows sorted by key (or sketch cell) and batch.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from fraudbench.reference.hashing import (
    MASK32,
    fold_key,
    hash_u32,
    probe_positions,
)

EMPTY = MASK32  # a vacant entry; real keys stay below it


class Directory:
    """One key space's directory: which keys hold a hot-tier slot, since
    which batch, and the newest day each has written."""

    def __init__(self, slot_capacity: int, n_probes: int, key_space: int,
                 device):
        self.dir_cap = 2 * slot_capacity
        self.slot_cap = slot_capacity
        self.n_probes = n_probes
        self.table = torch.full((self.dir_cap,), EMPTY, dtype=torch.int64,
                                device=device)
        self.where = torch.full((key_space,), -1, dtype=torch.int64,
                                device=device)
        self.since = torch.full((key_space,), -1, dtype=torch.int64,
                                device=device)
        self.last_day = torch.full((key_space,), -1, dtype=torch.int64,
                                   device=device)
        self.resident = 0

    def admit(self, key: torch.Tensor, g: int, day: int) -> torch.Tensor:
        """One batch's keys (int64 [n]) at global batch ``g``: claim
        entries for the keys that hold none; bool [n] whether each row
        is answered by the hot tier."""
        u = torch.unique(key)
        new = u[self.where[u] < 0]
        if new.numel():
            pos = probe_positions(new, self.dir_cap, self.n_probes)
            placed = torch.zeros_like(new, dtype=torch.bool)
            entry = torch.zeros_like(new)
            for j in range(self.n_probes):
                p = pos[:, j]
                want = ~placed & (self.table[p] == EMPTY)
                cand = torch.where(want, new, torch.full_like(new, EMPTY))
                self.table.scatter_reduce_(0, p, cand, "amin",
                                           include_self=True)
                won = want & (self.table[p] == new)
                entry = torch.where(won, p, entry)
                placed |= won
            k = new[placed]
            self.where[k] = entry[placed]
            self.since[k] = g
            self.resident += int(k.numel())
            if self.resident > self.slot_cap:
                raise RuntimeError(
                    "the hot tier ran out of slots: the reference does not "
                    "model a rolled-back claim; the traffic's key space "
                    "must fit the configured capacity")
        adm = self.where[key] >= 0
        self.last_day.index_put_((key,), torch.where(
            adm, torch.full_like(key, day), self.last_day[key]))
        return adm

    def compact(self, now_day: int, horizon: int) -> int:
        """Vacate the entries whose newest row is older than ``now_day -
        horizon``; the number vacated."""
        live = torch.nonzero(self.where >= 0)[:, 0]
        dead = live[self.last_day[live] < now_day - horizon]
        self.table[self.where[dead]] = EMPTY
        self.where[dead] = -1
        self.since[dead] = -1
        self.resident -= int(dead.numel())
        return int(dead.numel())


def sketch_estimates(key: torch.Tensor, day: torch.Tensor,
                     batch: torch.Tensor, values: Dict[str, torch.Tensor],
                     q_key: torch.Tensor, q_day: torch.Tensor,
                     q_batch: torch.Tensor, windows, delay: int,
                     depth: int, width: int) -> Dict[str, torch.Tensor]:
    """The sketch tier's answers for queries ``q_*`` (a key, its day, the
    batch it is read in): per window day, the least over the sketch's
    rows of the sum of ``values`` over the stream's rows up to and
    including that batch, of that day, whose key falls in the query's
    column; summed over the window's days. float64 [m, len(windows)]
    per value. (A day's slice holds every row of that day once the day
    is within the ring's reach, as a window's days are.)"""
    span = int(batch.max()) + 1
    d0 = int(day.min())
    out = {f: torch.zeros((q_key.shape[0], len(windows)), dtype=torch.float64,
                          device=key.device) for f in values}
    if q_key.numel() == 0:
        return out
    per_row = []
    for i in range(depth):
        cell = hash_u32(key, i) & (width - 1)
        comp, cums = _sorted_sums((day - d0) * width + cell, batch, span,
                                  list(values.values()))
        q_cell = hash_u32(q_key, i) & (width - 1)
        per_o = []
        for o in range(max(windows)):
            want = q_day - delay - o
            k = (want - d0) * width + q_cell
            lo = torch.zeros_like(q_batch)
            sums = _range_sums(comp, cums, k, lo, q_batch, span)
            live = want >= d0
            per_o.append([torch.where(live, v, torch.zeros_like(v))
                          for v in sums])
        per_row.append(per_o)
    for j, f in enumerate(values):
        # [depth, O, m] → least over the sketch's rows → [O, m]
        t = torch.stack([torch.stack([per_o[o][j] for o in
                                      range(max(windows))])
                         for per_o in per_row]).amin(0)
        out[f] = torch.stack([t[:w].sum(0) for w in windows], dim=1)
    return out


def compaction_schedule(runs: List[tuple], every: int) -> Dict[int, int]:
    """Where compaction falls: ``runs`` are the engine's runs as
    inclusive ranges of 0-based global batches, in order. Finishing batch
    ``N`` (1-based, ``N % every == 0``) enqueues a pass behind the step
    that is in flight then, batch ``N + 1`` at pipeline depth 2 when the
    same run launched it, else ``N`` itself. Returns {0-based batch whose
    step the pass follows: number of passes there}."""
    out: Dict[int, int] = {}
    if every <= 0:
        return out
    for first, last in runs:
        for g in range(first, last + 1):
            if (g + 1) % every == 0:
                after = g + 1 if g + 1 <= last else g
                out[after] = out.get(after, 0) + 1
    return out


def _range_sums(comp: torch.Tensor, cums: List[torch.Tensor],
                key: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                span: int) -> List[torch.Tensor]:
    """Sums over a key's rows in batches [lo, hi] from the rows sorted by
    ``key · span + batch`` (``comp``) and their running sums ``cums``
    (each with a leading 0)."""
    a = torch.searchsorted(comp, key * span + lo, right=False)
    b = torch.searchsorted(comp, key * span + hi, right=True)
    empty = lo > hi
    return [torch.where(empty, torch.zeros_like(c[a], dtype=c.dtype),
                        c[b] - c[a]) for c in cums]


def _sorted_sums(key: torch.Tensor, batch: torch.Tensor, span: int,
                 values: List[torch.Tensor]):
    comp = key * span + batch
    comp, order = torch.sort(comp)
    cums = [torch.cat([torch.zeros(1, dtype=torch.float64,
                                   device=v.device),
                       torch.cumsum(v[order], 0)]) for v in values]
    return comp, cums


def features(rows: Dict[str, torch.Tensor], sample: Dict[str, torch.Tensor],
             cfg: dict, runs: List[tuple],
             simulate: bool = True) -> Dict[str, torch.Tensor]:
    """The owed features of the sampled rows.

    ``rows`` holds every row of the stream's batches up to the last run's
    last (``gen/zipf.py::Stream.device_rows``); ``sample`` the sampled
    rows' global batch ``g`` and row-in-batch ``i`` (int64, sorted by
    ``g``); ``cfg`` the configuration's feature sizes; ``runs`` the
    engine's runs. Returns the features (float64 [n, 15], the
    configuration's order), each row's tier per key space (``c_dense``,
    ``t_dense``) and the window's tier totals (``dense_rows``,
    ``cms_rows``: row × key-space reads, over the batches of the last
    run). ``simulate=False`` skips the directory and the sketches: every
    key counts as held since the stream's first batch."""
    windows = list(cfg["windows"])
    delay = int(cfg["delay_days"])
    horizon = delay + max(windows)
    probes = int(cfg["keydir_probes"])
    g_last = runs[-1][1]
    r = int(rows["batch_rows"])
    device = rows["customer_id"].device
    cust = fold_key(rows["customer_id"][:(g_last + 1) * r])
    term = fold_key(rows["terminal_id"][:(g_last + 1) * r])
    day_b = rows["batch_day"][:g_last + 1]
    days = day_b.tolist()
    sg, si = sample["g"], sample["i"]
    n = int(sg.shape[0])
    c_dense = torch.ones(n, dtype=torch.bool, device=device)
    t_dense = torch.ones_like(c_dense)
    c_since = torch.zeros(n, dtype=torch.int64, device=device)
    t_since = torch.zeros_like(c_since)
    dense = torch.zeros((), dtype=torch.int64, device=device)
    cms = torch.zeros((), dtype=torch.int64, device=device)
    if simulate:
        cdir = Directory(int(cfg["customer_capacity"]), probes,
                         int(cust.max()) + 1, device)
        tdir = Directory(int(cfg["terminal_capacity"]), probes,
                         int(term.max()) + 1, device)
        passes = compaction_schedule(runs, int(cfg["compact_every"]))
        bounds = np.searchsorted(sg.cpu().numpy(), np.arange(g_last + 2))
        window_first = runs[-1][0]
        for g in range(g_last + 1):
            d = days[g]
            ck, tk = cust[g * r:(g + 1) * r], term[g * r:(g + 1) * r]
            ca = cdir.admit(ck, g, d)
            ta = tdir.admit(tk, g, d)
            if g >= window_first:
                hits = ca.sum() + ta.sum()
                dense += hits
                cms += 2 * r - hits
            a, b = int(bounds[g]), int(bounds[g + 1])
            if b > a:
                idx = si[a:b]
                c_dense[a:b], t_dense[a:b] = ca[idx], ta[idx]
                c_since[a:b] = cdir.since[ck[idx]]
                t_since[a:b] = tdir.since[tk[idx]]
            for _ in range(passes.get(g, 0)):
                cdir.compact(d, horizon)
                tdir.compact(d, horizon)

    # the hot tier's answers: sums over each key's rows since its claim
    batch = torch.arange(g_last + 1, device=device).repeat_interleave(r)
    span = g_last + 1
    amount = rows["amount"][:(g_last + 1) * r].to(torch.float64)
    fraud = rows["label"][:(g_last + 1) * r].to(torch.float64)
    one = torch.ones_like(amount)
    ccomp, ccum = _sorted_sums(cust, batch, span, [one, amount])
    tcomp, tcum = _sorted_sums(term, batch, span, [one, fraud])
    row = sg * r + si
    sk_c, sk_t = cust[row], term[row]
    d = day_b[sg]

    def first_of(day):
        return torch.searchsorted(day_b, day)

    def last_of(day):
        return torch.searchsorted(day_b, day, right=True) - 1

    c_cnt, c_amt, t_cnt, t_frd = [], [], [], []
    for w in windows:
        lo = torch.maximum(c_since, first_of(d - w + 1))
        cnt, am = _range_sums(ccomp, ccum, sk_c, lo, sg, span)
        c_cnt.append(cnt)
        c_amt.append(am)
        lo = torch.maximum(t_since, first_of(d - delay - w + 1))
        hi = torch.minimum(sg, last_of(d - delay))
        cnt, fr = _range_sums(tcomp, tcum, sk_t, lo, hi, span)
        t_cnt.append(cnt)
        t_frd.append(fr)
    c_cnt, c_amt = torch.stack(c_cnt, 1), torch.stack(c_amt, 1)
    t_cnt, t_frd = torch.stack(t_cnt, 1), torch.stack(t_frd, 1)
    del ccomp, ccum, tcomp, tcum

    # the sketch tier's answers, for the sampled rows that missed
    depth, width = int(cfg["cms_depth"]), int(cfg["cms_width"])
    row_day = rows["day"][:(g_last + 1) * r]
    for miss, key, vals, dl, out in (
            (~c_dense, cust, {"count": one, "amount": amount}, 0,
             (c_cnt, c_amt)),
            (~t_dense, term, {"count": one, "fraud": fraud}, delay,
             (t_cnt, t_frd))):
        m = torch.nonzero(miss)[:, 0]
        if m.numel() == 0:
            continue
        est = sketch_estimates(key, row_day, batch, vals, key[row[m]], d[m],
                               sg[m], windows, dl, depth, width)
        for t, v in zip(out, est.values()):
            t[m] = v

    def ratio(num, cnt):
        return torch.where(cnt > 0, num / cnt.clamp(min=1.0),
                           torch.zeros_like(num))

    s_amount = amount[row]
    tod = rows["tod_s"][row]
    weekend = (((d + 3) % 7) >= int(cfg["weekend_start_weekday"]))
    night = (tod // 3600) <= int(cfg["night_end_hour"])
    out = [s_amount, weekend.to(torch.float64), night.to(torch.float64)]
    c_avg, t_risk = ratio(c_amt, c_cnt), ratio(t_frd, t_cnt)
    for k in range(len(windows)):
        out += [c_cnt[:, k], c_avg[:, k]]
    for k in range(len(windows)):
        out += [t_cnt[:, k], t_risk[:, k]]
    return {"features": torch.stack(out, 1), "c_dense": c_dense,
            "t_dense": t_dense, "dense_rows": int(dense),
            "cms_rows": int(cms)}
