"""Per-customer event histories held on the device — port of the JAX
package's ``features/history.py``, the state the sequence kind serves
from.

- :class:`HistoryState`: a ring of the last K event-feature vectors per
  customer slot (``events [C+1, K, 8]``) with each cell's absolute event
  index (``pos``, -1 empty), so a partly overwritten history is detected
  rather than mixed, the events written per slot (``count``) and the
  newest event's epoch-second (``last_t``). Row ``C`` is a write sink:
  padding rows and unwritten rows scatter there, which keeps every other
  scatter index unique.
- :func:`update_and_score`: sort the batch into per-customer time order,
  write the new events, gather each row's own causal history (its
  customer's events up to and including itself, later same-batch events
  excluded by position) and score it at its own position with the causal
  transformer (``models/sequence.py::transformer_last_logit``). On the
  card, with naive attention and forms the kernel supports, that forward
  is one kernel (``ops/sequence_kernels.py::fused_last_logit``,
  ``csrc/fused_sequence.cu``). DeepSeek-V2's block
  (``models/deepseek_v2.py::DSV2Params``) takes the same histories
  through its own forward, ``last_logit``. :func:`serving_path` says
  which.

Event features mirror ``models/sequence.py::event_features`` channel for
channel, so a transformer trained on ``build_sequences`` serves unchanged;
the first event of a window has Δt = 0, as training's truncated windows
give it. Key→slot is the window state's (``features/online.py::_slot``):
``direct`` is collision-free below the capacity, ``hash`` (and ids past
the capacity) merge colliding customers into one history.

The state is written in place (the engine's tensors keep their
addresses, as the window state's do): every read of the pre-step state
happens before the scatters. Where the JAX package uses ``lexsort`` the
order comes from three stable sorts (by the tie key, then time, then
slot), and its ``associative_scan`` of maximum and minimum becomes
``cummax`` and a reversed ``cummin``. Rows that scatter to the sink row
write it in no fixed order, as in JAX (and ``index_put_`` on CUDA is
nondeterministic there): only rows ``[:C]`` are meaningful.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from real_time_fraud_detection_system_tpu_torch.config import FeatureConfig
from real_time_fraud_detection_system_tpu_torch.core.batch import TxBatch
from real_time_fraud_detection_system_tpu_torch.device import resolve_device
from real_time_fraud_detection_system_tpu_torch.features.online import _slot
from real_time_fraud_detection_system_tpu_torch.models import deepseek_v2
from real_time_fraud_detection_system_tpu_torch.models.sequence import (
    N_EVENT_FEATURES,
    transformer_last_logit,
)
from real_time_fraud_detection_system_tpu_torch.ops import sequence_kernels
from real_time_fraud_detection_system_tpu_torch.parallel.ring_attention \
    import blockwise_attention


def _attn_fn_for(cfg: FeatureConfig, k: int):
    """The serving attention (``FeatureConfig.seq_attn``): None is
    ``transformer_last_logit``'s naive causal attention ([B, H, K, K]
    scores in the prefix layers); blockwise is the online-softmax
    recurrence ([B, H, K, block] scores), chosen by ``auto`` once K
    exceeds ``seq_attn_block``."""
    mode = cfg.seq_attn
    if mode == "naive" or (mode == "auto" and k <= cfg.seq_attn_block):
        return None
    block = max(16, min(cfg.seq_attn_block, k))
    return lambda q, kk, v: blockwise_attention(q, kk, v, block_size=block)


# The forwards :func:`serving_path` names.
PATHS = sequence_kernels.PATHS + ("dsv2",)


def serving_path(params, cfg: FeatureConfig, device,
                 k: "int | None" = None) -> str:
    """The forward :func:`update_and_score` scores with on ``device`` at
    history length ``k`` (default ``cfg.history_len``): ``"dsv2"``
    (``models/deepseek_v2.py::last_logit``) for DeepSeek-V2's params, else
    ``"fused"`` (the kernel) or ``"plain"`` (``transformer_last_logit``),
    by ``ops/sequence_kernels.py::serving_path``."""
    if isinstance(params, deepseek_v2.DSV2Params):
        return "dsv2"
    k = cfg.history_len if k is None else k
    return sequence_kernels.serving_path(
        params, device, k, _attn_fn_for(cfg, k),
        grad=sequence_kernels.needs_grad(params))


class HistoryState(NamedTuple):
    """Per-customer event rings (+1 sink row for padded writes)."""

    events: torch.Tensor  # f32 [C+1, K, N_EVENT_FEATURES]
    pos: torch.Tensor  # int32 [C+1, K] — absolute event index, -1 empty
    count: torch.Tensor  # int32 [C+1] — events written per slot
    last_t: torch.Tensor  # int32 [C+1] — epoch-seconds of the newest event

    @property
    def capacity(self) -> int:
        return int(self.events.shape[0]) - 1

    @property
    def history_len(self) -> int:
        return int(self.events.shape[1])


def init_history_state(cfg: FeatureConfig, device=None) -> HistoryState:
    """Empty rings of ``customer_capacity`` slots × ``history_len`` events
    on ``device`` (None = CUDA)."""
    device = resolve_device(device)
    c, k = cfg.customer_capacity, cfg.history_len
    return HistoryState(
        events=torch.zeros((c + 1, k, N_EVENT_FEATURES), dtype=torch.float32,
                           device=device),
        pos=torch.full((c + 1, k), -1, dtype=torch.int32, device=device),
        count=torch.zeros(c + 1, dtype=torch.int32, device=device),
        last_t=torch.zeros(c + 1, dtype=torch.int32, device=device),
    )


def history_bytes(cfg: FeatureConfig) -> int:
    """Device bytes of the state :func:`init_history_state` builds."""
    c, k = cfg.customer_capacity + 1, cfg.history_len
    return c * k * (N_EVENT_FEATURES * 4 + 4) + c * 8


def _event_features_dev(amount: torch.Tensor, day: torch.Tensor,
                        tod_s: torch.Tensor,
                        dt_s: torch.Tensor) -> torch.Tensor:
    """[B, 8]: ``models/sequence.py::event_features`` on the device, with
    Δt supplied (the previous event may live in the state)."""
    tod = tod_s.to(torch.float32) / 86400.0
    weekday = ((day + 3) % 7).to(torch.float32) / 7.0
    two_pi = 2.0 * np.pi
    return torch.stack(
        [
            torch.log1p(torch.clamp(amount, min=0.0)),
            amount / 100.0,
            torch.log1p(torch.clamp(dt_s, min=0.0)) / 10.0,
            torch.sin(two_pi * tod),
            torch.cos(two_pi * tod),
            torch.sin(two_pi * weekday),
            torch.cos(two_pi * weekday),
            torch.ones_like(tod),
        ],
        dim=1,
    )


def _stable_order(key: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``order`` re-sorted by ``key[order]``, ties kept in place."""
    return order[torch.argsort(key[order], stable=True)]


def update_and_score(state: HistoryState, params, batch: TxBatch,
                     cfg: FeatureConfig, slot_fn=None,
                     order_key: "torch.Tensor | None" = None,
                     expert_slots: "torch.Tensor | None" = None,
                     stamps: "torch.Tensor | None" = None
                     ) -> Tuple[HistoryState, torch.Tensor]:
    """One history update and causal score; returns ``(state, probs [B])``
    in the batch's row order, padded rows scored 0. The state's tensors
    are written in place and returned.

    ``slot_fn(customer_key) -> slot`` overrides the key→slot map and
    ``order_key`` [B] breaks same-second ties (default: the row index);
    the sharded step (``parallel/sequence_step.py``) passes both, on one
    shard's block of the stacked state (its last row that block's sink).
    ``expert_slots`` and ``stamps`` go to DeepSeek-V2's forward
    (``models/deepseek_v2.py::last_logit``), which counts the expert slots
    of the valid rows' real positions and stamps its spans; the other
    forwards take neither.
    """
    c, k = state.capacity, state.history_len
    b = batch.size
    dev = batch.valid.device
    valid = batch.valid
    if slot_fn is None:
        slot = _slot(batch.customer_key, c, cfg.key_mode)
    else:
        slot = slot_fn(batch.customer_key).long()
    slot = torch.where(valid, slot, torch.full_like(slot, c))  # pad → sink
    t_s = batch.day * 86400 + batch.tod_s  # int32, ok until 2038

    # --- (slot, time, tie) order: lexsort((tie, t_s, slot)) as three
    # stable sorts, the last key first
    idx = torch.arange(b, dtype=torch.int64, device=dev)
    order = idx if order_key is None else torch.argsort(order_key,
                                                        stable=True)
    order = _stable_order(t_s, order)
    order = _stable_order(slot, order)
    s_slot = slot[order]
    s_t = t_s[order]
    s_valid = valid[order]

    change = s_slot[1:] != s_slot[:-1]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    first = torch.cat([one, change])
    last = torch.cat([change, one])
    seg_start = torch.cummax(
        torch.where(first, idx, torch.zeros_like(idx)), 0).values
    seg_end = torch.flip(torch.cummin(torch.flip(
        torch.where(last, idx, torch.full_like(idx, b - 1)), (0,)), 0).values,
        (0,))
    rank = idx - seg_start
    gsize = seg_end - seg_start + 1

    # --- Δt: rank 0 reaches back into the state (0 for a new customer)
    count_old = state.count[s_slot]  # [B] pre-update
    prev_in_batch = torch.cat([s_t[:1], s_t[:-1]])
    dt_state = torch.where(count_old > 0, s_t - state.last_t[s_slot],
                           torch.zeros_like(s_t))
    dt = torch.where(rank == 0, dt_state, s_t - prev_in_batch)
    f = _event_features_dev(batch.amount[order], batch.day[order],
                            batch.tod_s[order], dt.to(torch.float32))

    # --- each row's causal history, left-aligned, own event last: the
    # positions q >= count_old come from this batch's rows, the earlier
    # ones from the pre-step ring (read here, before the scatters)
    p = count_old.long() + rank  # absolute event index [B]
    length = torch.clamp(p + 1, max=k)
    j = torch.arange(k, dtype=torch.int64, device=dev)[None, :]
    q = p[:, None] - (length[:, None] - 1) + j  # [B, K] absolute positions
    in_batch = q >= count_old.long()[:, None]
    bidx = torch.clamp(seg_start[:, None] + (q - count_old.long()[:, None]),
                       0, b - 1)
    ev_batch = f[bidx]  # [B, K, F]
    cellq = q % k
    ev_old = state.events[s_slot[:, None], cellq]
    pos_old = state.pos[s_slot[:, None], cellq]
    ev = torch.where(in_batch[..., None], ev_batch, ev_old)
    ok = (q >= 0) & (q <= p[:, None]) & (in_batch | (pos_old.long() == q))
    hist = torch.where(ok[..., None], ev, torch.zeros_like(ev))
    # training's windows start with Δt = 0 (the predecessor fell outside
    # the window); the stored features keep the true Δt
    hist[:, 0, 2] = 0.0

    # --- the scatters: only the newest K of an oversized group are
    # written, which keeps the (slot, cell) pairs unique off the sink row
    cell = p % k
    write = s_valid & (rank >= gsize - k)
    sink = torch.full_like(s_slot, c)
    w_slot = torch.where(write, s_slot, sink)
    state.events.index_put_((w_slot, cell), f)
    state.pos.index_put_((w_slot, cell), p.to(torch.int32))
    tail = s_valid & last
    state.count.index_add_(
        0, w_slot, torch.where(tail, gsize, torch.zeros_like(gsize))
        .to(torch.int32))
    state.last_t.index_put_((torch.where(tail, s_slot, sink),), s_t)

    # the last block and the head run at the row's own position only
    path = serving_path(params, cfg, dev, k)
    if path == "dsv2":
        real = s_valid[:, None] & (j < length[:, None])
        own = deepseek_v2.last_logit(params, hist, length - 1, real=real,
                                     slots=expert_slots, stamps=stamps)
    elif path == "fused":
        own = sequence_kernels.fused_last_logit(params, hist, length - 1)
    else:
        own = transformer_last_logit(params, hist, length - 1,
                                     attn_fn=_attn_fn_for(cfg, k))
    probs = torch.where(s_valid, torch.sigmoid(own), torch.zeros_like(own))
    out = torch.zeros(b, dtype=torch.float32, device=dev)
    out[order] = probs
    return state, out
