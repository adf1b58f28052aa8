"""Stream sources — port of the JAX package's ``runtime/sources.py``.

:class:`ReplaySource` serves micro-batches from a generated
:class:`~..data.generator.Transactions` table as raw columnar slices (the
zero-parse path). The envelope mode, which round-trips rows through
Debezium JSON, is ported with the serving loop (ROADMAP A2).
"""

from __future__ import annotations

from typing import List, Optional

from real_time_fraud_detection_system_tpu_torch.data.generator import (
    Transactions,
)


class ReplaySource:
    """Serves micro-batches of ``batch_rows`` rows from a transactions
    table, in order, as numpy column dicts."""

    def __init__(
        self,
        txs: Transactions,
        start_epoch_s: int,
        batch_rows: int = 4096,
        mode: str = "columnar",
    ):
        if mode != "columnar":
            raise NotImplementedError(
                f"ReplaySource mode {mode!r} is not ported yet (ROADMAP A2, "
                f"envelope ingest)")
        self.txs = txs
        self.start_epoch_s = start_epoch_s
        self.batch_rows = batch_rows
        self._pos = 0

    def poll_batch(self) -> Optional[dict]:
        """Next micro-batch as a column dict (None when exhausted)."""
        if self._pos >= self.txs.n:
            return None
        s, e = self._pos, min(self._pos + self.batch_rows, self.txs.n)
        self._pos = e
        part = self.txs.slice(slice(s, e))
        us = part.epoch_us(self.start_epoch_s)
        return {
            "tx_id": part.tx_id,
            "tx_datetime_us": us,
            "customer_id": part.customer_id,
            "terminal_id": part.terminal_id,
            "tx_amount_cents": part.amount_cents,
            "kafka_ts_ms": us // 1000,
        }

    @property
    def offsets(self) -> List[int]:
        return [self._pos]
