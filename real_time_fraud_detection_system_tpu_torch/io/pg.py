"""Live Postgres OLTP boundary (the reference's upstream of CDC) — the
port's own copy of the JAX package's ``io/pg.py``.

The reference seeds and streams its OLTP store with per-row INSERT loops
(``datagen/data_gen.py:67-147``: psycopg2, ON CONFLICT upserts, one commit
+ 10 s sleep per transaction) against the DDL in ``postgres/init.sql:8-42``;
Debezium then turns those rows into the envelope stream this framework
ingests. This module is the framework-side equivalent of that boundary:

- :func:`ddl_statements` — the same schema/table layout (SERIAL keys,
  DECIMAL(10,2) amounts, REPLICA IDENTITY FULL so Debezium emits full
  before-images), generated from the typed :mod:`core.schema` tables;
- :class:`PgLive` — vectorized ``executemany`` upserts (batched, one
  commit per batch instead of per row) with an optional paced mode that
  reproduces the reference's demo drip-feed;
- pure row-conversion helpers (int64 cents/µs ↔ DECIMAL/TIMESTAMP) kept
  separate so the fidelity logic is unit-testable without a server.

psycopg2 is import-gated like boto3 in :mod:`.store`: it is needed only
when :class:`PgLive` connects to a live database itself (a DB-API
connection can be injected instead).
"""

from __future__ import annotations

import datetime as _dt
from typing import Dict, List, Optional, Sequence

import numpy as np

_EPOCH = _dt.datetime(1970, 1, 1)


def ddl_statements(schema: str = "payment") -> List[str]:
    """Reference-compatible DDL (``postgres/init.sql:8-42``), one statement
    per list entry. REPLICA IDENTITY FULL keeps Debezium UPDATE events
    carrying full row images — the envelope codec relies on that."""
    return [
        f"CREATE SCHEMA IF NOT EXISTS {schema}",
        f"""CREATE TABLE IF NOT EXISTS {schema}.customers (
            customer_id BIGINT PRIMARY KEY,
            x_location FLOAT NOT NULL,
            y_location FLOAT NOT NULL)""",
        f"""CREATE TABLE IF NOT EXISTS {schema}.terminals (
            terminal_id BIGINT PRIMARY KEY,
            x_location FLOAT NOT NULL,
            y_location FLOAT NOT NULL)""",
        f"""CREATE TABLE IF NOT EXISTS {schema}.transactions (
            tx_id BIGINT PRIMARY KEY,
            tx_datetime TIMESTAMP NOT NULL,
            customer_id BIGINT NOT NULL,
            terminal_id BIGINT NOT NULL,
            tx_amount DECIMAL(10,2) NOT NULL)""",
        f"ALTER TABLE {schema}.customers REPLICA IDENTITY FULL",
        f"ALTER TABLE {schema}.terminals REPLICA IDENTITY FULL",
        f"ALTER TABLE {schema}.transactions REPLICA IDENTITY FULL",
    ]


def transactions_to_pg_rows(cols: Dict[str, np.ndarray]) -> List[tuple]:
    """Columnar int64 cents/µs → (tx_id, datetime, cust, term, Decimal-str).

    Amounts travel as strings ('123.45') so DECIMAL(10,2) stores the exact
    cents value — float would re-introduce the representation error the
    int64-cents design exists to avoid."""
    us = cols["tx_datetime_us"]
    return [
        (
            int(t), _EPOCH + _dt.timedelta(microseconds=int(u)),
            int(c), int(m),
            f"{int(a) // 100}.{int(a) % 100:02d}",
        )
        for t, u, c, m, a in zip(
            cols["tx_id"], us, cols["customer_id"], cols["terminal_id"],
            cols["tx_amount_cents"],
        )
    ]


def pg_rows_to_transactions(rows: Sequence[tuple]) -> Dict[str, np.ndarray]:
    """Inverse of :func:`transactions_to_pg_rows` (µs/cents exact)."""
    n = len(rows)
    out = {
        "tx_id": np.zeros(n, np.int64),
        "tx_datetime_us": np.zeros(n, np.int64),
        "customer_id": np.zeros(n, np.int64),
        "terminal_id": np.zeros(n, np.int64),
        "tx_amount_cents": np.zeros(n, np.int64),
    }
    for i, (t, ts, c, m, a) in enumerate(rows):
        out["tx_id"][i] = int(t)
        out["tx_datetime_us"][i] = (
            (ts - _EPOCH) // _dt.timedelta(microseconds=1))
        out["customer_id"][i] = int(c)
        out["terminal_id"][i] = int(m)
        # DECIMAL comes back as decimal.Decimal (or str): exact cents
        out["tx_amount_cents"][i] = round(float(a) * 100)
    return out


_UPSERT_TX = """INSERT INTO {s}.transactions
    (tx_id, tx_datetime, customer_id, terminal_id, tx_amount)
    VALUES (%s, %s, %s, %s, %s)
    ON CONFLICT (tx_id) DO UPDATE SET
    tx_datetime = EXCLUDED.tx_datetime,
    customer_id = EXCLUDED.customer_id,
    terminal_id = EXCLUDED.terminal_id,
    tx_amount = EXCLUDED.tx_amount"""

_UPSERT_DIM = """INSERT INTO {s}.{table} ({key}, x_location, y_location)
    VALUES (%s, %s, %s)
    ON CONFLICT ({key}) DO UPDATE SET
    x_location = EXCLUDED.x_location,
    y_location = EXCLUDED.y_location"""


class PgLive:
    """Batched live writer/reader for the payment OLTP schema.

    ``connection`` is injectable (DB-API 2.0 duck type) for hermetic
    tests; production use passes a DSN and lets psycopg2 connect.
    """

    def __init__(self, dsn: Optional[str] = None, schema: str = "payment",
                 connection=None):
        if connection is None:
            try:
                import psycopg2
            except ImportError as e:
                raise ImportError(
                    "psycopg2 is not installed; the live-Postgres boundary "
                    "needs it (pip install psycopg2-binary), or inject a "
                    "DB-API connection."
                ) from e
            connection = psycopg2.connect(dsn)
        self.conn = connection
        self.schema = schema

    def ensure_schema(self) -> None:
        cur = self.conn.cursor()
        for stmt in ddl_statements(self.schema):
            cur.execute(stmt)
        self.conn.commit()

    def upsert_dimension(self, table: str, key: str,
                         ids: np.ndarray, x: np.ndarray,
                         y: np.ndarray) -> None:
        cur = self.conn.cursor()
        cur.executemany(
            _UPSERT_DIM.format(s=self.schema, table=table, key=key),
            [(int(i), float(a), float(b)) for i, a, b in zip(ids, x, y)],
        )
        self.conn.commit()

    def upsert_transactions(
        self,
        cols: Dict[str, np.ndarray],
        batch_rows: int = 5000,
        rate_per_s: float = 0.0,
    ) -> int:
        """Vectorized upsert; ``rate_per_s > 0`` paces row visibility like
        the reference's demo drip (one commit per batch, sleeping to hold
        the average rate — not one commit + 10 s sleep per row)."""
        import time

        rows = transactions_to_pg_rows(cols)
        cur = self.conn.cursor()
        sql = _UPSERT_TX.format(s=self.schema)
        done = 0
        for s in range(0, len(rows), batch_rows):
            chunk = rows[s:s + batch_rows]
            t0 = time.perf_counter()
            cur.executemany(sql, chunk)
            self.conn.commit()
            done += len(chunk)
            if rate_per_s > 0:
                min_wall = len(chunk) / rate_per_s
                time.sleep(max(0.0, min_wall -
                               (time.perf_counter() - t0)))
        return done

    def read_transactions(self, limit: int = 0) -> Dict[str, np.ndarray]:
        cur = self.conn.cursor()
        q = (f"SELECT tx_id, tx_datetime, customer_id, terminal_id, "
             f"tx_amount FROM {self.schema}.transactions ORDER BY tx_id")
        if limit:
            q += f" LIMIT {int(limit)}"
        cur.execute(q)
        return pg_rows_to_transactions(cur.fetchall())
