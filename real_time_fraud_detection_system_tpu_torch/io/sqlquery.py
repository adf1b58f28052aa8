"""SQL over the analyzed Parquet output — the Trino role, in-process; the
port's own copy of the JAX package's ``io/sqlquery.py``.

The reference serves analysts through Superset → Trino → Iceberg
(``superset/entrypoint.sh:19``, ``trino-config/catalog/nessie.properties``).
This module mounts a :class:`~.sink.ParquetSink` directory as a queryable
``analyzed`` table for plain SQL:

- **DuckDB** when installed (same Parquet-scan architecture Trino uses);
- otherwise **pyarrow.dataset → in-memory sqlite3** (both ship with the
  base image, so SQL access needs zero extra services).

Either engine sees the table through a latest-wins-by-``tx_id`` view
(ROW_NUMBER over ``processed_at_us`` — the reference's own dedup pattern,
``kafka_s3_sink_transactions.py:173-186``), so crash-replay re-scorings
count once, exactly like :func:`io.query.load_analyzed`.

Used by the port's ``sql`` command (``cli.py``).
"""

from __future__ import annotations

import os
from typing import List, Tuple


def _dedup_view_sql(columns: List[str]) -> str:
    """Latest-wins-by-tx_id view over ``analyzed_raw`` (see module
    docstring), projecting exactly the table's columns so the internal
    ``rn`` ranking column never reaches user queries."""
    collist = ", ".join(columns)
    return f"""
CREATE VIEW analyzed AS
SELECT {collist} FROM (
    SELECT *, ROW_NUMBER() OVER (
        PARTITION BY tx_id ORDER BY processed_at_us DESC) AS rn
    FROM analyzed_raw
) WHERE rn = 1
"""


def parquet_files(directory: str) -> List[str]:
    """Sorted ``*.parquet`` part files (ignores crashed-write ``.tmp``)."""
    return sorted(
        os.path.join(directory, f) for f in os.listdir(directory)
        if f.endswith(".parquet")
    )


class AnalyzedSql:
    """A mounted analyzed directory; ``query(sql)`` → (column_names, rows).

    ``engine`` is "duckdb" or "sqlite" (auto-detected at mount time).
    """

    def __init__(self, directory: str):
        files = parquet_files(directory)
        if not files:
            raise FileNotFoundError(
                f"no *.parquet part files under {directory!r}")
        try:
            import duckdb

            self.engine = "duckdb"
            self._con = duckdb.connect()
            quoted = ", ".join("'" + f.replace("'", "''") + "'"
                               for f in files)
            self._con.execute(
                f"CREATE VIEW analyzed_raw AS "
                f"SELECT * FROM read_parquet([{quoted}])")
            names = [r[0] for r in self._con.execute(
                "SELECT * FROM analyzed_raw LIMIT 0").description]
        except ImportError:
            import sqlite3

            import pyarrow.dataset as ds

            self.engine = "sqlite"
            table = ds.dataset(files, format="parquet").to_table()
            self._con = sqlite3.connect(":memory:")
            # every column, types derived from the arrow schema — the
            # fallback must answer the same queries DuckDB would
            import pyarrow.types as pt

            names, decls = [], []
            for field in table.schema:
                if pt.is_integer(field.type) or pt.is_boolean(field.type):
                    t = "INTEGER"
                elif pt.is_floating(field.type):
                    t = "REAL"
                else:
                    t = "TEXT"
                names.append(field.name)
                decls.append(f"{field.name} {t}")
            self._con.execute(
                f"CREATE TABLE analyzed_raw ({', '.join(decls)})")
            cols = [table[c].to_numpy(zero_copy_only=False) for c in names]
            self._con.executemany(
                f"INSERT INTO analyzed_raw VALUES "
                f"({','.join('?' * len(names))})",
                zip(*[c.tolist() for c in cols]),
            )
        self.columns = names
        self._con.execute(_dedup_view_sql(names))

    def query(self, sql: str,
              max_rows: int = 0) -> Tuple[List[str], List[tuple]]:
        """``max_rows > 0`` bounds the fetch (memory stays O(max_rows)
        however large the result); 0 fetches everything."""
        cur = self._con.execute(sql)
        names = [d[0] for d in cur.description] if cur.description else []
        rows = cur.fetchmany(max_rows) if max_rows > 0 else cur.fetchall()
        return names, rows

    def close(self) -> None:
        self._con.close()


def run_queries(directory: str, queries: dict) -> Tuple[str, dict]:
    """Mount once, run several; → (engine, {name: rows})."""
    db = AnalyzedSql(directory)
    try:
        return db.engine, {name: db.query(sql)[1]
                           for name, sql in queries.items()}
    finally:
        db.close()
