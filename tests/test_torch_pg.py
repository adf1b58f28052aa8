"""The port's ``io/pg.py`` against the JAX package's: the same DDL, the
same row conversions both ways, and the same statements, rows and
commits on a fake DB-API connection; ``datagen --pg-dsn`` seeds through
``PgLive`` with the JAX command's calls. psycopg2 is needed only to
connect."""

import numpy as np
import pytest

from real_time_fraud_detection_system_tpu.io import pg as jpg
from real_time_fraud_detection_system_tpu_torch.io import pg as tpg
from test_pg import _FakeConn  # pytest adds tests/


def _cols(n=11, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "tx_id": np.arange(n, dtype=np.int64),
        "tx_datetime_us": np.sort(
            rng.integers(0, 400 * 86_400_000_000, n).astype(np.int64)),
        "customer_id": rng.integers(0, 5, n, dtype=np.int64),
        "terminal_id": rng.integers(0, 9, n, dtype=np.int64),
        "tx_amount_cents": rng.integers(0, 10**9, n, dtype=np.int64),
    }


@pytest.mark.parametrize("schema", ["payment", "other"])
def test_ddl_equals_jax(schema):
    assert tpg.ddl_statements(schema) == jpg.ddl_statements(schema)


def test_row_conversions_equal_jax():
    cols = _cols()
    rows = tpg.transactions_to_pg_rows(cols)
    assert rows == jpg.transactions_to_pg_rows(cols)
    back = tpg.pg_rows_to_transactions(rows)
    want = jpg.pg_rows_to_transactions(rows)
    for k in cols:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
        np.testing.assert_array_equal(back[k], cols[k], err_msg=k)


def _drive(mod):
    conn = _FakeConn()
    live = mod.PgLive(connection=conn, schema="payment")
    live.ensure_schema()
    live.upsert_dimension("customers", "customer_id", np.arange(4),
                          np.linspace(0, 1, 4), np.ones(4))
    n = live.upsert_transactions(_cols(), batch_rows=4)
    return n, conn.log, conn.commits


def test_live_writer_makes_the_jax_calls():
    got, want = _drive(tpg), _drive(jpg)
    assert got == want
    assert got[0] == 11 and got[2] == 1 + 1 + 3  # schema, dim, 3 batches


def test_read_transactions_query_equals_jax():
    logs = []
    for mod in (tpg, jpg):
        conn = _FakeConn()
        mod.PgLive(connection=conn).read_transactions(limit=5)
        logs.append(conn.log)
    assert logs[0] == logs[1] and "LIMIT 5" in logs[0][0][1]


def test_connecting_without_psycopg2_names_it(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "psycopg2", None)
    with pytest.raises(ImportError, match="psycopg2"):
        tpg.PgLive("dbname=x")


def test_datagen_seeds_postgres_with_the_jax_calls(tmp_path, monkeypatch):
    from real_time_fraud_detection_system_tpu import cli as jcli
    from real_time_fraud_detection_system_tpu_torch import cli as tcli

    logs = {}
    for name, mod, main in (("port", tpg, tcli.main),
                            ("jax", jpg, jcli.main)):
        conn = _FakeConn()
        real = mod.PgLive.__init__

        def init(self, dsn=None, schema="payment", connection=None,
                 _conn=conn, _real=real):
            _real(self, dsn, schema=schema, connection=_conn)

        monkeypatch.setattr(mod.PgLive, "__init__", init)
        assert main(["datagen", "--out", str(tmp_path / f"{name}.npz"),
                     "--customers", "20", "--terminals", "40", "--days",
                     "5", "--pg-dsn", "dbname=fraud"]) == 0
        logs[name] = (conn.log, conn.commits)
    assert logs["port"] == logs["jax"]
    assert sum(e[0] == "executemany" for e in logs["port"][0]) >= 3
