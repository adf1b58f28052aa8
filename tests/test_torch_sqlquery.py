"""The port's ``io/sqlquery.py`` and ``sql`` command against the JAX
package's: the same queries over the same Parquet directory (with
crash-replay duplicates, which the latest-wins view counts once) give the
same rows on the pyarrow + sqlite route. The DuckDB route needs duckdb."""

import json

import pytest

from real_time_fraud_detection_system_tpu import cli as jcli
from real_time_fraud_detection_system_tpu.io import sqlquery as jsql
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch.io import sqlquery as tsql
from test_torch_query import write_analyzed  # pytest adds tests/

QUERIES = {
    "count": "SELECT COUNT(*) AS n FROM analyzed",
    "raw_count": "SELECT COUNT(*) AS n FROM analyzed_raw",
    "flagged": "SELECT COUNT(*) AS n, ROUND(SUM(tx_amount), 2) AS amount "
               "FROM analyzed WHERE prediction >= 0.3",
    "by_terminal": "SELECT terminal_id, COUNT(*) AS n, "
                   "ROUND(AVG(prediction), 6) AS mean FROM analyzed "
                   "GROUP BY terminal_id ORDER BY mean DESC, terminal_id",
    "replayed": "SELECT tx_id, processed_at_us FROM analyzed "
                "WHERE tx_id < 10 ORDER BY tx_id",
    "features": "SELECT tx_id, customer_id_nb_tx_7day_window FROM analyzed "
                "ORDER BY tx_id LIMIT 5",
}


@pytest.fixture(scope="module")
def analyzed_dir(tmp_path_factory):
    pytest.importorskip("pyarrow", reason="the analyzed output is Parquet")
    d = tmp_path_factory.mktemp("sql") / "analyzed"
    write_analyzed(d)
    (d / "part-00000009.parquet.tmp").write_bytes(b"torn write")
    return d


@pytest.fixture
def sqlite_route(monkeypatch):
    """Both packages on the sqlite route, even where duckdb is installed."""
    import sys

    monkeypatch.setitem(sys.modules, "duckdb", None)


@pytest.mark.parametrize("name", sorted(QUERIES))
def test_queries_give_the_jax_rows(analyzed_dir, sqlite_route, name):
    got = tsql.run_queries(str(analyzed_dir), {name: QUERIES[name]})
    want = jsql.run_queries(str(analyzed_dir), {name: QUERIES[name]})
    assert got == want
    assert got[0] == "sqlite"


def test_dedup_view_and_columns_equal_jax(analyzed_dir, sqlite_route):
    t, j = tsql.AnalyzedSql(str(analyzed_dir)), jsql.AnalyzedSql(
        str(analyzed_dir))
    try:
        assert t.columns == j.columns
        assert t.query(QUERIES["count"])[1] == [(400,)]
        assert t.query(QUERIES["raw_count"])[1] == [(460,)]
        assert (t.query("SELECT * FROM analyzed ORDER BY tx_id", max_rows=7)
                == j.query("SELECT * FROM analyzed ORDER BY tx_id",
                           max_rows=7))
    finally:
        t.close()
        j.close()
    assert tsql.parquet_files(str(analyzed_dir)) == jsql.parquet_files(
        str(analyzed_dir))


@pytest.mark.parametrize("argv", [
    ["SELECT COUNT(*) AS n FROM analyzed"],
    ["SELECT tx_id, prediction FROM analyzed ORDER BY tx_id", "--limit",
     "3"],
    ["SELECT tx_id FROM analyzed ORDER BY tx_id", "--limit", "0"],
    ["SELECT nope FROM analyzed"],
], ids=["count", "truncated", "unlimited", "bad-column"])
def test_sql_command_prints_the_jax_lines(analyzed_dir, sqlite_route,
                                          capsys, argv):
    full = ["sql", "--data", str(analyzed_dir), *argv]
    rc = jcli.main(full)
    want = capsys.readouterr().out.strip().splitlines()
    assert tcli.main(full) == rc
    assert capsys.readouterr().out.strip().splitlines() == want
    json.loads(want[-1])


def test_sql_command_on_a_missing_directory(tmp_path, capsys):
    argv = ["sql", "--data", str(tmp_path), "SELECT 1"]
    assert tcli.main(argv) == jcli.main(argv) == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert out[0] == out[1] and "FileNotFoundError" in out[0]


def test_duckdb_route_gives_the_sqlite_rows(analyzed_dir):
    pytest.importorskip("duckdb", reason="the DuckDB route needs duckdb")
    db = tsql.AnalyzedSql(str(analyzed_dir))
    try:
        assert db.engine == "duckdb"
        assert db.query(QUERIES["count"])[1] == [(400,)]
    finally:
        db.close()
