"""The port's ``io/query.py`` and ``query`` command against the JAX
package's: the same Parquet directory (with crash-replay duplicates: a
later part re-scores some transactions) gives the same JSON for every
``--report``, and the raw table's ``transactions`` report the same."""

import json

import numpy as np
import pytest

from real_time_fraud_detection_system_tpu import cli as jcli
from real_time_fraud_detection_system_tpu.io import query as jquery
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch.features.spec import (
    FEATURE_NAMES,
)
from real_time_fraud_detection_system_tpu_torch.io import query as tquery

US_PER_DAY = 86400 * 1_000_000
START_US = 1_743_465_600 * 1_000_000  # 2025-04-01


def analyzed_columns(rng, tx_ids, processed_at_us: int) -> dict:
    """Analyzed-output columns as the sinks write them (every feature
    column, int32 counts) for ``tx_ids``, stamped ``processed_at_us``."""
    n = len(tx_ids)
    cols = {
        "tx_id": np.asarray(tx_ids, np.int64),
        "tx_datetime_us": START_US + np.sort(
            rng.integers(0, 6 * US_PER_DAY, n)).astype(np.int64),
        "customer_id": rng.integers(0, 30, n).astype(np.int64),
        "terminal_id": rng.integers(0, 20, n).astype(np.int64),
        "tx_amount": np.round(rng.uniform(1, 300, n), 2),
    }
    for name in FEATURE_NAMES:
        if name == "TX_AMOUNT":
            continue
        if "NB_TX" in name or "DURING" in name:
            cols[name.lower()] = rng.integers(0, 9, n).astype(np.int32)
        else:
            cols[name.lower()] = rng.uniform(0, 200, n)
    cols["processed_at_us"] = np.full(n, processed_at_us, np.int64)
    cols["prediction"] = rng.beta(0.5, 3.0, n)
    return cols


def write_analyzed(directory) -> None:
    """Three parts: two batches of 200 rows, then a replay that re-scores
    60 of the first batch's transactions later (latest wins on read)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    directory.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(5)
    parts = [analyzed_columns(rng, np.arange(200), 1_000),
             analyzed_columns(rng, np.arange(200, 400), 2_000),
             analyzed_columns(rng, np.arange(0, 120, 2), 3_000)]
    for i, cols in enumerate(parts):
        pq.write_table(pa.table({k: pa.array(v) for k, v in cols.items()}),
                       str(directory / f"part-{i:08d}.parquet"))


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def analyzed_dir(tmp_path_factory):
    pytest.importorskip("pyarrow", reason="the analyzed output is Parquet")
    d = tmp_path_factory.mktemp("q") / "analyzed"
    write_analyzed(d)
    return d


def test_load_analyzed_keeps_the_latest_version(analyzed_dir):
    got, want = (tquery.load_analyzed(str(analyzed_dir)),
                 jquery.load_analyzed(str(analyzed_dir)))
    assert len(got["tx_id"]) == 400
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    replayed = np.isin(got["tx_id"], np.arange(0, 120, 2))
    assert (got["processed_at_us"][replayed] == 3_000).all()


@pytest.mark.parametrize("report", ["summary", "timeseries", "terminals",
                                    "customers", "alerts", "drift"])
@pytest.mark.parametrize("flags", [(), ("--threshold", "0.3", "--top-k",
                                        "4", "--bucket", "hour")],
                         ids=["defaults", "flags"])
def test_query_reports_equal_jax(analyzed_dir, capsys, report, flags):
    argv = ["query", "--data", str(analyzed_dir), "--report", report,
            *flags]
    assert jcli.main(argv) == 0
    want = last_json(capsys)
    assert tcli.main(argv) == 0
    assert last_json(capsys) == want
    assert want  # every report has content on this directory


def test_psi_equals_jax():
    rng = np.random.default_rng(2)
    tied = np.zeros(500)
    tied[:20] = rng.uniform(0, 1, 20)
    for ref, cur in ((rng.normal(0, 1, 400), rng.normal(0.5, 1, 300)),
                     (tied, rng.uniform(0, 1, 200)), (np.ones(5), np.ones(5)),
                     (np.zeros(0), np.ones(3))):
        assert tquery._psi(ref, cur) == jquery._psi(ref, cur)


def test_raw_transactions_report_equals_jax(tmp_path, capsys):
    pytest.importorskip("pyarrow", reason="the raw table is Parquet")
    from real_time_fraud_detection_system_tpu_torch.io.tables import (
        RawTransactionsTable,
    )

    d = str(tmp_path / "transactions")
    tab = RawTransactionsTable(d)
    rng = np.random.default_rng(3)
    tab.merge({
        "tx_id": np.arange(50, dtype=np.int64),
        "tx_datetime_us": START_US + rng.integers(0, 4 * US_PER_DAY, 50),
        "customer_id": rng.integers(0, 9, 50),
        "terminal_id": rng.integers(0, 7, 50),
        "tx_amount_cents": rng.integers(100, 90_000, 50),
    })
    tab.flush()
    argv = ["query", "--data", d, "--report", "transactions"]
    assert jcli.main(argv) == 0
    want = last_json(capsys)
    assert tcli.main(argv) == 0
    assert last_json(capsys) == want and want["transactions"] == 50
    missing = ["query", "--data", str(tmp_path / "none"), "--report",
               "transactions"]
    assert jcli.main(missing) == tcli.main(missing) == 2


def test_query_without_pyarrow_exits_2_naming_it(analyzed_dir, monkeypatch,
                                                 caplog):
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "pyarrow"
                        else real(name, *a))
    assert tcli.main(["query", "--data", str(analyzed_dir)]) == 2
    assert "pyarrow" in caplog.text
