"""The harness finds every configuration, traffic mix, limit file and
metric reader by the names ``BENCHMARK.json`` gives, and the file keeps
to the benchmark's contract."""

import json
import re

import pytest

from fraudbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_by_name(cell):
    c = harness.load_cell(cell)
    assert c["cell"]["chips"] == 1
    assert c["config"]["name"] == c["cell"]["config"]
    assert c["traffic"].name == c["cell"]["traffic"]
    assert hasattr(c["kind"], "Kind")
    assert set(c["limits"]["limits"]) >= {"rows_missing", "bad_probs"}
    e2e = {m["name"] for m in c["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c["per_layer"]
    # every per-layer metric here moves an end-to-end metric it reports
    assert {m["moves"] for m in c["per_layer"]} <= e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_reader_by_name(metric):
    assert callable(harness.reader(metric))


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["fraudbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in METRICS] + [
        w["name"] for w in BENCH["workloads"]] + [
        c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in METRICS:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "layer", "moves", "workloads"}
        assert set(m.get("workloads", [])) <= cells
    for c in BENCH["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert c["file"].startswith("fraudbench/")
        assert cfg["reduced"] == c["reduced"]
        assert len(cfg["source"]) <= 200 and cfg["assumed"]
    assert len(json.dumps(BENCH)) < 64 * 1024
