"""``fused_rows_share``'s reader: the share of the window's sequence rows
that the fused kernel scored, from the ``sequence_rows_scored`` counter of
the program's ``trace`` entry, and nothing where there is no entry or no
such counter (a program without it, or an untraced run)."""

import pytest

from fraudbench import harness

METRIC = "fused_rows_share.seq"
BASE = {"batches": 10, "stage_ms_p50": {"host_prep": 3.0}}


@pytest.mark.parametrize("rows, want", [
    ({"fused": 491520.0, "plain": 163840.0}, 0.75),
    ({"fused": 655360.0}, 1.0),
    ({"plain": 655360.0}, 0.0),
])
def test_reads_the_fused_share_of_rows_scored(rows, want):
    read = harness.reader(METRIC)
    trace = {"spans": {}, "device": {},
             "counters": {"sequence_rows_scored": rows}}
    assert read({"stats": {**BASE, "trace": trace}}) == pytest.approx(want)


@pytest.mark.parametrize("stats", [
    dict(BASE),
    {**BASE, "trace": {"spans": {}, "device": {}, "counters": {}}},
    {**BASE, "trace": {"spans": {}, "device": {},
                       "counters": {"sequence_rows_scored": {}}}},
])
def test_reads_nothing_without_the_counter(stats):
    assert harness.reader(METRIC)({"stats": stats}) is None


def test_the_reader_is_in_the_benchmark():
    listed = {m["name"]: m for m in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["per_layer"]}
    assert listed[METRIC]["workloads"] == ["sequence_k32.cards1m"]
