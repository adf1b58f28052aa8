"""The readers of the program's ``trace`` entry (``ScoringEngine.run``'s
stats with the tracer on): each reads its number from a synthetic
context, and none without the entry, as a program without it (or an
untraced run) gives."""

import pytest

from fraudbench import harness

TRACE = {
    "spans": {
        "host_prep/dedup": {"count": 10, "median_ms": 1.25, "self_ms": 13.0},
        "host_prep/pack": {"count": 10, "median_ms": 0.5, "self_ms": 5.5},
        "sink_write/convert": {"count": 10, "median_ms": 3.5,
                               "self_ms": 36.0},
        "result_wait/fetch_wait": {"count": 10, "median_ms": 0.125,
                                   "self_ms": 2.0},
    },
    "device": {
        "device/step": {"count": 10, "median_ms": 6.5, "mean_ms": 6.75},
        "device/compact": {"count": 2, "median_ms": 4.0, "mean_ms": 4.5},
    },
    "counters": {
        "transfer_bytes": {"h2d": 18350080.0, "d2h": 41943200.0},
        "compact_slots_swept": {"customer": 4194304.0,
                                "terminal": 8388608.0},
    },
}
WANT = {
    "host_dedup_ms": 1.25,
    "host_pack_ms": 0.5,
    "sink_convert_ms": 3.5,
    # the mean: a few batches wait, most do not
    "fetch_wait_ms": 0.2,
    "fetch_wait_ms.seq": 0.2,
    "step_device_ms.seq": 6.5,
    "compact_device_ms": 4.5,
    "compact_slots_swept_per_batch": (4194304.0 + 8388608.0) / 10,
    "d2h_bytes_per_batch": 41943200.0 / 10,
}
BASE = {"batches": 10, "stage_ms_p50": {"host_prep": 3.0}}


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader_reads_the_trace_entry(metric):
    read = harness.reader(metric)
    assert read({"stats": {**BASE, "trace": TRACE}}) == \
        pytest.approx(WANT[metric])
    assert read({"stats": dict(BASE)}) is None
    # a trace entry without the span, signature or counter (a kind or
    # key mode that has none): nothing to read
    empty = {"spans": {}, "device": {}, "counters": {
        "transfer_bytes": {"h2d": 0.0, "d2h": 0.0},
        "compact_slots_swept": {}}}
    got = read({"stats": {**BASE, "trace": empty}})
    assert got is None or (metric == "d2h_bytes_per_batch" and got == 0.0)


def test_every_trace_reader_is_in_the_benchmark():
    listed = {m["name"] for m in harness.load_json(
        harness.ROOT / "BENCHMARK.json")["per_layer"]}
    assert set(WANT) <= listed
