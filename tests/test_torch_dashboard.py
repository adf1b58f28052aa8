"""The port's ``io/dashboard.py`` and ``dashboard``/``trace`` commands
against the JAX package's: the analyzed view, the ops view (with the
Cluster and Elasticity tiles over a flight record the port's launcher
writes) and the ASCII trace waterfall render byte for byte as the JAX
ones, once the pages' generation stamp (``time.gmtime()`` with no
argument) is fixed in both."""

import json
import time

import numpy as np
import pytest

from real_time_fraud_detection_system_tpu import cli as jcli
from real_time_fraud_detection_system_tpu.io import dashboard as jdash
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch.io import dashboard as tdash
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    FlightRecorder,
)
from test_torch_query import analyzed_columns, write_analyzed  # tests/


@pytest.fixture
def fixed_stamp(monkeypatch):
    """``time.gmtime()`` (no argument: the page's generation stamp) at a
    fixed instant; with an argument (the chart labels) unchanged. Both
    packages' modules read the one ``time`` module."""
    real = time.gmtime
    monkeypatch.setattr(time, "gmtime",
                        lambda *a: real(*a) if a else real(1_760_000_000))


@pytest.fixture(scope="module")
def analyzed_dir(tmp_path_factory):
    pytest.importorskip("pyarrow", reason="the analyzed output is Parquet")
    d = tmp_path_factory.mktemp("dash") / "analyzed"
    write_analyzed(d)
    return d


class _Worker:
    """What the launcher's report reads of a worker process."""

    def __init__(self, pid, rc, rows, restarts):
        self.process_id, self._rc, self.restarts = pid, rc, restarts
        self._rows, self.log_path = rows, f"w{pid}.log"

    def poll(self):
        return self._rc

    def stats(self):
        return {"rows": self._rows, "rows_per_s": self._rows / 2.0,
                "cpu_s": 1.0, "batches": 3}


@pytest.fixture
def launcher_record(tmp_path, capsys):
    """A flight record written as the port's launcher writes one for an
    autoscaled fleet: a resize begun, rolled back, begun and completed,
    a fleet restart, and the workers' exit records (one failed)."""
    import argparse

    from real_time_fraud_detection_system_tpu_torch.tools import (
        multihost_launcher as launcher,
    )

    path = str(tmp_path / "launcher.jsonl")
    rec = FlightRecorder(path, manifest={
        "multihost": {"processes": 3, "coordinated": True,
                      "autoscale": True}})
    rec.record_event("cluster_worker_start", process=0, generation=0)
    rec.record_event("resize_begin", direction="grow", current=2, target=3,
                     reason="lag")
    rec.record_event("resize_rollback", stage="drain", why="timeout",
                     direction="grow")
    rec.record_event("resize_begin", direction="grow", current=2, target=3,
                     reason="lag")
    rec.record_event("resize_complete", direction="grow", processes=3,
                     generation=2, seconds=4.25)
    rec.record_event("fleet_restart", generation=1, died=[2])
    rec.record_event("cluster_worker_restart", process=1, attempt=1)
    workers = [_Worker(0, 0, 900, 0), _Worker(1, 0, 300, 1),
               _Worker(2, 1, 40, 1)]
    args = argparse.Namespace(processes=3, serialize=False)
    assert launcher._report(args, workers, {}, 1, "127.0.0.1:1", rec,
                            0) == 1
    capsys.readouterr()
    return path


def _batch_record(tmp_path) -> str:
    path = str(tmp_path / "flight.jsonl")
    rec = FlightRecorder(path, manifest={
        "model_kind": "forest", "backend": "cuda", "n_devices": 1,
        "config_hash": "deadbeef00000000"})
    for i in range(1, 9):
        rec.record_batch(i, 512, {
            "source_poll": 0.0005, "host_prep": 0.001,
            "dispatch": 0.004 + 0.01 * (i == 5),
            "result_wait": 0.0002, "sink_write": 0.002,
        }, queue_depth=1, latency_s=0.008)
    rec.record_event("fault", fault_kind="flaky_poll", poll=3)
    rec.record_event("checkpoint", op="save", batches_done=4, bytes=1024)
    rec.record_event("dead_letter", rows=3, batch=6, reason="poison")
    rec.close()
    return path


@pytest.mark.parametrize("kw", [
    {}, {"bucket": "hour", "threshold": 0.3, "top_k": 4,
         "title": "<b>ops & co</b>"}], ids=["defaults", "flags"])
def test_analyzed_view_is_the_jax_page(fixed_stamp, kw):
    cols = analyzed_columns(np.random.default_rng(9), np.arange(300), 7)
    assert tdash.render_dashboard_html(cols, **kw) == \
        jdash.render_dashboard_html(cols, **kw)
    assert tdash.render_dashboard_html({}) == jdash.render_dashboard_html({})


def test_dashboard_command_writes_the_jax_page(analyzed_dir, tmp_path,
                                               fixed_stamp, capsys):
    lines = []
    for main, name in ((jcli.main, "j.html"), (tcli.main, "t.html")):
        assert main(["dashboard", "--data", str(analyzed_dir), "--out",
                     str(tmp_path / name), "--bucket", "hour"]) == 0
        lines.append(json.loads(capsys.readouterr().out.splitlines()[-1]))
    assert (tmp_path / "t.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()
    assert lines[0].pop("dashboard") != lines[1].pop("dashboard")
    assert lines[0] == lines[1] and lines[1]["transactions"] == 400


def test_ops_view_of_a_serving_record_is_the_jax_page(tmp_path, fixed_stamp,
                                                      capsys):
    path = _batch_record(tmp_path)
    for main, name in ((jcli.main, "j.html"), (tcli.main, "t.html")):
        assert main(["dashboard", "--flight-record", path, "--out",
                     str(tmp_path / name)]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[0])["batches"] == json.loads(out[1])["batches"] \
        == 8
    assert (tmp_path / "t.html").read_bytes() == \
        (tmp_path / "j.html").read_bytes()


def test_ops_view_cluster_and_elasticity_tiles_are_the_jax_page(
        launcher_record, tmp_path, fixed_stamp):
    from real_time_fraud_detection_system_tpu.utils.metrics import (
        FlightRecorder as JRecorder,
    )

    man, records = FlightRecorder.read(launcher_record)
    assert (man, records) == JRecorder.read(launcher_record)
    got = tdash.render_ops_html(man, records)
    assert got == jdash.render_ops_html(man, records)
    for text in ("Cluster", "3 proc", "worst p2", "FAILED",
                 "1 fleet restart(s)", "1 worker restart(s)", "Elasticity",
                 "1 ok / 1 back", "rolled back", "gen 2"):
        assert text in got, text
    assert tdash.write_ops_dashboard(launcher_record,
                                     str(tmp_path / "t.html")) == \
        {**jdash.write_ops_dashboard(launcher_record,
                                     str(tmp_path / "j.html")),
         "dashboard": str(tmp_path / "t.html")}


def _score_trace(tmp_path) -> str:
    """A Chrome trace of a short ``score`` run of the port on the CPU."""
    from real_time_fraud_detection_system_tpu_torch.data import (
        generate_dataset,
    )
    from real_time_fraud_detection_system_tpu_torch.config import DataConfig
    from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
        TrainedModel,
        save_model,
        save_transactions,
    )
    from real_time_fraud_detection_system_tpu_torch.models.forest import (
        synthetic_ensemble,
    )
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        fit_scaler,
    )

    _, _, txs = generate_dataset(DataConfig(n_customers=40, n_terminals=80,
                                            n_days=10))
    save_transactions(str(tmp_path / "txs.npz"), txs)
    save_model(str(tmp_path / "m.npz"), TrainedModel(
        "forest", fit_scaler(np.ones((2, 15)), device="cpu"),
        synthetic_ensemble(3, 3, device="cpu")))
    assert tcli.main(["score", "--device", "cpu", "--data",
                      str(tmp_path / "txs.npz"), "--model-file",
                      str(tmp_path / "m.npz"), "--batch-rows", "128",
                      "--trace-out", str(tmp_path / "trace.json")]) == 0
    return str(tmp_path / "trace.json")


def _roots_only(trace: dict) -> dict:
    """The trace without its child spans (those with ``args.parent``)."""
    return {**trace, "traceEvents": [
        e for e in trace["traceEvents"]
        if "parent" not in (e.get("args") or {})]}


def _digest(main, path: str, capsys) -> dict:
    assert main(["trace", "--trace", path, "--json"]) == 0
    return json.loads(capsys.readouterr().out)


def test_trace_command_and_waterfall_equal_jax(tmp_path, capsys):
    """The port's span trace renders as the JAX package renders it: the
    waterfall of the whole trace, the ``trace`` command's output on its
    root spans; on the whole trace the port's digest has the roots' batch
    phases (the JAX package's digest of the roots), each batch's children
    and self times beside them, and the same slowest spans."""
    path = _score_trace(tmp_path)
    capsys.readouterr()
    with open(path) as f:
        trace = json.load(f)
    for tid in (None, "b00000002", "nope"):
        assert tdash.render_trace_waterfall(trace, trace_id=tid) == \
            jdash.render_trace_waterfall(trace, trace_id=tid)
    assert tdash.render_trace_waterfall({}) == "no spans in trace"
    roots = str(tmp_path / "roots.json")
    with open(roots, "w") as f:
        json.dump(_roots_only(trace), f)
    for flags in (["--json"], [], ["--top-k", "2", "--batch", "b00000003"]):
        argv = ["trace", "--trace", roots, *flags]
        assert jcli.main(argv) == 0
        want = capsys.readouterr().out
        assert tcli.main(argv) == 0
        assert capsys.readouterr().out == want
    got, want = _digest(tcli.main, path, capsys), _digest(jcli.main, path,
                                                         capsys)
    for key in ("slowest_spans", "compile_events", "n_events"):
        assert got[key] == want[key], key
    assert [{k: v for k, v in b.items() if k not in ("children_ms",
                                                      "self_ms")}
            for b in got["batches"]] == _digest(jcli.main, roots,
                                                capsys)["batches"]
    assert all("host_prep/pack" in b["children_ms"]
               for b in got["batches"] if "host_prep" in b["phases_ms"])
    bad = ["trace", "--trace", str(tmp_path / "none.json")]
    assert jcli.main(bad) == tcli.main(bad) == 2


def test_dashboard_command_refusals_equal_jax(tmp_path, capsys):
    for argv in (["dashboard"],
                 ["dashboard", "--data", str(tmp_path / "nope"), "--out",
                  str(tmp_path / "d.html")]):
        assert jcli.main(argv) == 2
        want = capsys.readouterr().out.strip().splitlines()[-1]
        assert tcli.main(argv) == 2
        assert capsys.readouterr().out.strip().splitlines()[-1] == want
