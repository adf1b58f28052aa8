"""The port's operator subcommands (``cli_ops.py``) against the JAX
package's, in process on the CPU: the subcommands and their flags are the
JAX ones (less ``lint`` and ``bench``, plus ``--device``), and each
command's output (its last JSON line, or every line where the command
prints several) equals the JAX command's on the same inputs — ``ckpt``,
``dlq``, ``registry`` over one score run's lineage, dead letters and
artifacts; ``demo`` and then ``query``, ``sql`` and ``dashboard`` on its
output; ``trace --json``; ``datagen`` (the same table); ``import-model``
(the same content hash from the same pickles); ``connectors`` against a
local HTTP stub. ``warmup`` and ``verify-device`` on the CPU list the
JAX engines' buckets. Wall-clock fields (``age_s``, ``created_unix``,
``promoted_unix``, timings) are dropped before comparing."""

import argparse
import importlib.util
import io
import json
import os
import pickle
import time
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest

from real_time_fraud_detection_system_tpu import cli as jcli
from real_time_fraud_detection_system_tpu.io.artifacts import (
    dump_model_bytes as jdump_model_bytes,
)
from real_time_fraud_detection_system_tpu.io.artifacts import (
    save_transactions as jsave_transactions,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import cli_ops

CLOCK_KEYS = ("age_s", "created_unix", "promoted_unix", "rows_per_s",
              "latency_p50_ms", "latency_p99_ms", "wall_s", "seconds",
              "compile_seconds", "total_seconds")
DEVICE_COMMANDS = {"score", "train", "compare", "select", "warmup", "dlq",
                   "demo", "verify-device"}


def _run(main, argv, capsys) -> tuple:
    rc = main(argv)
    return rc, [json.loads(x) for x in
                capsys.readouterr().out.strip().splitlines() if x]


def _unclocked(obj):
    if isinstance(obj, dict):
        return {k: _unclocked(v) for k, v in obj.items()
                if k not in CLOCK_KEYS}
    if isinstance(obj, list):
        return [_unclocked(v) for v in obj]
    return obj


def _assert_close(got, want, atol: float) -> None:
    """Equal structure and integers; floats within ``atol``."""
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_close(got[k], want[k], atol)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_close(g, w, atol)
    elif isinstance(want, float):
        assert got == pytest.approx(want, abs=atol)
    else:
        assert got == want


def _same(argv, capsys, port_extra=()):
    """Run ``argv`` through both CLIs; assert the same rc and lines."""
    rc, want = _run(jcli.main, argv, capsys)
    trc, got = _run(tcli.main, [*argv, *port_extra], capsys)
    assert trc == rc
    assert _unclocked(got) == _unclocked(want)
    return rc, got


# -- the parsers ----------------------------------------------------------


def _jax_parser():
    parser = None
    orig = argparse.ArgumentParser.parse_args

    def capture(self, argv=None, namespace=None):
        nonlocal parser
        parser = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            jcli.main(["score"])
    finally:
        argparse.ArgumentParser.parse_args = orig
    return parser


def _subparsers(parser) -> dict:
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: a for a in p._actions if a.dest != "help"}
            for name, p in sub.choices.items()}


def test_subcommands_and_flags_are_the_jax_ones():
    want = _subparsers(_jax_parser())
    got = _subparsers(tcli.build_parser())
    assert set(got) == set(want) - {"lint", "bench"}
    for cmd, actions in want.items():
        if cmd in ("lint", "bench"):
            continue
        extra = set(got[cmd]) - set(actions)
        assert extra == ({"device"} if cmd in DEVICE_COMMANDS else set()), \
            cmd
        if extra:
            assert got[cmd]["device"].default == "cuda"
        for dest, a in actions.items():
            t = got[cmd][dest]
            assert t.option_strings == a.option_strings, (cmd, dest)
            assert t.default == a.default, (cmd, dest)
            assert t.required == a.required, (cmd, dest)
            assert t.nargs == a.nargs, (cmd, dest)
            assert t.type == a.type, (cmd, dest)
            assert (list(t.choices) if t.choices else None) == \
                (list(a.choices) if a.choices else None), (cmd, dest)


# -- one score run's lineage, dead letters and trace ----------------------


@pytest.fixture(scope="module")
def served(small_dataset, tmp_path_factory):
    """The port's supervised ``score`` on the CPU over 3,000 rows with three
    poisoned ones: checkpoints, dead letters, a flight record and a span
    trace; the forest artifact the JAX package wrote."""
    d = tmp_path_factory.mktemp("served")
    txs = small_dataset[3].slice(slice(0, 3000))
    bad = txs.slice(slice(None))
    bad.amount_cents = np.array(bad.amount_cents, copy=True)
    bad.amount_cents[[1500, 1501, 2200]] *= -1
    jsave_transactions(str(d / "poisoned.npz"), bad)
    rng = np.random.default_rng(3)
    model = JTrainedModel(
        kind="forest",
        scaler=JScaler(jnp.asarray(rng.normal(3, 1, 15).astype(np.float32)),
                       jnp.asarray(rng.uniform(0.5, 3, 15)
                                   .astype(np.float32))),
        params=jforest.synthetic_ensemble(10, 5, 15, seed=3))
    with open(d / "forest.npz", "wb") as f:
        f.write(jdump_model_bytes(model))
    out = io.StringIO()
    from contextlib import redirect_stdout

    with redirect_stdout(out):
        rc = tcli.main([
            "score", "--device", "cpu", "--data", str(d / "poisoned.npz"),
            "--model-file", str(d / "forest.npz"), "--batch-rows", "512",
            "--checkpoint-dir", str(d / "ck"), "--max-restarts", "4",
            "--dead-letter", str(d / "dlq.jsonl"), "--flight-record",
            str(d / "flight.jsonl"), "--trace-out", str(d / "trace.json")])
    assert rc == 0
    stats = json.loads(out.getvalue().strip().splitlines()[-1])
    assert stats["dead_letter_rows"] == 3
    return SimpleNamespace(dir=d, stats=stats)


@pytest.mark.parametrize("flags", [(), ("--verify",)], ids=["list",
                                                            "verify"])
def test_ckpt_lists_and_verifies_as_jax(served, capsys, flags):
    rc, lines = _same(["ckpt", "--path", str(served.dir / "ck"), *flags],
                      capsys)
    assert rc == 0 and lines[0]["checkpoints"] >= 1
    assert lines[0]["corrupt"] == 0


def test_ckpt_inspect_and_corruption_as_jax(served, capsys, tmp_path):
    import shutil

    ck = tmp_path / "ck"
    shutil.copytree(served.dir / "ck", ck)
    latest = sorted(p for p in os.listdir(ck) if p.startswith("ckpt-"))[-1]
    rc, lines = _same(["ckpt", "--path", str(ck), "--inspect", latest],
                      capsys)
    assert rc == 0
    man = lines[-1]
    assert man["topology"] == {"process_count": 1, "process_id": 0,
                               "layout_devices": 1, "fleet_shards_total": 1}
    assert man["feature_state"]["leaves"]
    assert _same(["ckpt", "--path", str(ck), "--inspect", "nope.npz"],
                 capsys)[0] == 2
    data = bytearray((ck / latest).read_bytes())
    data[len(data) // 2] ^= 0xFF
    (ck / latest).write_bytes(bytes(data))
    rc, lines = _same(["ckpt", "--path", str(ck), "--verify"], capsys)
    assert rc == 1 and lines[0]["corrupt"] == 1


def test_dlq_inspects_as_jax(served, capsys):
    for flags in ((), ("--limit", "1"), ("--limit", "0")):
        rc, lines = _same(["dlq", "--path", str(served.dir / "dlq.jsonl"),
                           *flags], capsys)
        assert rc == 0 and lines[0]["rows"] == 3
    assert _same(["dlq", "--path", str(served.dir / "none.jsonl")],
                 capsys)[0] == 2
    assert _same(["dlq", "--path", str(served.dir / "dlq.jsonl"),
                  "--replay"], capsys, ("--device", "cpu"))[0] == 2


def test_dlq_replay_as_jax(served, capsys):
    argv = ["dlq", "--path", str(served.dir / "dlq.jsonl"), "--replay",
            "--model-file", str(served.dir / "forest.npz")]
    rc, want = _run(jcli.main, argv, capsys)
    trc, got = _run(tcli.main, [*argv, "--device", "cpu"], capsys)
    assert rc == trc == 0
    assert got[0] == want[0] and want[0]["replayed"] == 3
    for g, w in zip(got[1:], want[1:]):
        assert g.keys() == w.keys() and g["tx_id"] == w["tx_id"]
        if "error" in w:  # a negative amount is still poison
            assert g["still_poison"] and g["error"].split(":")[0] == \
                w["error"].split(":")[0]
        else:
            assert g["prediction"] == pytest.approx(w["prediction"],
                                                    abs=1e-6)


def test_trace_json_as_jax(served, capsys, tmp_path):
    """The JAX ``trace`` digest of the port's trace: its batches are the
    port's on the root spans alone (the port's also carry each batch's
    children and self times), the rest is the same."""
    path = str(served.dir / "trace.json")
    with open(path) as f:
        trace = json.load(f)
    roots = str(tmp_path / "roots.json")
    with open(roots, "w") as f:
        json.dump({**trace, "traceEvents": [
            e for e in trace["traceEvents"]
            if "parent" not in (e.get("args") or {})]}, f)
    argv = ["--json", "--top-k", "3"]
    rc, want = _run(jcli.main, ["trace", "--trace", path, *argv], capsys)
    trc, got = _run(tcli.main, ["trace", "--trace", path, *argv], capsys)
    assert rc == trc == 0
    _, roots_want = _same(["trace", "--trace", roots, *argv], capsys)
    assert [{k: v for k, v in b.items() if k not in ("children_ms",
                                                      "self_ms")}
            for b in got[0]["batches"]] == roots_want[0]["batches"]
    assert {k: v for k, v in got[0].items() if k != "batches"} == \
        {k: v for k, v in want[0].items() if k != "batches"}
    # a replayed batch after a restart is traced again
    assert len(got[0]["batches"]) >= served.stats["batches"]


def test_registry_as_jax(served, capsys, tmp_path):
    reg = str(tmp_path / "reg")
    model = str(served.dir / "forest.npz")
    for main in (tcli.main, jcli.main):
        rc, lines = _run(main, ["registry", "--path", reg, "--publish",
                                model], capsys)
        assert rc == 0 and lines[-1]["kind"] == "forest"
    assert _run(tcli.main, ["registry", "--path", reg, "--promote", "1"],
                capsys)[0] == 0
    assert _run(jcli.main, ["registry", "--path", reg, "--promote", "2"],
                capsys)[0] == 0
    for flags in ((), ("--verify",), ("--inspect", "2"), ("--inspect", "9"),
                  ("--promote", "9")):
        _same(["registry", "--path", reg, *flags], capsys)
    rc, lines = _run(tcli.main, ["registry", "--path", reg, "--rollback"],
                     capsys)
    assert rc == 0 and lines[-1] == {"champion": 1, "by": "rollback"}
    _same(["registry", "--path", reg], capsys)
    # a corrupt artifact is refused for publishing, rc 1 in both (each
    # package reads its own copy: a failed read quarantines the file)
    data = bytearray((served.dir / "forest.npz").read_bytes())
    data[len(data) // 2] ^= 0xFF
    for i, main in enumerate((jcli.main, tcli.main)):
        bad = tmp_path / f"bad{i}.npz"
        bad.write_bytes(bytes(data))
        assert main(["registry", "--path", reg, "--publish", str(bad)]) == 1
    capsys.readouterr()


# -- demo, then query, sql and dashboard on its output --------------------


DEMO_ARGS = ["--customers", "80", "--terminals", "160", "--days", "40",
             "--seed", "3", "--delta-train", "15", "--delta-delay", "5",
             "--delta-test", "5", "--batch-rows", "1024"]


@pytest.fixture(scope="module")
def demos(tmp_path_factory):
    pytest.importorskip("pyarrow", reason="demo --out writes Parquet")
    d = tmp_path_factory.mktemp("demo")
    rng = np.random.default_rng(4)
    model = JTrainedModel(
        kind="forest",
        scaler=JScaler(jnp.asarray(rng.normal(3, 1, 15).astype(np.float32)),
                       jnp.asarray(rng.uniform(0.5, 3, 15)
                                   .astype(np.float32))),
        params=jforest.synthetic_ensemble(12, 5, 15, seed=4))
    with open(d / "forest.npz", "wb") as f:
        f.write(jdump_model_bytes(model))
    out = {}
    for name, main, extra in (("jax", jcli.main, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        buf = io.StringIO()
        from contextlib import redirect_stdout

        with redirect_stdout(buf):
            assert main(["demo", *DEMO_ARGS, "--model-file",
                         str(d / "forest.npz"), "--out", str(d / name),
                         *extra]) == 0
        out[name] = json.loads(buf.getvalue().strip().splitlines()[-1])
    return d, out


def test_demo_prints_the_jax_summary(demos):
    d, out = demos
    got, want = (_unclocked(out[k]) for k in ("port", "jax"))
    assert got.pop("dashboard") == str(d / "port" / "dashboard.html")
    assert want.pop("dashboard") == str(d / "jax" / "dashboard.html")
    assert got.pop("stream_auc") == pytest.approx(want.pop("stream_auc"),
                                                  abs=1e-6)
    assert got == want and got["streamed_rows"] > 0


@pytest.mark.parametrize("argv", [
    ["query", "--report", "summary"], ["query", "--report", "drift"],
    ["query", "--report", "terminals", "--top-k", "3"],
    ["sql", "SELECT COUNT(*) AS n, SUM(prediction >= 0.5) AS flagged "
            "FROM analyzed"],
], ids=["summary", "drift", "terminals", "sql"])
def test_query_and_sql_on_the_demo_output_as_jax(demos, capsys, argv):
    d, _ = demos
    got = _run(tcli.main, [argv[0], "--data", str(d / "port"), *argv[1:]],
               capsys)
    want = _run(jcli.main, [argv[0], "--data", str(d / "jax"), *argv[1:]],
                capsys)
    assert got[0] == want[0] == 0
    # the two packages sum a forest's trees in another order: scores agree
    # within 1e-6 (the drift report rounds to 4 places), counts exactly
    _assert_close(got[1], want[1], 1e-4 if argv[-1] == "drift" else 1e-6)


def test_demo_dashboards_are_the_jax_page(demos, monkeypatch):
    """The pages ``demo --out`` wrote, re-rendered with a fixed stamp
    from each package's own output."""
    from real_time_fraud_detection_system_tpu.io import dashboard as jdash
    from real_time_fraud_detection_system_tpu_torch.io import (
        dashboard as tdash,
    )

    d, _ = demos
    real = time.gmtime
    monkeypatch.setattr(time, "gmtime",
                        lambda *a: real(*a) if a else real(1_760_000_000))
    tdash.write_dashboard(str(d / "port"), str(d / "t.html"))
    jdash.write_dashboard(str(d / "jax"), str(d / "j.html"))
    assert (d / "port" / "dashboard.html").exists()
    assert (d / "t.html").read_text() == (d / "j.html").read_text()


def test_demo_refusals_as_jax(tmp_path, capsys, monkeypatch, caplog):
    assert _same(["demo", "--out", "s3://bucket/out"], capsys,
                 ("--device", "cpu"))[0] == 2
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "sklearn"
                        else real(name, *a))
    assert tcli.main(["demo", "--device", "cpu", "--model", "forest"]) == 2
    assert "sklearn" in caplog.text


# -- datagen --------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    ["--customers", "30", "--terminals", "60", "--days", "12"],
    ["--customers", "25", "--terminals", "40", "--days", "9", "--seed",
     "4", "--radius", "8", "--start-date", "2024-02-28"],
], ids=["small", "flags"])
def test_datagen_writes_the_jax_table(tmp_path, flags):
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        assert main(["datagen", "--out", str(tmp_path / f"{name}.npz"),
                     *flags]) == 0
    with np.load(tmp_path / "jax.npz") as j, \
            np.load(tmp_path / "port.npz") as t:
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


# -- import-model ---------------------------------------------------------


def _sha(path) -> str:
    with np.load(path) as z:
        return json.loads(str(z["__meta__"]))["content_sha256"]


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    pytest.importorskip("sklearn", reason="the pickles are sklearn models")
    import joblib
    from sklearn.ensemble import ExtraTreesClassifier, RandomForestClassifier
    from sklearn.linear_model import LogisticRegression
    from sklearn.preprocessing import StandardScaler
    from sklearn.tree import DecisionTreeClassifier

    d = tmp_path_factory.mktemp("pkl")
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 15))
    y = (x[:, 0] + 0.3 * x[:, 4] > 0.5).astype(np.int32)
    sc = StandardScaler().fit(x)
    xs = sc.transform(x)
    joblib.dump(sc, d / "scaler.pkl")
    models = {
        "rf": RandomForestClassifier(n_estimators=6, max_depth=4,
                                     random_state=0).fit(xs, y),
        "et": ExtraTreesClassifier(n_estimators=4, max_depth=3,
                                   random_state=0).fit(xs, y),
        "dt": DecisionTreeClassifier(max_depth=5, random_state=0).fit(xs, y),
        "lr": LogisticRegression().fit(xs, y),
        "wide": LogisticRegression().fit(rng.normal(size=(50, 20)),
                                         rng.integers(0, 2, 50)),
        "multi": LogisticRegression().fit(x, rng.integers(0, 3, 400)),
    }
    for name, clf in models.items():
        with open(d / f"{name}.pkl", "wb") as f:
            pickle.dump(clf, f)
    return d


@pytest.mark.parametrize("name,kind", [("rf", "forest"), ("et", "forest"),
                                       ("dt", "tree"), ("lr", "logreg")])
@pytest.mark.parametrize("scaled", [True, False], ids=["scaler", "identity"])
def test_import_model_gives_the_jax_artifact(pickles, tmp_path, capsys, name,
                                             kind, scaled):
    extra = ["--scaler-pkl", str(pickles / "scaler.pkl")] if scaled else []
    lines = {}
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        out = str(tmp_path / f"{pkg}.npz")
        rc, lines[pkg] = _run(main, ["import-model", "--model-pkl",
                                     str(pickles / f"{name}.pkl"),
                                     "--out-model", out, *extra], capsys)
        assert rc == 0
    assert lines["port"][-1]["kind"] == kind
    assert lines["port"][-1]["n_features"] == 15
    assert _sha(tmp_path / "port.npz") == _sha(tmp_path / "jax.npz")


@pytest.mark.parametrize("name", ["wide", "multi"])
def test_import_model_refusals_as_jax(pickles, tmp_path, capsys, name):
    assert _same(["import-model", "--model-pkl", str(pickles / f"{name}.pkl"),
                  "--out-model", str(tmp_path / "m.npz")], capsys)[0] == 2


def test_import_model_of_an_s3_pickle(pickles, tmp_path, capsys,
                                      monkeypatch):
    from real_time_fraud_detection_system_tpu_torch.io import store
    from test_store import FakeS3Client  # pytest adds tests/

    client = FakeS3Client()
    client.put_object("commerce", "trained_model.pkl",
                      (pickles / "rf.pkl").read_bytes())
    monkeypatch.setattr(store, "make_store", lambda url, **kw:
                        store.S3Store(url[len("s3://"):].partition("/")[0],
                                      client=client))
    rc, lines = _run(tcli.main, ["import-model", "--model-pkl",
                                 "s3://commerce/trained_model.pkl",
                                 "--out-model", str(tmp_path / "m.npz")],
                     capsys)
    assert rc == 0 and lines[-1]["kind"] == "forest"
    assert tcli.main(["import-model", "--model-pkl", "s3://commerce",
                      "--out-model", str(tmp_path / "x.npz")]) == 2


def test_import_model_of_an_xgboost_pickle(tmp_path, capsys):
    xgb = pytest.importorskip("xgboost",
                              reason="an XGBClassifier pickle needs xgboost")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(200, 15))
    clf = xgb.XGBClassifier(n_estimators=3, max_depth=3).fit(
        x, (x[:, 0] > 0).astype(int))
    with open(tmp_path / "x.pkl", "wb") as f:
        pickle.dump(clf, f)
    for pkg, main in (("jax", jcli.main), ("port", tcli.main)):
        assert main(["import-model", "--model-pkl", str(tmp_path / "x.pkl"),
                     "--out-model", str(tmp_path / f"{pkg}.npz")]) == 0
    assert _sha(tmp_path / "port.npz") == _sha(tmp_path / "jax.npz")


def test_import_model_names_a_missing_unpickler(tmp_path, caplog):
    # protocol 0: the global nosuchmodule.Thing, then STOP
    (tmp_path / "m.pkl").write_bytes(b"cnosuchmodule\nThing\n.")
    assert tcli.main(["import-model", "--model-pkl", str(tmp_path / "m.pkl"),
                      "--out-model", str(tmp_path / "m.npz")]) == 2
    assert "nosuchmodule" in caplog.text


# -- connectors -----------------------------------------------------------


@pytest.fixture
def connect_stub():
    """A local Kafka-Connect REST stub recording each POST and echoing its
    body (password included), with a settable status."""
    import threading
    from http.server import BaseHTTPRequestHandler, HTTPServer

    posts = []

    class Handler(BaseHTTPRequestHandler):
        status = 201

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            posts.append((self.path, dict(self.headers.items()),
                          json.loads(self.rfile.read(n))))
            self.send_response(Handler.status)
            self.send_header("Content-Type", "application/json")
            self.end_headers()
            self.wfile.write(json.dumps(posts[-1][2]).encode())

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", posts, Handler
    srv.shutdown()
    srv.server_close()


@pytest.mark.parametrize("status", [201, 409, 500])
def test_connectors_post_as_jax(connect_stub, capsys, status):
    url, posts, handler = connect_stub
    handler.status = status
    argv = ["connectors", "--connect-url", url + "/", "--db-password",
            "s3cret", "--schema", "payment", "--name", "pg-src"]
    rc, lines = _same(argv, capsys)
    assert rc == {201: 0, 409: 0, 500: 1}[status]
    (jpath, jhead, jbody), (tpath, thead, tbody) = posts
    assert tpath == jpath == "/connectors/" and tbody == jbody
    assert thead["Content-Type"] == jhead["Content-Type"]
    assert tbody["config"]["database.password"] == "s3cret"
    if status == 201:
        assert lines[-1]["response"]["config"]["database.password"] == "***"
    elif status == 409:
        assert lines[-1]["already_registered"] is True


def test_connectors_unreachable_as_jax(capsys):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert _same(["connectors", "--connect-url", f"http://127.0.0.1:{port}",
                  "--timeout", "2"], capsys)[0] == 1


# -- warmup and verify-device ---------------------------------------------


def test_warmup_lists_the_jax_buckets(served, capsys):
    from real_time_fraud_detection_system_tpu.config import Config
    from real_time_fraud_detection_system_tpu.io.artifacts import load_model
    from real_time_fraud_detection_system_tpu.runtime import ScoringEngine

    m = load_model(str(served.dir / "forest.npz"))
    want = [sg.bucket for sg in ScoringEngine(
        Config(), kind="forest", params=m.params,
        scaler=m.scaler).dispatch_inventory()]
    rc, lines = _run(tcli.main, ["warmup", "--device", "cpu",
                                 "--model-file",
                                 str(served.dir / "forest.npz")], capsys)
    assert rc == 0
    out = lines[-1]
    assert set(out) == {"kind", "devices", "buckets", "variants",
                        "compile_seconds", "total_seconds"}
    assert out["buckets"] == want == [256, 1024, 4096, 16384, 65536]
    assert (out["kind"], out["devices"], out["variants"]) == ("forest", 1, 1)


def test_verify_device_lists_the_jax_signatures(capsys):
    import sys

    from real_time_fraud_detection_system_tpu.runtime.engine import (
        ScoringEngine as JEngine,
    )

    tools = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools")
    sys.path.insert(0, tools)
    try:
        from rtfdsverify.targets import make_target
    finally:
        sys.path.remove(tools)
    rc = tcli.main(["verify-device", "--device", "cpu", "--json"])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0 and report["summary"]["gate_failures"] == 0
    assert report["targets"] == [t[0] for t in cli_ops.VERIFY_TARGETS]
    records = {r["target"]: r for r in cli_ops.verify_capture(
        __import__("torch").device("cpu"))}
    for name, kind, sharded, runtime_kw, features_kw in \
            cli_ops.VERIFY_TARGETS[:: 2]:
        jeng = make_target(kind, name=name, sharded=sharded,
                           features_kw=features_kw, **runtime_kw).engine
        assert records[name]["buckets"] == [
            sg.bucket for sg in jeng.dispatch_inventory()], name
        if not sharded:
            assert isinstance(jeng, JEngine)
    assert report["signatures_verified"] == sum(
        len(r["signatures"]) for r in records.values())


def test_verify_device_usage_errors(capsys):
    assert tcli.main(["verify-device", "--list-checks"]) == 0
    assert "capture" in capsys.readouterr().out
    assert tcli.main(["verify-device", "--device", "cpu", "--check",
                      "nope"]) == 2
    assert tcli.main(["verify-device", "--device", "cpu",
                      "--update-baseline", "--reason", "x"]) == 2


def test_verify_device_fails_a_target_that_does_not_capture(monkeypatch,
                                                            capsys):
    from real_time_fraud_detection_system_tpu_torch.runtime import engine

    def broken(self):
        raise RuntimeError("capture failed")

    monkeypatch.setattr(engine.ScoringEngine, "precompile", broken)
    rc = tcli.main(["verify-device", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 1 and "capture failed" in out


def test_operator_commands_default_to_the_card(served, tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    for argv in (["warmup", "--model-file", str(served.dir / "forest.npz")],
                 ["demo"],
                 ["dlq", "--path", str(served.dir / "dlq.jsonl"), "--replay",
                  "--model-file", str(served.dir / "forest.npz")]):
        with pytest.raises(RuntimeError, match="CUDA"):
            tcli.main(argv)
    assert tcli.main(["verify-device"]) == 2
