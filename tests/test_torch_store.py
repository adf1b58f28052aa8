"""The port's object store (``io/store.py``: ``S3Store``, ``make_store``)
and its users over ``s3://`` against the JAX package's, on the fake S3
client of ``tests/test_store.py`` (no boto3): the store's operations, the
store Parquet sink, artifact upload/download and ``s3://`` artifacts, a
checkpoint the JAX package writes to the store and the port restores (and
the reverse), the model registry, and the Iceberg sink's rows on a fake
catalog. Without boto3 an ``s3://`` URL raises ImportError naming it,
never a quiet local path."""

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.io import checkpoint as jckpt
from real_time_fraud_detection_system_tpu.io import registry as jreg
from real_time_fraud_detection_system_tpu.io import sink as jsink
from real_time_fraud_detection_system_tpu.io import store as jstore
from real_time_fraud_detection_system_tpu_torch.io import artifacts as tart
from real_time_fraud_detection_system_tpu_torch.io import checkpoint as tckpt
from real_time_fraud_detection_system_tpu_torch.io import registry as treg
from real_time_fraud_detection_system_tpu_torch.io import sink as tsink
from real_time_fraud_detection_system_tpu_torch.io import store as tstore
from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
    BatchResult,
)
from test_store import FakeS3Client  # pytest adds tests/


@pytest.fixture
def fake(monkeypatch):
    """One fake S3 behind both packages' ``make_store`` for ``s3://``."""
    client = FakeS3Client()
    for mod in (tstore, jstore):
        real = mod.make_store

        def make(url, _mod=mod, _real=real, **kw):
            if url.startswith("s3://"):
                bucket, _, prefix = url[len("s3://"):].partition("/")
                return _mod.S3Store(bucket, prefix=prefix, client=client)
            return _real(url, **kw)

        monkeypatch.setattr(mod, "make_store", make)
    return client


def _result(i, n=6):
    ids = np.arange(n, dtype=np.int64) + i * n
    rng = np.random.default_rng(i)
    return BatchResult(tx_id=ids, tx_datetime_us=ids * 10 ** 6,
                       customer_id=ids % 7, terminal_id=ids % 5,
                       amount_cents=ids * 10 + 1,
                       features=rng.uniform(0, 5, (n, 15)).astype(
                           np.float32),
                       probs=rng.uniform(0, 1, n).astype(np.float32),
                       latency_s=0.0, batch_index=i)


# -- the store ---------------------------------------------------------------


def test_s3_store_operations_equal_jax():
    client = FakeS3Client()
    t = tstore.S3Store("commerce", prefix="/art/", client=client)
    j = jstore.S3Store("commerce", prefix="art", client=client)
    t.put("models/a.npz", b"abc")
    t.put("models/b.npz", b"b")
    t.put("other/c", b"c")
    assert t.get("models/a.npz") == j.get("models/a.npz") == b"abc"
    assert t.list("models/") == j.list("models/") == ["models/a.npz",
                                                      "models/b.npz"]
    assert t.list() == j.list() and len(t.list()) == 3
    assert t.head("models/a.npz") == j.head("models/a.npz")
    assert t.get_with_meta("models/b.npz") == j.get_with_meta("models/b.npz")
    assert t.exists("other/c") and not t.exists("nope")
    t.move("other/c", "moved/c")
    assert j.get("moved/c") == b"c" and not j.exists("other/c")
    t.delete("moved/c")
    for op in (t.get, t.head, t.get_with_meta):
        with pytest.raises(KeyError):
            op("moved/c")
    assert ("commerce", "art/models/a.npz") in client.objects


def test_is_missing_reads_the_client_error_codes():
    class Err(Exception):
        def __init__(self, code):
            self.response = {"Error": {"Code": code}}

    for code in ("404", "NoSuchKey", "NotFound", "AccessDenied"):
        assert tstore._is_missing(Err(code)) == jstore._is_missing(Err(code))
    assert not tstore._is_missing(ValueError("x"))


def test_other_client_errors_propagate():
    class Broken(FakeS3Client):
        def get_object(self, Bucket, Key):
            raise RuntimeError("throttled")

    with pytest.raises(RuntimeError, match="throttled"):
        tstore.S3Store("b", client=Broken()).get("k")


def test_make_store_dispatch(tmp_path, monkeypatch):
    assert isinstance(tstore.make_store(str(tmp_path / "a")),
                      tstore.LocalStore)
    assert isinstance(tstore.make_store(f"file://{tmp_path}/b"),
                      tstore.LocalStore)
    with pytest.raises(ValueError, match="scheme"):
        tstore.make_store("gs://bucket/x")
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="boto3"):
        tstore.make_store("s3://bucket/prefix")


def test_make_store_points_the_client_at_minio(monkeypatch):
    import types

    calls = []
    boto3 = types.SimpleNamespace(
        client=lambda svc, **kw: calls.append((svc, kw)) or FakeS3Client())
    monkeypatch.setitem(sys.modules, "boto3", boto3)
    monkeypatch.setenv("RTFDS_S3_ENDPOINT", "http://minio:9000")
    s = tstore.make_store("s3://commerce/warehouse/analyzed")
    assert (s.bucket, s.prefix) == ("commerce", "warehouse/analyzed")
    tstore.make_store("s3://commerce", endpoint_url="http://other:1")
    assert calls == [("s3", {"endpoint_url": "http://minio:9000"}),
                     ("s3", {"endpoint_url": "http://other:1"})]


# -- sinks -------------------------------------------------------------------


def test_store_parquet_sink_writes_the_jax_parts(fake, tmp_path):
    pytest.importorskip("pyarrow", reason="the parts are Parquet")
    sink = tsink.make_parquet_sink("s3://commerce/analyzed")
    assert isinstance(sink, tsink.StoreParquetSink)
    local = tsink.ParquetSink(str(tmp_path / "local"))
    for i in (1, 2, 3, 2):  # batch 2 replayed: its part is overwritten
        sink.append(_result(i))
        local.append(_result(i))
    assert sorted(k for _, k in fake.objects) == [
        f"analyzed/part-0000000{i}.parquet" for i in (1, 2, 3)]
    got = sink.read_all()
    back = jsink.StoreParquetSink(jstore.S3Store(
        "commerce", prefix="analyzed", client=fake)).read_all()
    want = local.read_all()
    for k in want:
        if k != "processed_at_us":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    sink.truncate_after(1)
    assert sorted(k for _, k in fake.objects) == [
        "analyzed/part-00000001.parquet"]


def test_local_paths_still_make_the_local_sink(tmp_path):
    pytest.importorskip("pyarrow", reason="the parts are Parquet")
    assert isinstance(tsink.make_parquet_sink(str(tmp_path / "o")),
                      tsink.ParquetSink)


class _FakeTable:
    def __init__(self):
        self.appended = []

    def append(self, tbl):
        self.appended.append(tbl)


class _FakeCatalog:
    """Duck-typed catalog: ``table_exists`` false until created."""

    def __init__(self):
        self.tables = {}

    def table_exists(self, name):
        return name in self.tables

    def create_table(self, name, schema):
        self.tables[name] = _FakeTable()
        self.schema = schema
        return self.tables[name]

    def load_table(self, name):
        return self.tables[name]


def test_iceberg_sink_appends_the_jax_rows():
    pytest.importorskip("pyarrow", reason="the sink appends Arrow tables")
    tcat, jcat = _FakeCatalog(), _FakeCatalog()
    t = tsink.IcebergSink(tcat)
    j = jsink.IcebergSink(jcat)
    assert tcat.schema == jcat.schema
    for i in (4, 5):
        t.append(_result(i))
        j.append(_result(i))
    got = tcat.tables[t.TABLE_DEFAULT].appended
    want = jcat.tables[j.TABLE_DEFAULT].appended
    for a, b in zip(got, want):
        assert a.schema == b.schema
        assert a.drop(["processed_at"]).equals(b.drop(["processed_at"]))
    again = tsink.IcebergSink(tcat)  # an existing table is loaded
    assert again.table is tcat.tables[t.TABLE_DEFAULT]


def test_iceberg_sink_factory_names_pyiceberg(monkeypatch):
    monkeypatch.setitem(sys.modules, "pyiceberg", None)
    with pytest.raises(ImportError, match="pyiceberg"):
        tsink.make_iceberg_sink()


def test_iceberg_sink_on_a_real_catalog(tmp_path):
    pytest.importorskip("pyiceberg", reason="a real catalog needs pyiceberg")
    sink = tsink.make_iceberg_sink(
        catalog_name="t", type="sql",
        uri=f"sqlite:///{tmp_path}/cat.db", warehouse=f"file://{tmp_path}")
    sink.append(_result(1))


# -- artifacts ---------------------------------------------------------------


def _sha(jax_model) -> str:
    """The content hash stamped in a JAX model's artifact bytes."""
    import io

    with np.load(io.BytesIO(jart.dump_model_bytes(jax_model))) as z:
        return json.loads(str(z["__meta__"]))["content_sha256"]


def _forest_models():
    from real_time_fraud_detection_system_tpu.models import forest as jforest
    from real_time_fraud_detection_system_tpu.models.scaler import (
        Scaler as JScaler,
    )

    rng = np.random.default_rng(0)
    jm = jart.TrainedModel(
        kind="forest",
        scaler=JScaler(jnp.asarray(rng.normal(size=15).astype(np.float32)),
                       jnp.asarray(rng.uniform(1, 2, 15).astype(
                           np.float32))),
        params=jforest.synthetic_ensemble(5, 4, 15, seed=1))
    return jm, tart.load_model_bytes(jart.dump_model_bytes(jm), device="cpu")


def test_upload_download_cross_the_packages(fake):
    jm, tm = _forest_models()
    store = tstore.make_store("s3://commerce/models")
    jstore_ = jstore.make_store("s3://commerce/models")
    tart.upload_model(store, "port.npz", tm)
    jart.upload_model(jstore_, "jax.npz", jm)
    assert _sha(jart.download_model(jstore_, "port.npz")) == \
        tm.content_sha256
    got = tart.download_model(store, "jax.npz", device="cpu")
    assert got.content_sha256 == tm.content_sha256 and got.kind == "forest"
    assert got.params.feat.device.type == "cpu"
    sentinel = object()
    assert tart.download_model(store, "absent.npz", default=sentinel,
                               device="cpu") is sentinel


def test_corrupt_download_raises_and_counts(fake):
    from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
        get_registry,
    )

    _, tm = _forest_models()
    store = tstore.make_store("s3://commerce/models")
    data = bytearray(tart.dump_model_bytes(tm))
    data[len(data) // 2] ^= 0xFF
    store.put("bad.npz", bytes(data))
    counters = [get_registry().counter(
        "rtfds_model_artifact_corrupt_total",
        "model artifacts that failed load-time verification",
        reason=r) for r in ("checksum", "truncated")]
    before = sum(c.value for c in counters)
    with pytest.raises(tart.CorruptModelError):
        tart.download_model(store, "bad.npz", device="cpu")
    with pytest.raises(tart.CorruptModelError):
        tart.load_model("s3://commerce/models/bad.npz", device="cpu")
    assert sum(c.value for c in counters) == before + 2
    assert ("commerce", "models/bad.npz") in fake.objects  # no quarantine


def test_s3_artifact_urls_cross_the_packages(fake):
    jm, tm = _forest_models()
    tart.save_model("s3://commerce/m/port.npz", tm)
    jart.save_model("s3://commerce/m/jax.npz", jm)
    assert _sha(jart.load_model("s3://commerce/m/port.npz")) == \
        tm.content_sha256
    assert tart.load_model("s3://commerce/m/jax.npz",
                           device="cpu").content_sha256 == tm.content_sha256
    for bad in ("s3://commerce", "s3://commerce/m/"):
        with pytest.raises(ValueError, match="s3://<bucket>/<key>"):
            tart.save_model(bad, tm)


# -- checkpoints -------------------------------------------------------------


def _engines():
    """A JAX and a port forest engine on the same config, params and
    scaler (``tests/test_torch_checkpoint.py``'s), a whole-table stream
    of 1,024 rows in 256-row batches, checkpoints every 2."""
    from test_torch_checkpoint import (
        _configs,
        _jax_params,
        _scaler,
    )

    from real_time_fraud_detection_system_tpu.models.scaler import (
        Scaler as JScaler,
    )
    from real_time_fraud_detection_system_tpu.runtime import (
        ScoringEngine as JScoringEngine,
    )
    from real_time_fraud_detection_system_tpu_torch import weights
    from real_time_fraud_detection_system_tpu_torch.models.scaler import (
        Scaler,
    )
    from real_time_fraud_detection_system_tpu_torch.runtime.engine import (
        ScoringEngine,
    )

    jcfg, tcfg = _configs({})
    mean, scale = _scaler()
    jparams = _jax_params("forest-direct", "forest")
    tparams = weights.from_numpy(jax.tree.map(np.asarray, jparams),
                                 device="cpu")

    def jeng():
        return JScoringEngine(jcfg, kind="forest", params=jparams,
                              scaler=JScaler(jnp.asarray(mean),
                                             jnp.asarray(scale)))

    def teng():
        return ScoringEngine(tcfg, "forest", tparams,
                             Scaler(torch.from_numpy(mean),
                                    torch.from_numpy(scale)), device="cpu")

    return jeng, teng


def test_checkpoints_cross_the_packages_through_s3(fake, small_dataset,
                                                   capsys):
    from test_torch_checkpoint import _assert_state, _port_txs

    from real_time_fraud_detection_system_tpu import cli as jcli
    from real_time_fraud_detection_system_tpu.runtime import (
        ReplaySource as JReplaySource,
    )
    from real_time_fraud_detection_system_tpu_torch import cli as tcli
    from real_time_fraud_detection_system_tpu_torch.runtime.sources import (
        ReplaySource,
    )

    jtxs = small_dataset[3].slice(slice(0, 1024))
    txs = _port_txs(jtxs)
    jeng, teng = _engines()
    start = 1_743_465_600

    j = jeng()
    j.run(JReplaySource(jtxs, start, batch_rows=256),
          checkpointer=jckpt.make_checkpointer("s3://ck/jax"))
    into_port = teng()
    assert tckpt.make_checkpointer("s3://ck/jax").restore(
        into_port.state) is not None
    assert into_port.state.batches_done == 4
    _assert_state(into_port.state.feature_state, jax.tree.map(
        np.asarray, j.state.feature_state))

    t = teng()
    t.run(ReplaySource(txs, start, batch_rows=256),
          checkpointer=tckpt.make_checkpointer("s3://ck/port"))
    into_jax = jeng()
    assert jckpt.make_checkpointer("s3://ck/port").restore(
        into_jax.state) is not None
    assert into_jax.state.batches_done == 4
    _assert_state(t.state.feature_state, jax.tree.map(
        np.asarray, into_jax.state.feature_state))

    # the ckpt command lists and verifies the lineage in the store
    for argv in (["ckpt", "--path", "s3://ck/port", "--verify"],
                 ["ckpt", "--path", "s3://ck/jax"]):
        assert jcli.main(argv) == 0
        want = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        assert tcli.main(argv) == 0
        got = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        for row in got + want:
            row.pop("age_s", None)
        assert got == want and want[0]["checkpoints"] >= 1


# -- the registry ------------------------------------------------------------


def test_registry_over_s3_crosses_the_packages(fake, capsys):
    from real_time_fraud_detection_system_tpu import cli as jcli
    from real_time_fraud_detection_system_tpu_torch import cli as tcli

    jm, tm = _forest_models()
    reg = treg.make_model_registry("s3://commerce/registry")
    v1 = reg.publish(tm, source="test")
    reg.promote(v1, by="test")
    jr = jreg.make_model_registry("s3://commerce/registry")
    assert jr.champion_version() == v1
    assert _sha(jr.get(v1)) == tm.content_sha256
    v2 = jr.publish(jm, parent=v1, source="jax")
    assert reg.get(v2).content_sha256 == tm.content_sha256
    assert [r["version"] for r in reg.list_versions()] == [v1, v2]
    for argv in (["registry", "--path", "s3://commerce/registry",
                  "--verify"],
                 ["registry", "--path", "s3://commerce/registry",
                  "--inspect", str(v2)]):
        assert jcli.main(argv) == 0
        want = capsys.readouterr().out
        assert tcli.main(argv) == 0
        assert capsys.readouterr().out == want
