"""Port parity: the versioned model registry (``io/registry.py``).

The cases of ``tests/test_registry.py`` on the port's registry (versions,
manifests, the champion pointer, corruption and quarantine, the store
plane, torn manifests and pointers), and a registry directory written by
each package opened and served by the other: the same versions,
manifests, champion and history, and each artifact's params and scaler
bit for bit.
"""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.io.registry import (
    make_model_registry as jmake_model_registry,
)
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models.logreg import init_logreg
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.io.artifacts import (
    CorruptModelError,
    TrainedModel,
)
from real_time_fraud_detection_system_tpu_torch.io.checkpoint import (
    _StoreBackend,
)
from real_time_fraud_detection_system_tpu_torch.io.registry import (
    ModelRegistry,
    make_model_registry,
)
from real_time_fraud_detection_system_tpu_torch.io.store import LocalStore
from real_time_fraud_detection_system_tpu_torch.models.forest import (
    synthetic_ensemble,
)
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)
from real_time_fraud_detection_system_tpu_torch.models.scaler import Scaler
from real_time_fraud_detection_system_tpu_torch.runtime.faults import (
    FlakyStore,
    TornStore,
)
from real_time_fraud_detection_system_tpu_torch.utils.metrics import (
    get_registry,
)


def _model(seed: int = 0, kind: str = "logreg") -> TrainedModel:
    rng = np.random.default_rng(seed)
    return TrainedModel(
        kind=kind,
        scaler=Scaler(torch.zeros(15), torch.ones(15)),
        params=LogRegParams(
            torch.tensor(rng.normal(0, 0.01, 15).astype(np.float32)),
            torch.tensor(0.0)))


def _counter(name: str, **labels) -> float:
    m = get_registry().get(name, **labels)
    return float(m.value) if m is not None else 0.0


def _flip(path, at=None) -> None:
    data = bytearray(path.read_bytes())
    data[len(data) // 2 if at is None else at] ^= 0xFF
    path.write_bytes(bytes(data))


# -- publish and get ------------------------------------------------------

def test_versions_monotonic_and_lineage(tmp_path):
    reg = make_model_registry(str(tmp_path))
    assert reg.versions() == []
    v1 = reg.publish(_model(0), source="bootstrap")
    v2 = reg.publish(_model(1), parent=v1, source="learner",
                     labels_trained=128, note="warm start")
    assert (v1, v2) == (1, 2) and reg.versions() == [1, 2]
    man = reg.meta(2)
    assert (man["parent"], man["source"], man["labels_trained"],
            man["kind"], man["note"]) == (1, "learner", 128, "logreg",
                                          "warm start")
    names = sorted(os.listdir(tmp_path))
    assert "model-v0000001.npz" in names and "model-v0000002.npz" in names


def test_get_roundtrip_lands_on_the_host(tmp_path):
    reg = make_model_registry(str(tmp_path))
    m = _model(3)
    got = reg.get(reg.publish(m))
    assert got.kind == "logreg"
    assert got.params.w.device.type == "cpu"
    assert torch.equal(got.params.w, m.params.w)
    with pytest.raises(KeyError):
        reg.get(7)


def test_concurrent_process_publish_never_overwrites(tmp_path):
    serve, cli = (make_model_registry(str(tmp_path)) for _ in range(2))
    v1 = serve.publish(_model(0), source="bootstrap")
    v2 = cli.publish(_model(1), source="cli")
    v3 = serve.publish(_model(2), source="learner")
    assert (v1, v2, v3) == (1, 2, 3)
    for v, seed in ((1, 0), (2, 1), (3, 2)):
        assert torch.equal(serve.get(v).params.w, _model(seed).params.w)


def test_orphan_npz_version_never_reused(tmp_path):
    reg = make_model_registry(str(tmp_path))
    reg.publish(_model(0))
    (tmp_path / "model-v0000002.npz").write_bytes(b"orphan bytes")
    assert reg.publish(_model(1)) == 3
    assert torch.equal(reg.get(3).params.w, _model(1).params.w)


def test_version_gauges(tmp_path):
    reg = make_model_registry(str(tmp_path))
    v = reg.publish(_model())
    reg.promote(v)
    assert _counter("rtfds_model_version", role="candidate") >= v
    assert _counter("rtfds_model_version", role="champion") >= v


# -- the champion pointer -------------------------------------------------

def test_promote_and_rollback(tmp_path):
    reg = make_model_registry(str(tmp_path))
    v1 = reg.publish(_model(0))
    v2 = reg.publish(_model(1), parent=v1)
    assert reg.champion_version() is None
    assert reg.rollback() is None
    reg.promote(v1, by="bootstrap")
    assert reg.rollback() is None  # a champion, nothing to pop to
    ptr = reg.promote(v2)
    assert ptr["version"] == 2 and ptr["history"] == [1]
    assert reg.rollback() == 1 and reg.champion_version() == 1
    assert reg.versions() == [1, 2]
    with pytest.raises(KeyError):
        reg.promote(9)
    again = make_model_registry(str(tmp_path))
    assert again.champion_version() == 1
    assert again.champion().kind == "logreg"


# -- corruption -----------------------------------------------------------

def test_bit_flip_quarantines_and_raises(tmp_path):
    reg = make_model_registry(str(tmp_path))
    v = reg.publish(_model())
    _flip(tmp_path / "model-v0000001.npz")
    before = _counter("rtfds_model_artifact_corrupt_total", reason="checksum")
    with pytest.raises(CorruptModelError):
        reg.get(v)
    assert _counter("rtfds_model_artifact_corrupt_total",
                    reason="checksum") == before + 1
    assert reg.versions() == []
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith("stale-")]) == 2


@pytest.mark.parametrize("damage", ["truncated", "missing", "size"])
def test_truncations_are_truncated(tmp_path, damage):
    reg = make_model_registry(str(tmp_path))
    v = reg.publish(_model())
    path = tmp_path / "model-v0000001.npz"
    if damage == "truncated":
        path.write_bytes(path.read_bytes()[:48])
    elif damage == "missing":
        os.remove(path)
    else:
        man_path = tmp_path / "model-v0000001.json"
        man = json.loads(man_path.read_text())
        man["size"] -= 1
        man_path.write_text(json.dumps(man))
    before = _counter("rtfds_model_artifact_corrupt_total",
                      reason="truncated")
    with pytest.raises(CorruptModelError) as ei:
        reg.get(v)
    assert ei.value.reason == "truncated"
    assert _counter("rtfds_model_artifact_corrupt_total",
                    reason="truncated") == before + 1


def test_verify_all_reports_without_quarantining(tmp_path):
    reg = make_model_registry(str(tmp_path))
    reg.publish(_model(0))
    reg.publish(_model(1))
    reg.publish(_model(2))
    reg.promote(2)
    _flip(tmp_path / "model-v0000001.npz", at=-20)
    (tmp_path / "model-v0000003.json").write_bytes(b"\xff\xfe not json")
    by_v = {e["version"]: e for e in reg.verify_all()}
    assert not by_v[1]["valid"]
    assert by_v[2]["valid"] and by_v[2]["role"] == "champion"
    assert not by_v[3]["valid"] and by_v[3]["reason"] == "truncated"
    assert reg.versions() == [1, 2, 3]
    assert [r["role"] for r in reg.list_versions()] == \
        ["candidate", "champion", "candidate"]


def test_torn_manifest_is_corrupt_not_valueerror(tmp_path):
    reg = make_model_registry(str(tmp_path))
    v = reg.publish(_model())
    (tmp_path / "model-v0000001.json").write_text('{"version": 1, "sh')
    with pytest.raises(CorruptModelError) as ei:
        reg.get(v)
    assert ei.value.reason == "truncated"
    assert reg.versions() == []
    assert len([n for n in os.listdir(tmp_path)
                if n.startswith("stale-")]) == 2


@pytest.mark.parametrize("pointer", [b'{"version": 2, "hist', b"[1, 2, 3]"])
def test_torn_pointer_quarantined_not_silent_absence(tmp_path, pointer):
    reg = make_model_registry(str(tmp_path))
    v1 = reg.publish(_model(0), source="bootstrap")
    reg.promote(v1, by="bootstrap")
    v2 = reg.publish(_model(1), parent=v1)
    reg.promote(v2)
    (tmp_path / "champion.json").write_bytes(pointer)
    before = _counter("rtfds_model_artifact_corrupt_total",
                      reason="truncated")
    assert reg.champion_version() is None
    assert _counter("rtfds_model_artifact_corrupt_total",
                    reason="truncated") == before + 1
    assert len([n for n in os.listdir(tmp_path) if n.startswith("stale-")
                and n.endswith("champion.json")]) == 1
    reg.promote(v2)  # self-heals
    assert reg.champion_version() == 2


# -- the store plane ------------------------------------------------------

def _store_registry(store) -> ModelRegistry:
    return ModelRegistry(_StoreBackend(store, prefix="", op_attempts=3))


def test_store_roundtrip_retries_and_torn_puts(tmp_path):
    reg = _store_registry(LocalStore(str(tmp_path / "a")))
    v = reg.publish(_model(2))
    reg.promote(v)
    assert reg.get(v).kind == "logreg" and reg.champion_version() == v
    flaky = _store_registry(FlakyStore(LocalStore(str(tmp_path / "b")),
                                       fail_puts=[0]))
    assert flaky.get(flaky.publish(_model())).kind == "logreg"
    torn = _store_registry(TornStore(LocalStore(str(tmp_path / "c")),
                                     tear_at=0, keep_bytes=128))
    tv = torn.publish(_model())
    with pytest.raises(CorruptModelError):
        torn.get(tv)
    assert _store_registry(LocalStore(str(tmp_path / "c"))).versions() == []
    assert make_model_registry(
        f"file://{tmp_path / 'a'}").champion_version() == v


def test_s3_names_its_roadmap_item(tmp_path, monkeypatch):
    """``s3://`` is served (``tests/test_torch_store.py``, on a fake
    client); without boto3 it raises naming the package."""
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="boto3"):
        make_model_registry("s3://bucket/prefix")


# -- across the packages --------------------------------------------------

def _jax_models():
    jsc = JScaler(mean=jnp.arange(15, dtype=jnp.float32),
                  scale=jnp.full(15, 2.0, jnp.float32))
    return [JTrainedModel(kind="logreg", scaler=jsc,
                          params=init_logreg(15, seed=s)) for s in (0, 1)] + [
        JTrainedModel(kind="forest", scaler=jsc,
                      params=jforest.synthetic_ensemble(4, 3, 15, seed=2))]


def _port_models():
    sc = Scaler(torch.arange(15, dtype=torch.float32),
                torch.full((15,), 2.0))
    return [_model(0), _model(1), TrainedModel(
        kind="forest", scaler=sc,
        params=synthetic_ensemble(4, 3, 15, seed=2, device="cpu"))]


def _np_leaves(m) -> list:
    p = m.params
    leaves = [m.scaler.mean, m.scaler.scale]
    if m.kind == "logreg":
        leaves += [p.w, p.b]
    else:
        leaves += [p.feat, p.thresh, p.left, p.right, p.prob]
    return [np.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)
            for t in leaves]


def _write(reg, models):
    v1 = reg.publish(models[0], source="bootstrap")
    reg.promote(v1, by="bootstrap")
    v2 = reg.publish(models[1], parent=v1, source="learner",
                     labels_trained=64)
    reg.promote(v2)
    reg.publish(models[2], parent=v2, source="cli", note="offline")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_registry_opens_in_the_other_package(tmp_path, writer):
    d = str(tmp_path / "reg")
    if writer == "jax":
        _write(jmake_model_registry(d), _jax_models())
        reader, other = make_model_registry(d), jmake_model_registry(d)
    else:
        _write(make_model_registry(d), _port_models())
        reader, other = jmake_model_registry(d), make_model_registry(d)
    assert reader.versions() == other.versions() == [1, 2, 3]
    assert reader.champion_version() == 2
    for v in (1, 2, 3):
        assert reader.meta(v) == other.meta(v)
        got, want = reader.get(v), other.get(v)
        assert got.kind == want.kind
        for a, b in zip(_np_leaves(got), _np_leaves(want)):
            np.testing.assert_array_equal(a, b)
    assert all(e["valid"] for e in reader.verify_all())
    # the reader moves the pointer; the writer sees the move
    assert reader.rollback() == 1
    assert other.champion_version() == 1
