"""Port parity: the ``.npz`` v1 model artifacts, and ``weights.from_numpy``
for the logreg and gbt records.

An artifact written by the JAX package's ``dump_model_bytes`` loads in the
port with equal arrays and the same ``content_sha256``; one written by the
port loads in the JAX package, whose loader verifies the hash itself.
Arrays are compared bit for bit: both sides store the same bytes.
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.models import forest as jforest
from real_time_fraud_detection_system_tpu.models import gbt as jgbt
from real_time_fraud_detection_system_tpu.models.logreg import (
    LogRegParams as JLogRegParams,
)
from real_time_fraud_detection_system_tpu.models.scaler import (
    Scaler as JScaler,
)
from real_time_fraud_detection_system_tpu.models.train import (
    TrainedModel as JTrainedModel,
)
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.io import artifacts as tart
from real_time_fraud_detection_system_tpu_torch.models import forest as tforest
from real_time_fraud_detection_system_tpu_torch.models import gbt as tgbt
from real_time_fraud_detection_system_tpu_torch.models.logreg import (
    LogRegParams,
)

KINDS = ["logreg", "forest", "gbt"]
TREE_FIELDS = ("feat", "thresh", "left", "right", "prob")


def _jax_model(kind, seed=0):
    rng = np.random.default_rng(seed)
    scaler = JScaler(mean=jnp.asarray(rng.normal(size=15).astype(np.float32)),
                     scale=jnp.asarray(rng.uniform(0.5, 2, 15)
                                       .astype(np.float32)))
    if kind == "logreg":
        params = JLogRegParams(
            w=jnp.asarray(rng.normal(size=15).astype(np.float32)),
            b=jnp.float32(0.25))
    elif kind == "forest":
        params = jforest.synthetic_ensemble(5, 4, 15, seed=seed)
    else:
        params = jgbt.synthetic_gbt(5, 4, 15, seed=seed)
    return JTrainedModel(kind=kind, scaler=scaler, params=params)


def _arrays(kind, params, scaler):
    """Name → numpy array of every stored field (either package)."""
    out = {"scaler_mean": np.asarray(scaler.mean),
           "scaler_scale": np.asarray(scaler.scale)}
    if kind == "logreg":
        out.update(w=np.asarray(params.w), b=np.asarray(params.b))
        return out
    trees = params.trees if kind == "gbt" else params
    out.update({f: np.asarray(getattr(trees, f)) for f in TREE_FIELDS})
    out["max_depth"] = np.asarray(int(trees.max_depth))
    if kind == "gbt":
        out["base_score"] = np.asarray(params.base_score)
    return out


def _meta(data: bytes) -> dict:
    import io
    import json

    with np.load(io.BytesIO(data), allow_pickle=False) as z:
        return json.loads(str(z["__meta__"]))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_artifact_loads_in_port(kind):
    jmodel = _jax_model(kind)
    data = jart.dump_model_bytes(jmodel)
    model = tart.load_model_bytes(data, device="cpu")
    assert model.kind == kind
    assert model.content_sha256 == _meta(data)["content_sha256"]
    want = _arrays(kind, jmodel.params, jmodel.scaler)
    got = _arrays(kind, model.params, model.scaler)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_port_artifact_loads_in_jax(kind):
    jmodel = _jax_model(kind, seed=1)
    model = tart.load_model_bytes(jart.dump_model_bytes(jmodel),
                                  device="cpu")
    data = tart.dump_model_bytes(model)
    # same content, same hash as the JAX package's own writer
    assert _meta(data)["content_sha256"] == model.content_sha256
    back = jart.load_model_bytes(data)  # verifies the hash itself
    assert back.kind == kind
    want = _arrays(kind, jmodel.params, jmodel.scaler)
    got = _arrays(kind, back.params, back.scaler)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_flipped_byte_raises_checksum():
    model = tart.load_model_bytes(
        jart.dump_model_bytes(_jax_model("logreg")), device="cpu")
    data = bytearray(tart.dump_model_bytes(model))
    at = bytes(data).find(model.params.w.numpy().tobytes())
    assert at > 0
    data[at + 3] ^= 0x40
    with pytest.raises(tart.CorruptModelError) as ei:
        tart.load_model_bytes(bytes(data), device="cpu")
    assert ei.value.reason == "checksum"


def test_truncated_artifact_raises_truncated():
    data = jart.dump_model_bytes(_jax_model("gbt"))
    for cut in (48, len(data) // 2, len(data) - 7):
        with pytest.raises(tart.CorruptModelError) as ei:
            tart.load_model_bytes(data[:cut], device="cpu")
        assert ei.value.reason == "truncated", cut


def test_load_model_from_a_path_quarantines_a_corrupt_file(tmp_path):
    path = tmp_path / "model.npz"
    jmodel = _jax_model("forest")
    data = jart.dump_model_bytes(jmodel)
    path.write_bytes(data)
    assert tart.load_model(str(path), device="cpu").kind == "forest"
    flipped = bytearray(data)
    at = bytes(data).find(np.asarray(jmodel.params.thresh).tobytes())
    assert at > 0
    flipped[at + 5] ^= 0x01
    path.write_bytes(bytes(flipped))
    with pytest.raises(tart.CorruptModelError) as ei:
        tart.load_model(str(path), device="cpu")
    assert ei.value.reason == "checksum"
    names = [p.name for p in tmp_path.iterdir()]
    assert "model.npz" not in names
    assert any(n.startswith("stale-") for n in names)


def test_unhashed_v0_artifact_loads():
    import io

    jmodel = _jax_model("logreg")
    buf = io.BytesIO()
    np.savez(buf, __meta__='{"kind": "logreg"}',
             scaler_mean=np.asarray(jmodel.scaler.mean),
             scaler_scale=np.asarray(jmodel.scaler.scale),
             w=np.asarray(jmodel.params.w), b=np.asarray(jmodel.params.b))
    model = tart.load_model_bytes(buf.getvalue(), device="cpu")
    assert model.content_sha256 is None
    np.testing.assert_array_equal(model.params.w.numpy(),
                                  np.asarray(jmodel.params.w))


def test_unported_kinds_raise_naming_their_roadmap_item(monkeypatch):
    """Every kind of the zoo loads now (the mlp below; all of them in
    ``tests/test_torch_zoo.py`` and ``test_torch_sequence.py``); an
    unknown kind raises, and an object-store URL without boto3 raises
    naming it (``tests/test_torch_store.py`` serves ``s3://`` on a fake
    client)."""
    rng = np.random.default_rng(0)
    mlp = JTrainedModel(
        kind="mlp", scaler=_jax_model("logreg").scaler,
        params=[(jnp.asarray(rng.normal(size=(15, 4)).astype(np.float32)),
                 jnp.zeros(4, jnp.float32))])
    got = tart.load_model_bytes(jart.dump_model_bytes(mlp), device="cpu")
    assert got.kind == "mlp" and got.params[0][0].shape == (15, 4)
    with pytest.raises(ValueError, match="unknown model kind"):
        tart.dump_model_bytes(tart.TrainedModel(
            kind="lstm", scaler=None, params=None))
    monkeypatch.setitem(sys.modules, "boto3", None)
    with pytest.raises(ImportError, match="boto3"):
        tart.load_model("s3://bucket/model.npz", device="cpu")


def test_load_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the refusal needs a host without")
    with pytest.raises(RuntimeError, match="CUDA"):
        tart.load_model_bytes(jart.dump_model_bytes(_jax_model("logreg")))


def test_from_numpy_carries_logreg_params():
    jmodel = _jax_model("logreg", seed=4)
    got = weights.from_numpy(jax.tree.map(np.asarray, jmodel.params),
                             device="cpu")
    assert isinstance(got, LogRegParams)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(jmodel.params.w))
    assert got.b.shape == () and float(got.b) == 0.25


@pytest.mark.parametrize("form", ["nodes", "gemm"])
def test_from_numpy_carries_gbt_models(form):
    model = jgbt.synthetic_gbt(4, 3, 15, seed=6)
    if form == "gemm":
        model = jgbt.gbt_for_device(model, 15)
    got = weights.from_numpy(jax.tree.map(np.asarray, model), device="cpu")
    assert isinstance(got, tgbt.GBTModel)
    want_cls = tforest.GemmEnsemble if form == "gemm" else \
        tforest.TreeEnsemble
    assert isinstance(got.trees, want_cls)
    assert float(got.base_score) == -2.0
    x = np.random.default_rng(1).normal(size=(50, 15)).astype(np.float32)
    np.testing.assert_allclose(
        tgbt.gbt_predict_proba(got, torch.as_tensor(x), "f32").numpy(),
        np.asarray(jgbt.gbt_predict_proba(model, jnp.asarray(x), "f32")),
        rtol=1e-5, atol=1e-6)  # leaf sums over trees in another order


def test_synthetic_gbt_matches_jax():
    want = jax.tree.map(np.asarray, jgbt.synthetic_gbt(6, 4, 15, seed=9))
    got = tgbt.synthetic_gbt(6, 4, 15, seed=9, device="cpu")
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(got.trees, name).numpy(),
                                      getattr(want.trees, name))
    assert float(got.base_score) == float(want.base_score) == -2.0
