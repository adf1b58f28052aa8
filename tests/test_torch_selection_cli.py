"""Port parity: model selection, the ``train``/``compare``/``select``
commands, trained artifacts across the two packages, and the plots.

The trainers start from the JAX package's initial parameters (the port's
``init_*`` monkeypatched inside the test to return them, carried by
``weights.from_numpy``), so both packages fit the same models on the same
seeded table.

Tolerances, and why they hold:

- selection means and stds within 1e-6 and the same best parameters: the
  fitted parameters differ by Adam's rounding (``tests/test_torch_train.py``:
  ``atol=1e-5``), which moves a ranking metric by far less;
- the commands' metrics within 1e-4 of the JAX commands' (both print them
  rounded to 4 decimals, so equal metrics may print one unit of the last
  decimal apart);
- artifacts: the same ``content_sha256`` and bit-identical arrays in both
  directions (the same bytes in one format).
"""

import dataclasses
import importlib.util
import json

import jax
import numpy as np
import pytest

from real_time_fraud_detection_system_tpu.cli import main as jcli_main
from real_time_fraud_detection_system_tpu.config import Config as JConfig
from real_time_fraud_detection_system_tpu.config import (
    DataConfig as JDataConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    FeatureConfig as JFeatureConfig,
)
from real_time_fraud_detection_system_tpu.config import (
    TrainConfig as JTrainConfig,
)
from real_time_fraud_detection_system_tpu.data.generator import (
    Transactions as JTransactions,
)
from real_time_fraud_detection_system_tpu.features import offline as joff
from real_time_fraud_detection_system_tpu.io import artifacts as jart
from real_time_fraud_detection_system_tpu.models import autoencoder as jae
from real_time_fraud_detection_system_tpu.models import logreg as jlogreg
from real_time_fraud_detection_system_tpu.models import mlp as jmlp
from real_time_fraud_detection_system_tpu.models import selection as jsel
from real_time_fraud_detection_system_tpu.models import sequence as jseq
from real_time_fraud_detection_system_tpu_torch import cli as tcli
from real_time_fraud_detection_system_tpu_torch import weights
from real_time_fraud_detection_system_tpu_torch.config import (
    Config,
    DataConfig,
    FeatureConfig,
    ModelConfig,
    TrainConfig,
)
from real_time_fraud_detection_system_tpu_torch.data import generate_dataset
from real_time_fraud_detection_system_tpu_torch.features import offline as toff
from real_time_fraud_detection_system_tpu_torch.io import artifacts as tart
from real_time_fraud_detection_system_tpu_torch.models import autoencoder as tae
from real_time_fraud_detection_system_tpu_torch.models import logreg as tlogreg
from real_time_fraud_detection_system_tpu_torch.models import mlp as tmlp
from real_time_fraud_detection_system_tpu_torch.models import selection as tsel
from real_time_fraud_detection_system_tpu_torch.models import sequence as tseq
from real_time_fraud_detection_system_tpu_torch.models.train import (
    train_model,
)
from real_time_fraud_detection_system_tpu_torch.utils import tree

TOL_SELECTION = 1e-6
TOL_CLI = 1e-4 + 1e-12  # four printed decimals
DATA = dict(n_customers=100, n_terminals=200, n_days=60)
FEATURES = dict(customer_capacity=128, terminal_capacity=256)
SPLIT = ["--delta-train", "30", "--delta-delay", "7", "--delta-test", "15"]

_TX_FIELDS = ("tx_id", "tx_time_seconds", "tx_time_days", "customer_id",
              "terminal_id", "amount_cents", "tx_fraud", "tx_fraud_scenario")


def jtxs_of(txs) -> JTransactions:
    return JTransactions(*[getattr(txs, f) for f in _TX_FIELDS])


def to_np(obj):
    return jax.tree.map(np.asarray, obj)


@pytest.fixture(scope="module")
def txs():
    _, _, t = generate_dataset(DataConfig(**DATA))
    return t


@pytest.fixture(scope="module")
def data_file(txs, tmp_path_factory):
    path = tmp_path_factory.mktemp("data") / "txs.npz"
    tart.save_transactions(str(path), txs)
    return str(path)


@pytest.fixture
def carried_inits(monkeypatch):
    """The port's inits return the JAX package's initial parameters."""
    monkeypatch.setattr(tlogreg, "init_logreg", lambda f, seed=0, device=None:
                        weights.from_numpy(to_np(jlogreg.init_logreg(f, seed)),
                                           device))
    monkeypatch.setattr(tmlp, "init_mlp", lambda f, hidden=(64, 32), seed=0,
                        device=None: weights.from_numpy(
                            to_np(jmlp.init_mlp(f, hidden, seed)), device))
    monkeypatch.setattr(
        tae, "init_autoencoder", lambda f, hidden=(32, 8), seed=0, device=None:
        weights.from_numpy(to_np(jae.init_autoencoder(f, hidden, seed)),
                           device))

    def init_transformer(d_model=32, n_heads=2, n_layers=2, d_ff=64,
                         n_in=tseq.N_EVENT_FEATURES, seed=0, device=None):
        return weights.from_numpy(to_np(jseq.init_transformer(
            d_model, n_heads, n_layers, d_ff, n_in=n_in, seed=seed)), device)

    monkeypatch.setattr(tseq, "init_transformer", init_transformer)


def last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def assert_close_json(got, want, tol, path=""):
    """Same keys and shapes; numbers within ``tol`` (timings skipped)."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            if k in ("fit_seconds", "predict_seconds", "execution_times"):
                continue
            assert_close_json(got[k], want[k], tol, f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close_json(g, w, tol, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= tol, (path, got, want)
    else:
        assert got == want, (path, got, want)


# ---------------------------------------------------------------- selection


def test_grid_expansion_and_overrides_equal_jax():
    grid = {"learning_rate": [0.1, 0.01], "tree_max_depth": [2, 4, 8]}
    assert tsel.expand_param_grid(grid) == jsel.expand_param_grid(grid)
    assert tsel.expand_param_grid({}) == [{}]
    cfg = tsel._apply_params(Config(), {"epochs": 3, "forest_n_trees": 7})
    jcfg = jsel._apply_params(JConfig(), {"epochs": 3, "forest_n_trees": 7})
    assert dataclasses.asdict(cfg.model) == dataclasses.asdict(jcfg.model)
    assert dataclasses.asdict(cfg.train) == dataclasses.asdict(jcfg.train)
    with pytest.raises(ValueError, match="unknown hyper-parameters"):
        tsel._apply_params(Config(), {"bogus": 1})


@pytest.fixture(scope="module")
def whole_features(txs):
    """The whole-dollar copy and its replayed features (bit-identical in
    both packages there)."""
    whole = txs.slice(slice(None))
    whole.amount_cents = np.round(txs.amount_cents / 100).astype(
        np.int64) * 100
    feats = toff.compute_features_replay(whole, FeatureConfig(**FEATURES),
                                         device="cpu")
    jfeats = joff.compute_features_replay(jtxs_of(whole),
                                          JFeatureConfig(**FEATURES))
    assert feats.tobytes() == np.asarray(jfeats).tobytes()
    return whole, feats


@pytest.mark.parametrize("kind,grid", [
    ("logreg", {"learning_rate": [0.01, 0.001]}),
    ("gbt", {"forest_max_depth": [2, 4], "forest_n_trees": [3]}),
])
def test_model_selection_equals_jax_from_a_carried_init(whole_features,
                                                        carried_inits, kind,
                                                        grid):
    whole, feats = whole_features
    train = dict(delta_train_days=20, delta_delay_days=5, delta_test_days=10,
                 epochs=1, batch_size=512)
    cfg = Config(data=DataConfig(**DATA), train=TrainConfig(**train))
    jcfg = JConfig(data=JDataConfig(**DATA), train=JTrainConfig(**train))
    rows = tsel.model_selection_wrapper(whole, feats, cfg, kind, grid, 10, 20,
                                        n_folds=2, device="cpu")
    jrows = jsel.model_selection_wrapper(jtxs_of(whole), feats, jcfg, kind,
                                         grid, 10, 20, n_folds=2)
    assert [(r.params, r.fold, r.expe_type, r.n_train, r.n_test)
            for r in rows] == [(r.params, r.fold, r.expe_type, r.n_train,
                                r.n_test) for r in jrows]
    got, want = tsel.summarize_performances(rows), \
        jsel.summarize_performances(jrows)
    assert got.keys() == want.keys()
    for m in want:
        assert got[m].best_params == want[m].best_params
        for f in ("validation_mean", "validation_std", "test_mean",
                  "test_std"):
            a, b = getattr(got[m], f), getattr(want[m], f)
            assert abs(a - b) <= TOL_SELECTION or (np.isnan(a)
                                                   and np.isnan(b)), (m, f)
    assert tsel.execution_times(rows).keys() == \
        jsel.execution_times(jrows).keys()


def test_kfold_cv_equals_jax_from_a_carried_init(whole_features,
                                                 carried_inits):
    whole, feats = whole_features
    cfg = Config(train=TrainConfig(epochs=1, batch_size=512))
    jcfg = JConfig(train=JTrainConfig(epochs=1, batch_size=512))
    got = tsel.kfold_cv_with_classifier(feats, whole.tx_fraud, cfg, "logreg",
                                        n_folds=3, device="cpu")
    want = jsel.kfold_cv_with_classifier(feats, whole.tx_fraud, jcfg,
                                         "logreg", n_folds=3)
    assert got.keys() == want.keys()
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_SELECTION, k
    with pytest.raises(ValueError, match="labels must be 0/1"):
        tsel.kfold_cv_with_classifier(feats, np.full(whole.n, 2), cfg,
                                      "logreg", device="cpu")


# ---------------------------------------------------------------- commands


@pytest.mark.parametrize("kind", ["logreg", "mlp", "autoencoder",
                                  "sequence"])
def test_train_command_prints_the_jax_json(data_file, tmp_path, capsys,
                                           carried_inits, kind):
    argv = ["train", "--data", data_file, "--model", kind, *SPLIT,
            "--epochs", "2"]
    assert jcli_main([*argv, "--out-model", str(tmp_path / "j.npz")]) == 0
    want = last_json(capsys)
    assert tcli.main([*argv, "--device", "cpu", "--out-model",
                      str(tmp_path / "t.npz")]) == 0
    got = last_json(capsys)
    assert_close_json(got, want, TOL_CLI)
    assert got["model"] == kind and "auc_roc" in got
    t = tart.load_model(str(tmp_path / "t.npz"), device="cpu")
    assert t.kind == kind and t.content_sha256 is not None


def test_train_command_gbt_equals_the_jax_trainer(data_file, tmp_path,
                                                  capsys, monkeypatch):
    """The booster's default 100 trees of depth 8 are cut to 3 of depth 3
    in both packages (the commands have no tree flags): the port's command
    against the JAX trainer on the same config."""
    from real_time_fraud_detection_system_tpu.models.train import (
        train_model as jtrain_model,
    )

    make = tcli._offline_config
    monkeypatch.setattr(tcli, "_offline_config", lambda args: make(
        args).replace(model=ModelConfig(forest_n_trees=3,
                                        forest_max_depth=3)))
    assert tcli.main(["train", "--data", data_file, "--model", "gbt", *SPLIT,
                      "--device", "cpu", "--out-model",
                      str(tmp_path / "t.npz")]) == 0
    got = last_json(capsys)
    jcfg = JConfig(train=JTrainConfig(delta_train_days=30, delta_delay_days=7,
                                      delta_test_days=15))
    jcfg = jcfg.replace(model=dataclasses.replace(
        jcfg.model, forest_n_trees=3, forest_max_depth=3))
    _, want = jtrain_model(jtxs_of(tart.load_transactions(data_file)), jcfg,
                           kind="gbt")
    assert got.keys() == {"model", *want}
    for k in want:
        assert abs(got[k] - want[k]) <= TOL_SELECTION, k


def test_compare_command_prints_the_jax_json(data_file, capsys,
                                             carried_inits):
    argv = ["compare", "--data", data_file, "--models", "logreg", "mlp",
            "autoencoder", "sequence", *SPLIT, "--epochs", "1"]
    assert jcli_main(argv) == 0
    want = last_json(capsys)
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    got = last_json(capsys)
    assert_close_json(got, want, TOL_CLI)
    assert [r["model"] for r in got["models"]] == ["logreg", "mlp",
                                                   "autoencoder", "sequence"]
    assert all(r["fit_seconds"] >= 0 for r in got["models"])


def test_select_command_prints_the_jax_json(data_file, capsys,
                                            carried_inits):
    argv = ["select", "--data", data_file, "--model", "logreg", "--grid",
            "learning_rate=0.01,0.001", "--folds", "2", "--epochs", "1",
            "--start-valid", "5", "--start-test", "15"]
    assert jcli_main(argv) == 0
    want = last_json(capsys)
    assert tcli.main([*argv, "--device", "cpu"]) == 0
    got = last_json(capsys)
    assert_close_json(got, want, TOL_CLI)
    assert got["execution_times"].keys() == want["execution_times"].keys()


def _hide(monkeypatch, package: str) -> None:
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == package
                        else real(name, *a))


@pytest.mark.parametrize("argv,package", [
    (["train", "--model", "forest", "--out-model", "m.npz"], "sklearn"),
    (["train", "--model", "tree", "--out-model", "m.npz"], "sklearn"),
    (["compare", "--models", "logreg", "tree"], "sklearn"),
    (["compare", "--models", "logreg", "--plots-dir", "plots"],
     "matplotlib"),
    (["select", "--model", "forest", "--grid", "forest_max_depth=2,4",
      "--start-valid", "0", "--start-test", "10"], "sklearn"),
])
def test_missing_packages_exit_2_naming_them(data_file, monkeypatch, caplog,
                                             tmp_path, argv, package):
    _hide(monkeypatch, package)
    monkeypatch.chdir(tmp_path)
    assert tcli.main([argv[0], "--data", data_file, "--device", "cpu",
                      *argv[1:]]) == 2
    assert package in caplog.text
    assert not (tmp_path / "m.npz").exists()


@pytest.mark.parametrize("grid,message", [
    ("bogus=1,2", "not a ModelConfig/TrainConfig field"),
    ("learning_rate", "expects field=v1,v2"),
])
def test_select_refuses_a_bad_grid_before_loading_data(caplog, grid,
                                                       message):
    assert tcli.main(["select", "--data", "/nonexistent.npz", "--device",
                      "cpu", "--model", "logreg", "--grid", grid,
                      "--start-valid", "0", "--start-test", "10"]) == 2
    assert message in caplog.text


# ---------------------------------------------------------------- artifacts


@pytest.mark.parametrize("kind", ["logreg", "gbt", "mlp"])
def test_trained_artifacts_load_in_both_packages(txs, tmp_path, kind):
    cfg = Config(data=DataConfig(**DATA), features=FeatureConfig(**FEATURES),
                 model=ModelConfig(forest_n_trees=3, forest_max_depth=3,
                                   mlp_hidden=(8,)),
                 train=TrainConfig(delta_train_days=30, delta_delay_days=7,
                                   delta_test_days=15, epochs=1))
    model, _ = train_model(txs, cfg, kind=kind, device="cpu")
    tart.save_model(str(tmp_path / "t.npz"), model)
    j = jart.load_model(str(tmp_path / "t.npz"))  # verifies the hash
    t = tart.load_model(str(tmp_path / "t.npz"), device="cpu")
    for a, b in zip(tree.leaves(t.params), jax.tree.leaves(j.params)):
        if hasattr(a, "numpy"):
            assert a.numpy().tobytes() == np.asarray(b).tobytes()
    # and back: the JAX writer's bytes load in the port with the same hash
    jart.save_model(str(tmp_path / "j.npz"), j)
    back = tart.load_model(str(tmp_path / "j.npz"), device="cpu")
    assert back.content_sha256 == t.content_sha256 is not None
    rows = np.random.default_rng(0).normal(size=(64, 15)).astype(np.float32)
    np.testing.assert_array_equal(back.predict_proba(rows),
                                  t.predict_proba(rows))


def test_save_plots_writes_a_png(tmp_path):
    pytest.importorskip("matplotlib", reason="the plots need matplotlib")
    from real_time_fraud_detection_system_tpu_torch.models import plots

    rng = np.random.default_rng(0)
    y = (rng.random(500) < 0.1).astype(np.int8)
    s = np.clip(y * 0.3 + rng.random(500) * 0.7, 0, 1)
    out = plots.save_plots(str(tmp_path / "r.png"), y, s, label="logreg")
    data = open(out, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n" and len(data) > 1000
