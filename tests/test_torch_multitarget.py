"""``train`` and ``crossval`` of the other backbones through both CLIs on the
CPU (``accelerator: cpu``, ``seed: 0``), the port starting from the JAX
package's initial variables as ``tests/test_torch_train.py`` does for the
ViT:

* multi-target ``crossval`` (two targets of 2 and 3 classes, one target
  missing for a patient): the same folds (``KFold``, as the JAX package
  takes for multi-target), and from the same ``barspoon`` checkpoint in
  each fold (written by the JAX package; both CLIs then only export the
  held-out predictions) the same ``patient-preds.csv`` columns, patients
  and predicted classes, probabilities within 1e-5;
* ``train`` of ``mlp`` (dropout 0) on slide-level and of ``linear`` on
  patient-level features: the same split and ``metrics.csv`` within 1e-4
  (relative), and the final parameters within 1e-4.
"""

import random
import shutil
import sys

import h5py
import jax
import numpy as np
import pandas as pd
import pytest
import yaml

from random_data import (
    create_random_multi_target_dataset,
    create_random_patient_level_dataset,
    create_random_patient_level_feature_file,
)
from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.modeling import train
from stamp_tpu_torch.models import weights
from test_torch_deploy import stamp_logger_handlers  # noqa: F401 (fixture)

FEAT_DIM = 16
_TARGETS = {"KRAS status": ["mut", "wt"], "grade": ["g1", "g2", "g3"]}
_MODEL_PARAMS = {
    "mlp": {"dim_hidden": 24, "num_layers": 2, "dropout": 0.0},
    "barspoon": {"d_model": 32, "num_encoder_heads": 4, "num_decoder_heads": 4, "num_encoder_layers": 1,
                 "num_decoder_layers": 1, "dim_feedforward": 48, "learning_rate": 1e-3},
}  # fmt: skip


def _assert_close(got, want, tol: float, what: str) -> None:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-12), what


def _multi_target_cohort(tmp_path):
    random.seed(0)
    np.random.seed(0)
    clini, slide, feats, _ = create_random_multi_target_dataset(
        dir=tmp_path, n_patients=12, feat_dim=FEAT_DIM, target_labels=list(_TARGETS),
        categories_per_target=list(_TARGETS.values()), max_slides_per_patient=1, min_tiles_per_slide=6,
        max_tiles_per_slide=24,
    )  # fmt: skip
    for path in feats.glob("*.h5"):  # coordinates over a 4 mm region instead of [0, 1) µm
        with h5py.File(path, "r+") as h5:
            h5["coords"][...] = h5["coords"][...] * 4000.0
    # every class in each fold's training half (a fold's head has the classes
    # its training patients show, in both packages), one target missing
    table = pd.read_csv(clini)
    table["KRAS status"] = [["mut", "wt"][i % 2] for i in range(len(table))]
    table["grade"] = [["g1", "g2", "g3"][i % 3] for i in range(len(table))]
    table.loc[3, "grade"] = None
    table.to_csv(clini, index=False)
    return clini, slide, feats


def _slide_cohort(tmp_path):
    random.seed(1)
    np.random.seed(1)
    feats = tmp_path / "feats"
    feats.mkdir()
    rows = []
    for i in range(12):
        create_random_patient_level_feature_file(tmp_path=feats, feat_dim=FEAT_DIM, feat_filename=f"s{i}",
                                                 feat_type="slide")  # fmt: skip
        rows.append((f"s{i}.h5", f"p{i}", ["high", "low"][i % 2]))
    slide, clini = tmp_path / "slide.csv", tmp_path / "clini.csv"
    pd.DataFrame([r[:2] for r in rows], columns=["slide_path", "patient"]).to_csv(slide, index=False)
    pd.DataFrame([r[1:] for r in rows], columns=["patient", "ground-truth"]).to_csv(clini, index=False)
    return clini, slide, feats


def _config(tmp_path, name, section, cohort, model_name, ground_truth_label, **extra) -> str:
    clini, slide, feats = cohort
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({
        section: {
            "output_dir": str(tmp_path / name), "clini_table": str(clini), "slide_table": str(slide),
            "feature_dir": str(feats), "patient_label": "patient", "filename_label": "slide_path",
            "task": "classification", "ground_truth_label": ground_truth_label, **extra,
        },
        "advanced_config": {
            "bag_size": 8, "batch_size": 4, "max_epochs": 2, "num_workers": 1, "accelerator": "cpu", "seed": 0,
            "max_lr": 1e-3, "model_name": model_name,
            "model_params": {model_name: _MODEL_PARAMS.get(model_name, {})},
        },
    }))  # fmt: skip
    return str(path)


def _run_both(tmp_path, monkeypatch, command, section, cohort, model_name, ground_truth_label, **extra):
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    initial: list = []
    jax_init = jax_tasks.TaskModel.init_variables

    def record_init(self, rng, example):
        variables = jax_init(self, rng, example)
        initial.append(jax.tree_util.tree_map(np.asarray, dict(variables)))
        return variables

    monkeypatch.setattr(jax_tasks.TaskModel, "init_variables", record_init)
    jax_cfg = _config(tmp_path, "jax", section, cohort, model_name, ground_truth_label, **extra)
    monkeypatch.setattr(sys, "argv", ["stamp", "-c", jax_cfg, command])
    jax_main()
    monkeypatch.setattr(train, "_init_module", lambda model: weights.load_variables_(model.module, initial.pop(0)))
    torch_main(["-c", _config(tmp_path, "torch", section, cohort, model_name, ground_truth_label, **extra), command])
    assert not initial  # every model started from its JAX initial variables
    return tmp_path / "jax", tmp_path / "torch"


def test_multi_target_crossval_matches_jax_cli(tmp_path, monkeypatch):
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu.modeling import crossval as jax_crossval
    from stamp_tpu.modeling.data import load_patient_data_ as jax_load
    from stamp_tpu_torch.__main__ import main as torch_main
    from stamp_tpu_torch.modeling import crossval
    from stamp_tpu_torch.modeling.data import load_patient_data_
    from test_torch_deploy_zoo import barspoon_checkpoint

    cohort = _multi_target_cohort(tmp_path)
    clini, slide, feats = cohort
    kwargs = dict(clini_table=clini, slide_table=slide, feature_dir=feats, patient_label="patient",
                  filename_label="slide_path", task="classification", ground_truth_label=list(_TARGETS),
                  time_label=None, status_label=None)  # fmt: skip
    want = jax_crossval._generate_splits(jax_load(**kwargs)[0], n_splits=2, task="classification")
    got = crossval._generate_splits(load_patient_data_(**kwargs)[0], n_splits=2, task="classification")
    assert got.model_dump() == want.model_dump()

    barspoon_checkpoint(tmp_path / "model.ckpt", seed=10)
    for name in ("jax", "torch"):  # the same folds and fold checkpoints in both output directories
        (tmp_path / name).mkdir()
        (tmp_path / name / "splits.json").write_text(want.model_dump_json())
        for fold in range(2):
            (tmp_path / name / f"split-{fold}").mkdir()
            shutil.copy(tmp_path / "model.ckpt", tmp_path / name / f"split-{fold}" / "model.ckpt")
    jax_cfg = _config(tmp_path, "jax", "crossval", cohort, "barspoon", list(_TARGETS), n_splits=2)
    monkeypatch.setattr(sys, "argv", ["stamp", "-c", jax_cfg, "crossval"])
    jax_main()
    torch_main(["-c", _config(tmp_path, "torch", "crossval", cohort, "barspoon", list(_TARGETS), n_splits=2),
                "crossval"])  # fmt: skip
    for fold in range(2):
        w = pd.read_csv(tmp_path / f"jax/split-{fold}/patient-preds.csv").sort_values("patient")
        g = pd.read_csv(tmp_path / f"torch/split-{fold}/patient-preds.csv").sort_values("patient")
        assert list(g.columns) == list(w.columns)
        assert "pred_KRAS status" in g.columns and "grade_g3" in g.columns
        assert g["patient"].tolist() == w["patient"].tolist()
        probs = [c for c in w.columns if c.startswith(("KRAS status_", "grade_"))]
        _assert_close(g[probs].to_numpy(), w[probs].to_numpy(), 1e-5, f"fold {fold}")
        for column in ("pred_KRAS status", "pred_grade", "grade"):
            assert g[column].tolist() == w[column].tolist(), column


@pytest.mark.parametrize("level,model_name", [("slide", "mlp"), ("patient", "linear")])
def test_train_matches_jax_cli(tmp_path, monkeypatch, level, model_name):
    if level == "slide":
        cohort = _slide_cohort(tmp_path)
    else:
        random.seed(2)
        np.random.seed(2)
        cohort = create_random_patient_level_dataset(
            dir=tmp_path, feat_dim=FEAT_DIM, n_patients=12, categories=["high", "low"]
        )[:3]
    jax_dir, torch_dir = _run_both(tmp_path, monkeypatch, "train", "training", cohort, model_name, "ground-truth")
    want_ckpt, got_ckpt = load_checkpoint(jax_dir / "model.ckpt"), load_checkpoint(torch_dir / "model.ckpt")
    assert got_ckpt["hyper_parameters"]["supported_features"] == level
    for key in ("train_patients", "valid_patients", "categories", "model_name"):
        assert got_ckpt["hyper_parameters"][key] == want_ckpt["hyper_parameters"][key], key
    want = pd.read_csv(jax_dir / "lightning_logs/version_0/metrics.csv")
    got = pd.read_csv(torch_dir / "lightning_logs/version_0/metrics.csv")
    assert list(got.columns) == list(want.columns) and len(got) == len(want)
    for column in want.columns:
        _assert_close(got[column].to_numpy(), want[column].to_numpy(), 1e-4, column)
    want_vars, got_vars = weights.flatten(want_ckpt["variables"]), weights.flatten(got_ckpt["variables"])
    assert set(got_vars) == set(want_vars)
    for path, value in want_vars.items():
        _assert_close(got_vars[path], value, 1e-4, path)
