"""``deploy`` of the other backbones and feature levels through both CLIs on
the CPU (``accelerator: cpu``): npz checkpoints written by the JAX package
(random weights from its own initializers) of a slide-level ``mlp``, a
patient-level ``linear``, a tile-level ``trans_mil`` and a multi-target
``barspoon``, deployed by ``python -m stamp_tpu`` and ``python -m
stamp_tpu_torch`` on the same cohort; the CSVs must match column for column
with scores within 1e-5 (``test_torch_deploy._assert_same_csv``).  The
slide-level model is also deployed on patient-level features, which
``_DEPLOYABLE_ON`` allows, and the port's ``statistics`` reads its
multi-target CSV: one table set per target, each AUROC the rank AUROC of
its CSV columns (1e-12)."""

import random
import shutil
import sys

import jax
import numpy as np
import pandas as pd
import pytest
import yaml

from random_data import (
    create_random_dataset,
    create_random_multi_target_dataset,
    create_random_patient_level_dataset,
    create_random_patient_level_feature_file,
)
from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.modeling.checkpoint import save_checkpoint
from stamp_tpu.models import mlp as jax_mlp
from stamp_tpu.models.trans_mil import TransMIL as JaxTransMIL
from test_torch_deploy import _assert_same_csv, stamp_logger_handlers  # noqa: F401 (fixture)

FEAT_DIM = 16
_TARGETS = {"KRAS status": ["mut", "wt"], "grade": ["g1", "g2", "g3"]}
_CLASSES = dict(ground_truth_label="ground-truth", categories=["high", "low"],
                category_weights=np.array([0.4, 0.6], np.float32))  # fmt: skip


def _save(path, model, batch, seed: int) -> None:
    variables = jax.jit(lambda b: model.init_variables(jax.random.PRNGKey(seed), b))(batch)
    save_checkpoint(path, hyper_parameters=model.checkpoint_hparams(), variables=variables)


def _slide_cohort(tmp_path):
    """Six patients, one slide-level feature file each (``feat_type`` slide)."""
    random.seed(0)
    np.random.seed(0)
    feats = tmp_path / "slide-feats"
    feats.mkdir()
    rows = []
    for i in range(6):
        create_random_patient_level_feature_file(
            tmp_path=feats, feat_dim=FEAT_DIM, feat_filename=f"s{i}", feat_type="slide"
        )
        rows.append((f"s{i}.h5", f"p{i}", ["high", "low"][i % 2]))
    slide, clini = tmp_path / "slide.csv", tmp_path / "clini.csv"
    pd.DataFrame([r[:2] for r in rows], columns=["slide_path", "patient"]).to_csv(slide, index=False)
    pd.DataFrame([r[1:] for r in rows], columns=["patient", "ground-truth"]).to_csv(clini, index=False)
    return clini, slide, feats


def _deploy_both(tmp_path, monkeypatch, name, clini, slide, feats, ckpt, ground_truth_label):
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    outputs = []
    for package in ("jax", "torch"):
        config = tmp_path / f"{name}-{package}.yaml"
        config.write_text(yaml.safe_dump({"deployment": {
            "output_dir": str(tmp_path / name / package), "checkpoint_paths": [str(ckpt)],
            "clini_table": str(clini), "slide_table": str(slide), "feature_dir": str(feats),
            "patient_label": "patient", "filename_label": "slide_path", "accelerator": "cpu",
            "ground_truth_label": ground_truth_label,
        }}))  # fmt: skip
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["stamp", "-c", str(config), "deploy"])
            jax_main()
        else:
            torch_main(["-c", str(config), "deploy"])
        outputs.append(tmp_path / name / package / "patient-preds.csv")
    return outputs


def test_slide_mlp_deploys_on_slide_and_patient_features(tmp_path, monkeypatch):
    clini, slide, feats = _slide_cohort(tmp_path)
    model = jax_tasks.LitSlideClassifier(model_class=jax_mlp.MLP, dim_input=FEAT_DIM, model_name="mlp",
                                         dim_hidden=24, num_layers=3, train_patients=["p1"], **_CLASSES)  # fmt: skip
    ckpt = tmp_path / "mlp.ckpt"
    _save(ckpt, model, (np.zeros((1, FEAT_DIM), np.float32), None), seed=1)
    got = _assert_same_csv(*_deploy_both(tmp_path, monkeypatch, "slide", clini, slide, feats, ckpt, "ground-truth"))
    np.testing.assert_allclose(got[["ground-truth_high", "ground-truth_low"]].sum(axis=1), 1.0, atol=1e-6)

    # the same slide-level model on patient-level features
    (tmp_path / "patients").mkdir()
    random.seed(1)
    np.random.seed(1)
    p_clini, p_slide, p_feats, _ = create_random_patient_level_dataset(
        dir=tmp_path / "patients", feat_dim=FEAT_DIM, n_patients=6, categories=["high", "low"]
    )
    _assert_same_csv(*_deploy_both(tmp_path, monkeypatch, "on-patients", p_clini, p_slide, p_feats, ckpt, "ground-truth"))


def test_patient_linear(tmp_path, monkeypatch):
    random.seed(2)
    np.random.seed(2)
    clini, slide, feats, _ = create_random_patient_level_dataset(
        dir=tmp_path, feat_dim=FEAT_DIM, n_patients=6, categories=["high", "low"]
    )
    model = jax_tasks.LitPatientClassifier(model_class=jax_mlp.Linear, dim_input=FEAT_DIM, model_name="linear",
                                           **_CLASSES)  # fmt: skip
    ckpt = tmp_path / "linear.ckpt"
    _save(ckpt, model, (np.zeros((1, FEAT_DIM), np.float32), None), seed=2)
    _assert_same_csv(*_deploy_both(tmp_path, monkeypatch, "patient", clini, slide, feats, ckpt, "ground-truth"))


def test_tile_trans_mil(tmp_path, monkeypatch):
    """Bags of 37 tiles: neither a multiple of the 16 landmarks nor one less
    than a square (one bag length: the JAX package compiles once)."""
    random.seed(4)
    np.random.seed(4)
    clini, slide, feats, _ = create_random_dataset(
        dir=tmp_path, n_patients=6, feat_dim=FEAT_DIM, max_slides_per_patient=1, min_tiles_per_slide=37,
        max_tiles_per_slide=37, categories=["high", "low"],
    )  # fmt: skip
    model = jax_tasks.LitTileClassifier(model_class=JaxTransMIL, dim_input=FEAT_DIM, model_name="trans_mil",
                                        dim_hidden=32, categories=["high", "low"], ground_truth_label="ground-truth",
                                        category_weights=np.array([0.5, 0.5], np.float32))  # fmt: skip
    ckpt = tmp_path / "trans_mil.ckpt"
    batch = (np.zeros((1, 8, FEAT_DIM), np.float32), np.zeros((1, 8, 2), np.float32), np.array([8]), None)
    _save(ckpt, model, batch, seed=3)
    _assert_same_csv(*_deploy_both(tmp_path, monkeypatch, "trans_mil", clini, slide, feats, ckpt, "ground-truth"))


@pytest.fixture
def multi_target_cohort(tmp_path):
    random.seed(3)
    np.random.seed(3)
    clini, slide, feats, _ = create_random_multi_target_dataset(
        dir=tmp_path, n_patients=6, feat_dim=FEAT_DIM, target_labels=list(_TARGETS),
        categories_per_target=list(_TARGETS.values()), max_slides_per_patient=1, min_tiles_per_slide=8,
        max_tiles_per_slide=40,
    )  # fmt: skip
    coords_scale = 4000.0  # the generator's coordinates lie in [0, 1) µm: spread them over a slide
    import h5py

    for path in feats.glob("*.h5"):
        with h5py.File(path, "r+") as h5:
            h5["coords"][...] = h5["coords"][...] * coords_scale
    return clini, slide, feats


def barspoon_checkpoint(path, *, seed: int) -> None:
    """A JAX-initialised multi-target barspoon (two targets of 2 and 3
    classes, width 32) for tile features of width ``FEAT_DIM``."""
    model = jax_tasks.LitEncDecTransformer(
        dim_input=FEAT_DIM, ground_truth_label=list(_TARGETS), categories=_TARGETS,
        category_weights={t: np.full(len(c), 1 / len(c), np.float32) for t, c in _TARGETS.items()},
        d_model=32, num_encoder_heads=4, num_decoder_heads=4, num_encoder_layers=1, num_decoder_layers=1,
        dim_feedforward=48, model_name="barspoon", train_patients=["someone-else"],
    )  # fmt: skip
    batch = (
        np.zeros((1, 8, FEAT_DIM), np.float32), np.zeros((1, 8, 2), np.float32), np.array([8]),
        {t: np.zeros((1, len(c)), np.float32) for t, c in _TARGETS.items()},
    )  # fmt: skip
    _save(path, model, batch, seed=seed)


def test_multi_target_barspoon(tmp_path, monkeypatch, multi_target_cohort):
    ckpt = tmp_path / "barspoon.ckpt"
    barspoon_checkpoint(ckpt, seed=4)
    want_csv, got_csv = _deploy_both(tmp_path, monkeypatch, "barspoon", *multi_target_cohort, ckpt, list(_TARGETS))
    got = _assert_same_csv(want_csv, got_csv)
    assert list(got.columns) == [
        "patient", "KRAS status", "grade", "pred_KRAS status", "KRAS status_mut", "KRAS status_wt",
        "pred_grade", "grade_g1", "grade_g2", "grade_g3", "loss",
    ]  # fmt: skip
    ensemble = pd.read_csv(tmp_path / "barspoon" / "torch" / "patient-preds_95_confidence_interval.csv")
    assert list(ensemble.columns) == list(got.columns)

    # ``statistics`` on the port's multi-target CSV: a table set per target,
    # each AUROC the rank AUROC of its columns
    from stamp_tpu_torch.statistics import compute_stats_

    (tmp_path / "stats" / "deploy").mkdir(parents=True)
    shutil.copy(got_csv, tmp_path / "stats" / "deploy" / got_csv.name)
    compute_stats_(task="classification", output_dir=tmp_path / "stats", ground_truth_label=list(_TARGETS),
                   pred_csvs=[tmp_path / "stats" / "deploy" / got_csv.name])  # fmt: skip
    assert {p.name for p in (tmp_path / "stats").glob("*.csv")} == {
        *(f"{t}_categorical-stats_{kind}.csv" for t in _TARGETS for kind in ("individual", "aggregated")),
        "multitarget_categorical-stats_summary.csv",
    }
    preds = pd.read_csv(got_csv)
    for target, classes in _TARGETS.items():
        table = pd.read_csv(tmp_path / "stats" / f"{target}_categorical-stats_individual.csv", index_col=[0, 1])
        for cls in classes:
            positive = (preds[target] == cls).to_numpy()
            if positive.all() or not positive.any():
                continue
            scores = preds[f"{target}_{cls}"].to_numpy()
            pairs = scores[positive][:, None] - scores[~positive][None, :]
            rank_auroc = float(np.mean((pairs > 0) + 0.5 * (pairs == 0)))
            assert abs(table.loc[("deploy_patient-preds", cls), "roc_auc_score"] - rank_auroc) <= 1e-12
