"""``deploy`` through both CLIs on the CPU (``accelerator: cpu``): the same
cohort (tests/random_data.py, feature files written by h5py) and the same
checkpoints (written by the JAX package) through ``python -m stamp_tpu`` and
``python -m stamp_tpu_torch``; the prediction CSVs must match column for
column, with scores within 1e-5."""

import logging
import random
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import yaml

from random_data import (
    create_random_dataset,
    create_random_regression_dataset,
    create_random_survival_dataset,
)
from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.modeling.checkpoint import save_checkpoint
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT

FEAT_DIM = 16
ATOL = 1e-5  # probabilities, regression outputs and risk scores, f32 on both sides
_VIT = dict(dim_model=32, n_layers=2, n_heads=4, dim_feedforward=32, dropout=0.0)


@pytest.fixture(autouse=True)
def stamp_logger_handlers():
    """Drop the log handlers the CLI runs add to the shared "stamp" logger."""
    logger = logging.getLogger("stamp")
    before = list(logger.handlers)
    yield
    for handler in logger.handlers[:]:
        if handler not in before:
            logger.removeHandler(handler)
            handler.close()


def _cohort(tmp_path, task: str):
    random.seed(0)
    np.random.seed(0)
    kwargs = dict(
        dir=tmp_path, n_patients=6, feat_dim=FEAT_DIM, max_slides_per_patient=1,
        min_tiles_per_slide=8, max_tiles_per_slide=40,
    )  # fmt: skip
    if task == "classification":
        clini, slide, feats, _ = create_random_dataset(categories=["high", "low"], **kwargs)
    elif task == "regression":
        clini, slide, feats, _ = create_random_regression_dataset(**kwargs)
    else:
        clini, slide, feats, _ = create_random_survival_dataset(**kwargs)
    return clini, slide, feats


def _jax_checkpoint(path, task: str, *, use_alibi: bool, seed: int) -> None:
    labels = {
        "classification": dict(
            ground_truth_label="ground-truth", categories=["high", "low"], category_weights=[1.0, 1.0]
        ),
        "regression": dict(ground_truth_label="target"),
        "survival": dict(time_label="day", status_label="status", train_pred_median=0.05),
    }[task]
    lit_class = {
        "classification": jax_tasks.LitTileClassifier,
        "regression": jax_tasks.LitTileRegressor,
        "survival": jax_tasks.LitTileSurvival,
    }[task]
    model = lit_class(
        model_class=JaxViT, dim_input=FEAT_DIM, model_name="vit", use_alibi=use_alibi,
        train_patients=["someone-else"], **_VIT, **labels,
    )  # fmt: skip
    variables = model.module.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, 8, FEAT_DIM)),
        coords=jnp.zeros((1, 8, 2)),
        key_mask=jnp.ones((1, 8), bool),
    )
    if use_alibi:  # the cohort's coordinates lie in [0, 1) µm
        variables = jax.tree_util.tree_map(np.asarray, dict(variables))
        for block in variables["alibi_stats"].values():
            block["mhsa"]["running_mean"] = np.full(_VIT["n_heads"], 20.0, np.float32)
    save_checkpoint(path, hyper_parameters=model.checkpoint_hparams(), variables=variables)


def _config(tmp_path, name: str, task: str, clini, slide, feats, checkpoints) -> str:
    labels = {
        "classification": {"ground_truth_label": "ground-truth"},
        "regression": {"ground_truth_label": "target"},
        "survival": {"time_label": "day", "status_label": "status"},
    }[task]
    deployment = {
        "output_dir": str(tmp_path / name),
        "checkpoint_paths": [str(c) for c in checkpoints],
        "clini_table": str(clini),
        "slide_table": str(slide),
        "feature_dir": str(feats),
        "patient_label": "patient",
        "filename_label": "slide_path",
        "accelerator": "cpu",
        **labels,
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({"deployment": deployment}))
    return str(path)


def _deploy_both(tmp_path, monkeypatch, task, clini, slide, feats, checkpoints):
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    jax_cfg = _config(tmp_path, "jax", task, clini, slide, feats, checkpoints)
    torch_cfg = _config(tmp_path, "torch", task, clini, slide, feats, checkpoints)
    monkeypatch.setattr(sys, "argv", ["stamp", "-c", jax_cfg, "deploy"])
    jax_main()
    torch_main(["-c", torch_cfg, "deploy"])
    return tmp_path / "jax", tmp_path / "torch"


def _assert_same_csv(jax_csv, torch_csv, patient_label="patient") -> pd.DataFrame:
    want, got = pd.read_csv(jax_csv), pd.read_csv(torch_csv)
    assert list(got.columns) == list(want.columns)
    want = want.sort_values(patient_label).reset_index(drop=True)
    got = got.sort_values(patient_label).reset_index(drop=True)
    assert len(got) == len(want) == 6
    for column in want.columns:
        if pd.api.types.is_float_dtype(want[column]):
            np.testing.assert_allclose(got[column], want[column], atol=ATOL, rtol=0, err_msg=column)
        else:
            assert got[column].tolist() == want[column].tolist(), column
    return got


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_classification_matches_jax_cli(tmp_path, monkeypatch, use_alibi):
    clini, slide, feats = _cohort(tmp_path, "classification")
    ckpt = tmp_path / "model.ckpt"
    _jax_checkpoint(ckpt, "classification", use_alibi=use_alibi, seed=1)
    jax_out, torch_out = _deploy_both(tmp_path, monkeypatch, "classification", clini, slide, feats, [ckpt])
    got = _assert_same_csv(jax_out / "patient-preds.csv", torch_out / "patient-preds.csv")
    probs = got[["ground-truth_high", "ground-truth_low"]].to_numpy()
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, atol=1e-6)


def test_ensemble_matches_jax_cli(tmp_path, monkeypatch):
    clini, slide, feats = _cohort(tmp_path, "classification")
    ckpts = [tmp_path / "vit.ckpt", tmp_path / "alibi.ckpt"]
    _jax_checkpoint(ckpts[0], "classification", use_alibi=False, seed=2)
    _jax_checkpoint(ckpts[1], "classification", use_alibi=True, seed=3)
    jax_out, torch_out = _deploy_both(tmp_path, monkeypatch, "classification", clini, slide, feats, ckpts)
    for name in ("patient-preds-0.csv", "patient-preds-1.csv", "patient-preds_95_confidence_interval.csv"):
        _assert_same_csv(jax_out / name, torch_out / name)


def test_regression_matches_jax_cli(tmp_path, monkeypatch):
    clini, slide, feats = _cohort(tmp_path, "regression")
    ckpt = tmp_path / "model.ckpt"
    _jax_checkpoint(ckpt, "regression", use_alibi=False, seed=4)
    jax_out, torch_out = _deploy_both(tmp_path, monkeypatch, "regression", clini, slide, feats, [ckpt])
    _assert_same_csv(jax_out / "patient-preds.csv", torch_out / "patient-preds.csv")


def test_survival_matches_jax_cli(tmp_path, monkeypatch):
    clini, slide, feats = _cohort(tmp_path, "survival")
    ckpt = tmp_path / "model.ckpt"
    _jax_checkpoint(ckpt, "survival", use_alibi=True, seed=5)
    jax_out, torch_out = _deploy_both(tmp_path, monkeypatch, "survival", clini, slide, feats, [ckpt])
    got = _assert_same_csv(jax_out / "patient-preds.csv", torch_out / "patient-preds.csv")
    assert "cut_off=0.05" in got.columns


def test_unported_backbones_raise(tmp_path):
    """Every backbone of the JAX package is ported: an ``mlp`` checkpoint
    loads; a model name outside the registry raises ``ValueError``, as in
    the JAX package."""
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.models.mlp import MLP

    hparams = {
        "task": "classification", "supported_features": "slide", "model_name": "mlp", "stamp_version": "2.5.0",
        "dim_input": FEAT_DIM, "ground_truth_label": "gt", "categories": ["a", "b"], "category_weights": [0.5, 0.5],
    }  # fmt: skip
    save_checkpoint(tmp_path / "mlp.ckpt", hyper_parameters=hparams, variables={})
    model, _ = load_model_from_ckpt(tmp_path / "mlp.ckpt")
    assert isinstance(model.module, MLP) and model.categories == ["a", "b"]
    save_checkpoint(tmp_path / "cobra.ckpt", hyper_parameters={**hparams, "model_name": "cobra"}, variables={})
    with pytest.raises(ValueError, match="cobra"):
        load_model_from_ckpt(tmp_path / "cobra.ckpt")


def test_port_written_features_deploy_alike(tmp_path, monkeypatch):
    """Feature files in the port's own h5 layout (read without h5py by the
    port, with h5py by the JAX package) give the same predictions."""
    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(6)
    feats_dir = tmp_path / "feats"
    rows = []
    for i, n in enumerate((9, 30, 17, 40, 12, 25)):
        coords = (np.stack([np.arange(n) % 5, np.arange(n) // 5], axis=1) * 256.0).astype(np.float32)
        write_tile_feats_atomic(
            output_path=feats_dir / f"s{i}.h5", feats=rng.normal(size=(n, FEAT_DIM)).astype(np.float16),
            coords_um=coords, extractor_id="uni2", tile_size_um=256.0, tile_size_px=224, code_hash="test",
        )  # fmt: skip
        rows.append((f"s{i}.h5", f"p{i}", ["high", "low"][i % 2]))
    slide, clini = tmp_path / "slide.csv", tmp_path / "clini.csv"
    pd.DataFrame([r[:2] for r in rows], columns=["slide_path", "patient"]).to_csv(slide, index=False)
    pd.DataFrame([r[1:] for r in rows], columns=["patient", "ground-truth"]).to_csv(clini, index=False)
    ckpt = tmp_path / "model.ckpt"
    _jax_checkpoint(ckpt, "classification", use_alibi=True, seed=7)
    jax_out, torch_out = _deploy_both(tmp_path, monkeypatch, "classification", clini, slide, feats_dir, [ckpt])
    _assert_same_csv(jax_out / "patient-preds.csv", torch_out / "patient-preds.csv")
