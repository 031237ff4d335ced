"""``crossval`` through both CLIs on the CPU (``accelerator: cpu``,
``seed: 0``): the same ``splits.json``, and per fold the same
``patient-preds.csv`` columns, patients and scores, the port starting every
fold from the JAX package's initial variables."""

import json

import numpy as np
import pandas as pd
import pytest

from test_torch_train import _cohort, _run_both, stamp_logger_handlers  # noqa: F401 (fixture)


@pytest.mark.parametrize(
    "task,use_alibi,bag_size", [("classification", True, 8), ("regression", False, 8)]
)
def test_crossval_matches_jax_cli(tmp_path, monkeypatch, task, use_alibi, bag_size):
    cohort = _cohort(tmp_path, task)
    jax_dir, torch_dir = _run_both(
        tmp_path, monkeypatch, "crossval", task, cohort, use_alibi=use_alibi, bag_size=bag_size,
        section="crossval", n_splits=2,
    )  # fmt: skip
    want = json.loads((jax_dir / "splits.json").read_text())
    got = json.loads((torch_dir / "splits.json").read_text())
    assert len(got["splits"]) == len(want["splits"]) == 2
    for g, w in zip(got["splits"], want["splits"], strict=True):
        assert set(g["train_patients"]) == set(w["train_patients"])
        assert set(g["test_patients"]) == set(w["test_patients"])

    score_columns = {"classification": ["ground-truth_high", "ground-truth_low"], "regression": ["pred"]}[task]
    for fold in range(2):
        w = pd.read_csv(jax_dir / f"split-{fold}/patient-preds.csv").sort_values("patient")
        g = pd.read_csv(torch_dir / f"split-{fold}/patient-preds.csv").sort_values("patient")
        assert list(g.columns) == list(w.columns)
        assert g["patient"].tolist() == w["patient"].tolist()
        assert (torch_dir / f"split-{fold}/model.ckpt").is_file()
        for column in score_columns:
            np.testing.assert_allclose(g[column], w[column], rtol=1e-4, atol=1e-4 * np.abs(w[column]).max())
