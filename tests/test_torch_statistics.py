"""The port's ``statistics`` against scikit-learn and the JAX package.

* ``stamp_tpu_torch.statistics.metrics`` (numpy) against ``sklearn.metrics``
  on the same seeded inputs, ties, one class, a constant ``y_true`` and
  perfect predictions among them: ≤ 1e-12, NaN where scikit-learn gives
  NaN, and an error where it raises;
* every CSV table of ``compute_stats_`` against ``stamp_tpu``'s on the same
  prediction CSVs (classification single fold, folds, the deploy ensemble;
  regression; survival with and without a recorded cut-off), ≤ 1e-12, and
  the same file names;
* the survival primitives on the golden cohort of
  ``tests/test_survival_golden.py`` (C-index exactly 323/344).
"""

import warnings
from fractions import Fraction

import numpy as np
import pandas as pd
import pytest
from sklearn import metrics as skm

import test_survival_golden as golden
from stamp_tpu.statistics import compute_stats_ as jax_compute_stats_
from stamp_tpu_torch.statistics import compute_stats_, metrics
from stamp_tpu_torch.statistics.survival_util import KaplanMeier, concordance_index, logrank_test

TOL = 1e-12


def _scores(kind: str, seed: int = 0, n: int = 37) -> tuple[np.ndarray, np.ndarray]:
    """(y_true bool, y_score) of one seeded case."""
    rng = np.random.default_rng(seed)
    y = rng.random(n) < 0.4
    s = rng.random(n)
    if kind == "ties":
        s = np.round(s, 1)
    elif kind == "perfect":
        s = y + 0.1 * rng.random(n)
    elif kind == "all_positive":
        y = np.ones(n, bool)
    elif kind == "all_negative":
        y = np.zeros(n, bool)
    elif kind == "constant_score":
        s = np.full(n, 0.3)
    return y, s


_KINDS = ["random", "ties", "perfect", "all_positive", "all_negative", "constant_score"]


def _assert_same(got, want) -> None:
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~np.isnan(got)], want[~np.isnan(want)], rtol=0, atol=TOL)


@pytest.mark.parametrize("kind", _KINDS)
def test_ranking_metrics_match_sklearn(kind):
    y, s = _scores(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # scikit-learn warns on one class
        for got, want in (
            (metrics.roc_curve(y, s), skm.roc_curve(y, s)),
            (metrics.precision_recall_curve(y, s), skm.precision_recall_curve(y, s)),
        ):
            for g, w in zip(got, want, strict=True):
                _assert_same(g, w)
        _assert_same(metrics.roc_auc_score(y, s), skm.roc_auc_score(y, s))
        _assert_same(metrics.average_precision_score(y, s), skm.average_precision_score(y, s))
        precision, recall, _ = skm.precision_recall_curve(y, s)
        _assert_same(metrics.auc(recall, precision), skm.auc(recall, precision))
        fpr, tpr, _ = skm.roc_curve(y, s)
        _assert_same(metrics.auc(fpr, tpr), skm.auc(fpr, tpr))
        for threshold in (0.0, 0.5, 2.0):  # all, some and no positive calls
            _assert_same(metrics.f1_score(y, s > threshold), skm.f1_score(y, s > threshold))


@pytest.mark.parametrize("kind", ["random", "perfect", "constant_truth", "constant_both", "one_sample"])
def test_regression_metrics_match_sklearn(kind):
    rng = np.random.default_rng(1)
    y = rng.uniform(0, 100, 29)
    p = y + rng.normal(0, 5, 29)
    if kind == "perfect":
        p = y.copy()
    elif kind == "constant_truth":
        y = np.full(29, 3.0)
    elif kind == "constant_both":
        y, p = np.full(29, 3.0), np.full(29, 3.0)
    elif kind == "one_sample":
        y, p = y[:1], p[:1]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # R² of one sample warns
        for name in ("r2_score", "mean_absolute_error", "mean_squared_error"):
            _assert_same(getattr(metrics, name)(y, p), getattr(skm, name)(y, p))


def test_metrics_raise_where_sklearn_raises():
    for x in ([0.5], [0.0, 1.0, 0.5]):  # one point; not monotone
        with pytest.raises(ValueError):
            skm.auc(x, np.ones(len(x)))
        with pytest.raises(ValueError):
            metrics.auc(x, np.ones(len(x)))
    for fn in (skm.roc_curve, metrics.roc_curve):
        with pytest.raises(ValueError):
            fn([True, False, True], [0.1, np.nan, 0.3])
        with pytest.raises(ValueError):
            fn([True, False], [0.1, 0.2, 0.3])
    # decreasing x is an area too
    assert metrics.auc([1.0, 0.5, 0.0], [1.0, 1.0, 1.0]) == skm.auc([1.0, 0.5, 0.0], [1.0, 1.0, 1.0])


# --- the report tables against the JAX package --------------------------------


def _classification_csv(path, seed: int, n: int = 40, categories=("a", "b", "c")) -> None:
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(n, len(categories)))
    truth = rng.choice(list(categories), n)
    logits[np.arange(n), [categories.index(t) for t in truth]] += 1.0  # some signal
    probs = np.exp(logits) / np.exp(logits).sum(axis=1, keepdims=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({
        "PATIENT": [f"p{i}" for i in range(n)],
        "isup": truth,
        "pred": [categories[i] for i in probs.argmax(axis=1)],
        **{f"isup_{c}": probs[:, i] for i, c in enumerate(categories)},
    }).to_csv(path, index=False)  # fmt: skip


def _regression_csv(path, seed: int, n: int = 30) -> None:
    rng = np.random.default_rng(seed)
    truth = rng.uniform(0, 50, n)
    path.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({"PATIENT": [f"p{i}" for i in range(n)], "t": truth, "pred": truth + rng.normal(0, 4, n)}).to_csv(
        path, index=False
    )


def _survival_csv(path, seed: int, cut_off: float | None, n: int = 40) -> None:
    rng = np.random.default_rng(seed)
    risk = rng.normal(0, 1, n)
    df = pd.DataFrame({
        "PATIENT": [f"p{i}" for i in range(n)],
        "pred_score": risk,
        "day": np.round(np.maximum(1, 800 - 250 * risk + rng.normal(0, 80, n))),  # ties
        "status": rng.choice([0, 1], n, p=[0.3, 0.7]),
    })  # fmt: skip
    if cut_off is not None:
        df[f"cut_off={cut_off}"] = None
    path.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(path, index=False)


_CASES = {
    "single_fold": lambda root: ([_classification_csv(root / "patient-preds.csv", 0)], "classification"),
    "folds": lambda root: (
        [_classification_csv(root / f"split-{i}" / "patient-preds.csv", i) for i in range(3)],
        "classification",
    ),
    "deploy_ensemble": lambda root: (
        [_classification_csv(root / f"patient-preds-{i}.csv", 10 + i, categories=("high", "low")) for i in range(2)],
        "classification",
    ),
    "regression": lambda root: (
        [_regression_csv(root / f"split-{i}" / "patient-preds.csv", 20 + i) for i in range(3)],
        "regression",
    ),
    "survival_median": lambda root: ([_survival_csv(root / "patient-preds.csv", 30, None)], "survival"),
    "survival_cut_off": lambda root: (
        [_survival_csv(root / f"split-{i}" / "patient-preds.csv", 40 + i, 0.1) for i in range(2)],
        "survival",
    ),
}


def _task_args(task: str, case: str) -> dict:
    if task == "classification":
        return dict(ground_truth_label="isup", true_class="low" if case == "deploy_ensemble" else "b")
    if task == "regression":
        return dict(ground_truth_label="t")
    return dict(time_label="day", status_label="status")


@pytest.mark.parametrize("case", list(_CASES))
def test_tables_match_jax_package(case, tmp_path):
    data = tmp_path / "preds"
    _, task = _CASES[case](data)
    csvs = sorted(data.rglob("*.csv"))
    args = _task_args(task, case)
    jax_compute_stats_(task=task, output_dir=tmp_path / "jax", pred_csvs=csvs, **args)
    compute_stats_(task=task, output_dir=tmp_path / "torch", pred_csvs=csvs, **args)

    def tree(root):
        return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())

    assert tree(tmp_path / "torch") == tree(tmp_path / "jax")
    tables = sorted((tmp_path / "jax").glob("*.csv"))
    assert tables
    for table in tables:
        header = [0, 1] if "categorical-stats_aggregated" in table.name else 0
        index = [0, 1] if "categorical-stats_individual" in table.name else 0
        want = pd.read_csv(table, header=header, index_col=index)
        got = pd.read_csv(tmp_path / "torch" / table.name, header=header, index_col=index)
        pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=0, atol=TOL)
        assert np.isfinite(want.select_dtypes("number").to_numpy(float)).any()


def test_classification_aurocs_equal_the_metric_on_the_csv(tmp_path):
    """The individual table's AUROC of each class is the metric on the CSV's
    one-vs-rest column."""
    csv = tmp_path / "split-0" / "patient-preds.csv"
    _classification_csv(csv, 3)
    compute_stats_(task="classification", output_dir=tmp_path / "out", pred_csvs=[csv],
                   ground_truth_label="isup", true_class="a")  # fmt: skip
    table = pd.read_csv(tmp_path / "out" / "isup_categorical-stats_individual.csv", index_col=[0, 1])
    preds = pd.read_csv(csv)
    for cls in ("a", "b", "c"):
        want = metrics.roc_auc_score(preds["isup"] == cls, preds[f"isup_{cls}"])
        assert table.loc[("split-0_patient-preds", cls), "roc_auc_score"] == want


# --- survival primitives: the golden cohort ------------------------------------


def test_cindex_golden():
    assert golden._brute_cindex(golden.TIMES, golden.EVENTS, golden.SCORES) == Fraction(323, 344)
    assert concordance_index(golden.TIMES, golden.SCORES, golden.EVENTS) == pytest.approx(323 / 344, abs=TOL)


def test_logrank_golden():
    a = golden.GROUP_A
    got = logrank_test(golden.TIMES[a], golden.TIMES[~a], golden.EVENTS[a], golden.EVENTS[~a])
    assert got.test_statistic == pytest.approx(0.002647947095978632, abs=TOL)
    assert got.p_value == pytest.approx(0.9589604034673544, abs=TOL)


def test_kaplan_meier_golden():
    km = KaplanMeier.fit(golden.TIMES, golden.EVENTS)
    for probe, want in golden.KM_GOLDEN_ALL.items():
        idx = np.searchsorted(km.timeline, probe, side="right") - 1
        assert km.survival[idx] == pytest.approx(want, abs=TOL), probe
    assert list(km.at_risk_at(np.array([0.0, 15.0, 40.0]))) == [24, 15, 2]
