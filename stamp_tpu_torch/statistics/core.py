"""Pure statistical computation for deployment reports — no I/O, no plotting.

Copy of ``stamp_tpu/statistics/core.py`` (one generic bootstrap engine for
the ROC and PR confidence bands, per-class one-vs-rest scores, regression
scores) with scikit-learn's metrics taken from the port's numpy
``statistics.metrics``: the card's machine has no scikit-learn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import scipy.stats as st

from stamp_tpu_torch.statistics import metrics

# metric columns every per-class score table carries, in output order
SCORE_COLUMNS = (
    "count",
    "roc_auc_score",
    "average_precision_score",
    "f1_score",
    "p_value",
)


def students_t_ci(
    values: np.ndarray, confidence: float = 0.95
) -> tuple[float, float, float]:
    """(mean, lower, upper) of a Student-t confidence interval over folds.

    Degenerate inputs (a single fold, zero variance) collapse the interval
    onto the mean instead of producing NaNs.
    """
    values = np.asarray(values, dtype=float)
    mean = float(values.mean())
    if len(values) < 2:
        return mean, mean, mean
    sem = st.sem(values)
    if not np.isfinite(sem) or sem == 0.0:
        return mean, mean, mean
    lower, upper = st.t.interval(confidence, len(values) - 1, loc=mean, scale=sem)
    return mean, float(lower), float(upper)


def one_vs_rest_scores(
    labels: np.ndarray, probabilities: np.ndarray, classes: np.ndarray
) -> dict[str, dict[str, float]]:
    """Per-class one-vs-rest metrics for one fold's predictions.

    ``probabilities[:, i]`` is the predicted probability of ``classes[i]``.
    Returns {class: {metric: value}} with the metrics of ``SCORE_COLUMNS``:
    sample count, AUROC, average precision, F1 of the argmax prediction, and
    the two-sided t-test p-value of in-class vs out-of-class scores
    (reference categorical.py:48-99 behaviour).
    """
    labels = np.asarray(labels)
    probabilities = np.asarray(probabilities, dtype=float)
    hard_calls = classes[probabilities.argmax(axis=1)]

    table: dict[str, dict[str, float]] = {}
    for i, cls in enumerate(classes):
        member = labels == cls
        score = probabilities[:, i]
        _, p_value = st.ttest_ind(score[member], score[~member])
        table[str(cls)] = {
            "count": int(member.sum()),
            "roc_auc_score": float(metrics.roc_auc_score(member, score)),
            "average_precision_score": float(
                metrics.average_precision_score(member, score)
            ),
            "f1_score": float(metrics.f1_score(member, hard_calls == cls)),
            "p_value": float(p_value),
        }
    return table


# ---------------------------------------------------------------------------
# Curves and bootstrap confidence bands
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Curve:
    """A plottable curve with its scalar summary statistic."""

    x: np.ndarray
    y: np.ndarray
    score: float  # AUROC / AUPRC


@dataclass(frozen=True)
class CurveBand:
    """A bootstrap envelope around a curve, on a fixed x grid."""

    grid: np.ndarray
    y_lower: np.ndarray
    y_upper: np.ndarray
    score_lower: float
    score_upper: float


def roc_points(y_true: np.ndarray, y_score: np.ndarray) -> Curve:
    fpr, tpr, _ = metrics.roc_curve(y_true, y_score)
    return Curve(fpr, tpr, float(metrics.roc_auc_score(y_true, y_score)))


def pr_points(y_true: np.ndarray, y_score: np.ndarray) -> Curve:
    precision, recall, _ = metrics.precision_recall_curve(y_true, y_score)
    # monotone-increasing x for interpolation and AUC
    return Curve(recall[::-1], precision[::-1], float(metrics.auc(recall, precision)))


def bootstrap_band(
    y_true: np.ndarray,
    y_score: np.ndarray,
    curve_fn: Callable[[np.ndarray, np.ndarray], Curve],
    *,
    n_samples: int = 1000,
    grid_points: int = 1000,
    rng: np.random.Generator | None = None,
) -> CurveBand:
    """Resample (with replacement) and collect the 95% envelope of a curve.

    Generic over the curve family: the same engine produces ROC and PR
    bands (reference roc.py:127-167 / prc.py:16-47).  Resamples that lose
    one of the two classes are skipped.
    """
    rng = rng or np.random.default_rng(0)
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    grid = np.linspace(0.0, 1.0, num=grid_points)

    envelopes: list[np.ndarray] = []
    scores: list[float] = []
    n = len(y_true)
    for _ in range(n_samples):
        take = rng.choice(n, n)
        t, s = y_true[take], y_score[take]
        if t.all() or not t.any():
            continue  # single-class resample: curve undefined
        curve = curve_fn(t, s)
        envelopes.append(np.interp(grid, curve.x, curve.y))
        scores.append(curve.score)

    y_lower, y_upper = np.nanquantile(np.stack(envelopes), [0.025, 0.975], axis=0)
    score_lower, score_upper = np.quantile(scores, [0.025, 0.975])
    return CurveBand(grid, y_lower, y_upper, float(score_lower), float(score_upper))


# ---------------------------------------------------------------------------
# Regression metrics
# ---------------------------------------------------------------------------


def regression_scores(y_true: np.ndarray, y_pred: np.ndarray) -> dict[str, float]:
    """R² / Pearson / MAE / RMSE for one fold (reference regression.py:14-47)."""
    y_true = np.asarray(y_true, dtype=float)
    y_pred = np.asarray(y_pred, dtype=float)
    if y_true.std() == 0 or y_pred.std() == 0:
        pearson_r = pearson_p = float("nan")
    else:
        result = st.pearsonr(y_true, y_pred)
        pearson_r, pearson_p = float(result[0]), float(result[1])
    return {
        "r2_score": float(metrics.r2_score(y_true, y_pred)),
        "pearson_r": pearson_r,
        "pearson_p": pearson_p,
        "mae": float(metrics.mean_absolute_error(y_true, y_pred)),
        "rmse": float(np.sqrt(metrics.mean_squared_error(y_true, y_pred))),
        "count": int(len(y_true)),
    }
