"""The scikit-learn metrics of the statistics reports, in numpy.

``stamp_tpu/statistics/core.py`` and ``stamp_tpu/modeling/tasks.py`` take
``roc_curve``, ``precision_recall_curve``, ``auc``,
``average_precision_score``, ``f1_score``, ``r2_score``,
``mean_absolute_error``, ``mean_squared_error`` and ``roc_auc_score`` from
``sklearn.metrics``, which the port's GPU machine does not have.  These are
scikit-learn 1.9's algorithms for the arguments STAMP passes (1-D binary
``y_true``, no sample weights), with its results on one class: NaN rates
where a class is absent, ``average_precision_score`` 1.0 / 0.0, ``f1_score``
0.0 where precision + recall = 0, ``r2_score``'s ``force_finite`` values for
a constant ``y_true``, and NaN for fewer than two samples.
``tests/test_torch_statistics.py`` holds them to scikit-learn.

The algorithms follow ``sklearn/metrics/_ranking.py``,
``sklearn/metrics/_classification.py`` and ``sklearn/metrics/_regression.py``.
scikit-learn is distributed under the BSD 3-Clause License, Copyright (c)
2007-2024 The scikit-learn developers.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any

import numpy as np

__all__ = [
    "auc",
    "average_precision_score",
    "f1_score",
    "mean_absolute_error",
    "mean_squared_error",
    "precision_recall_curve",
    "r2_score",
    "roc_auc_score",
    "roc_curve",
]

_trapezoid = getattr(np, "trapezoid", None) or np.trapz  # numpy < 2 names it trapz


def _binary_clf_curve(y_true, y_score) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fps, tps, thresholds) at each distinct score, highest first
    (scikit-learn's ``confusion_matrix_at_thresholds``); ``y_true`` is
    compared with 1, as scikit-learn's default ``pos_label`` does."""
    y_true = np.asarray(y_true).reshape(-1)
    y_score = np.asarray(y_score).reshape(-1)
    if len(y_true) != len(y_score):
        raise ValueError(f"Found input variables with inconsistent numbers of samples: {[len(y_true), len(y_score)]}")
    if not np.isfinite(y_score).all():
        raise ValueError("Input y_score contains NaN or infinity.")
    order = np.argsort(-y_score, kind="stable")
    y_score = y_score[order]
    positive = (y_true[order] == 1).astype(np.float64)
    threshold_idxs = np.r_[np.nonzero(np.diff(y_score))[0], positive.size - 1]
    tps = np.cumsum(positive)[threshold_idxs]
    fps = 1 + threshold_idxs.astype(np.float64) - tps
    return fps, tps, y_score[threshold_idxs]


def roc_curve(y_true, y_score) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(fpr, tpr, thresholds) with ``drop_intermediate=True``; a rate whose
    class is absent is NaN throughout."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    if fps.shape[0] > 2:
        keep = np.nonzero(np.r_[True, np.logical_or(np.diff(fps, 2), np.diff(tps, 2)), True])[0]
        fps, tps, thresholds = fps[keep], tps[keep], thresholds[keep]
    tps = np.r_[0.0, tps]
    fps = np.r_[0.0, fps]
    thresholds = np.r_[np.inf, thresholds.astype(np.float64)]
    fpr = fps / fps[-1] if fps[-1] > 0 else np.full(fps.shape, np.nan)
    tpr = tps / tps[-1] if tps[-1] > 0 else np.full(tps.shape, np.nan)
    return fpr, tpr, thresholds


def precision_recall_curve(y_true, y_score) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(precision, recall, thresholds), recall decreasing, ending at
    (precision 1, recall 0); recall is 1 throughout without a positive."""
    fps, tps, thresholds = _binary_clf_curve(y_true, y_score)
    ps = tps + fps
    precision = np.divide(tps, ps, out=np.zeros_like(tps), where=ps != 0)
    recall = np.ones_like(tps) if tps[-1] == 0 else tps / tps[-1]
    return np.r_[precision[::-1], 1.0], np.r_[recall[::-1], 0.0], thresholds[::-1]


def auc(x, y) -> float:
    """Trapezoid area under y(x), x monotone either way."""
    x = np.asarray(x).reshape(-1)
    y = np.asarray(y).reshape(-1)
    if len(x) != len(y):
        raise ValueError(f"Found input variables with inconsistent numbers of samples: {[len(x), len(y)]}")
    if x.shape[0] < 2:
        raise ValueError(
            f"At least 2 points are needed to compute area under curve, but x.shape = {x.shape[0]}"
        )
    direction = 1
    dx = np.diff(x)
    if np.any(dx < 0):
        if not np.all(dx <= 0):
            raise ValueError(f"x is neither increasing nor decreasing : {x}.")
        direction = -1
    return float(direction * _trapezoid(y, x))


def average_precision_score(y_true, y_score) -> float:
    """The step sum Σ (Rₙ − Rₙ₋₁)·Pₙ over the precision-recall curve (not
    the trapezoid)."""
    precision, recall, _ = precision_recall_curve(y_true, y_score)
    return float(max(0.0, -np.sum(np.diff(recall) * precision[:-1])))


def f1_score(y_true, y_pred) -> float:
    """Binary F1 of the positive label 1: 2·TP / (2·TP + FP + FN), 0.0
    where that is 0 / 0."""
    y_true = np.asarray(y_true).reshape(-1) == 1
    y_pred = np.asarray(y_pred).reshape(-1) == 1
    tp = float(np.sum(y_true & y_pred))
    denominator = 2 * tp + float(np.sum(y_true != y_pred))
    return 2 * tp / denominator if denominator else 0.0


def _regression_args(y_true, y_pred) -> tuple[np.ndarray, np.ndarray]:
    y_true = np.asarray(y_true, dtype=np.float64).reshape(-1, 1)
    y_pred = np.asarray(y_pred, dtype=np.float64).reshape(-1, 1)
    if len(y_true) != len(y_pred):
        raise ValueError(f"Found input variables with inconsistent numbers of samples: {[len(y_true), len(y_pred)]}")
    return y_true, y_pred


def r2_score(y_true, y_pred) -> float:
    """Coefficient of determination; with a constant ``y_true``, 1.0 for a
    perfect prediction and 0.0 otherwise (``force_finite=True``)."""
    y_true, y_pred = _regression_args(y_true, y_pred)
    if len(y_pred) < 2:
        return float("nan")
    numerator = np.sum((y_true - y_pred) ** 2, axis=0)
    denominator = np.sum((y_true - np.average(y_true, axis=0)) ** 2, axis=0)
    if denominator[0] == 0:
        return 1.0 if numerator[0] == 0 else 0.0
    return float(np.average(1 - numerator / denominator))


def mean_absolute_error(y_true, y_pred) -> float:
    y_true, y_pred = _regression_args(y_true, y_pred)
    return float(np.average(np.average(np.abs(y_pred - y_true), axis=0)))


def mean_squared_error(y_true, y_pred) -> float:
    y_true, y_pred = _regression_args(y_true, y_pred)
    return float(np.average(np.average((y_true - y_pred) ** 2, axis=0)))


def _binary_roc_auc(y_true: np.ndarray, y_score: np.ndarray) -> float:
    """Area under the ROC curve of 0/1 labels (scikit-learn's
    ``_binary_roc_auc_score``); NaN with one class."""
    if len(np.unique(y_true)) != 2:
        return float("nan")
    fpr, tpr, _ = roc_curve(y_true, y_score)
    return auc(fpr, tpr)


def roc_auc_score(
    y_true: Sequence[Any], y_score: np.ndarray, *, multi_class: str = "raise", average: str = "macro"
) -> float:
    """scikit-learn's ``roc_auc_score`` for a binary ``y_true`` with the
    positive class's scores [N], or a multiclass one with class
    probabilities [N, C] and ``multi_class="ovr", average="macro"`` (the
    mean of the one-vs-rest AUCs).  Raises where scikit-learn raises for
    these inputs."""
    y_true = np.asarray(y_true)
    y_score = np.asarray(y_score)
    classes = np.unique(y_true)
    if len(classes) > 2 or (y_score.ndim == 2 and y_score.shape[1] > 2):
        if multi_class != "ovr" or average != "macro":
            raise ValueError("multiclass ROC AUC is implemented for multi_class='ovr', average='macro'")
        if y_score.ndim != 2:
            raise ValueError(f"`y_score` needs to be of shape (n_samples, n_classes), got {y_score.shape}")
        if not np.allclose(1, y_score.sum(axis=1)):
            raise ValueError("Target scores need to be probabilities for multiclass roc_auc")
        if len(classes) != y_score.shape[1]:
            raise ValueError("Number of classes in y_true not equal to the number of columns in 'y_score'")
        scores = [_binary_roc_auc((y_true == c).astype(int), y_score[:, i]) for i, c in enumerate(classes)]
        return float(np.mean(scores))
    return _binary_roc_auc((y_true == classes[-1]).astype(int), y_score.reshape(-1))
