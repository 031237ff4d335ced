"""Classification report tables.

Copy of ``stamp_tpu/statistics/categorical.py``: per-fold one-vs-rest score
tables plus a Student-t aggregate across folds (a single fold yields a CI
collapsed onto the mean), on the scorers in ``core.py``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

from stamp_tpu_torch.statistics import core

_AGGREGATED_METRICS = ("roc_auc_score", "average_precision_score", "f1_score")


def fold_score_table(preds: pd.DataFrame, target_label: str) -> pd.DataFrame:
    """One fold's per-class score table, indexed by class."""
    classes = np.sort(preds[target_label].unique())
    probabilities = (
        preds[[f"{target_label}_{c}" for c in classes]].astype(float).to_numpy()
    )
    scores = core.one_vs_rest_scores(
        preds[target_label].to_numpy(), probabilities, classes
    )
    return pd.DataFrame.from_dict(scores, orient="index")[list(core.SCORE_COLUMNS)]


def aggregate_over_folds(per_fold: pd.DataFrame) -> pd.DataFrame:
    """Collapse a (fold, class)-indexed score table to one row per class.

    Columns are a (metric, statistic) MultiIndex — mean and 95% Student-t
    bounds per metric, plus the total sample count.
    """
    rows: dict[str, dict[tuple[str, str], float]] = {}
    for cls, fold_scores in per_fold.groupby(level=1):
        row: dict[tuple[str, str], float] = {}
        for metric in _AGGREGATED_METRICS:
            mean, lower, upper = core.students_t_ci(
                fold_scores[metric].to_numpy(dtype=float)
            )
            row[(metric, "mean")] = mean
            row[(metric, "95%_low")] = lower
            row[(metric, "95%_high")] = upper
        row[("count", "sum")] = fold_scores["count"].astype(float).sum()
        rows[str(cls)] = row
    return pd.DataFrame.from_dict(rows, orient="index")


def write_classification_tables(
    fold_tables: dict[str, pd.DataFrame],
    *,
    output_dir: Path,
    target_label: str,
) -> pd.DataFrame:
    """Write the individual and aggregated CSVs for one target; returns the
    aggregate (used for the multi-target summary)."""
    output_dir.mkdir(parents=True, exist_ok=True)

    individual = pd.concat(fold_tables).sort_index()
    individual.to_csv(output_dir / f"{target_label}_categorical-stats_individual.csv")

    aggregated = aggregate_over_folds(individual)
    aggregated.to_csv(output_dir / f"{target_label}_categorical-stats_aggregated.csv")
    return aggregated


def write_multitarget_summary(
    aggregates: dict[str, pd.DataFrame], *, output_dir: Path
) -> None:
    """One summary CSV stacking every target's aggregate table
    (reference categorical.py:119-129)."""
    if not aggregates:
        return
    stacked = []
    for target, table in aggregates.items():
        table = table.copy()
        table.index = pd.MultiIndex.from_product(
            [[target], table.index], names=["target", "class"]
        )
        stacked.append(table)
    pd.concat(stacked).to_csv(output_dir / "multitarget_categorical-stats_summary.csv")
