"""Statistics reports over prediction CSVs.

Copy of ``stamp_tpu/statistics/__init__.py`` (``StatsConfig`` field for
field, so that ``StampConfig`` validates the same YAML; ``compute_stats_``
with the same task dispatch, output tree and file names) on the port's
numpy metrics.  Every CSV table is written whether or not matplotlib is
installed; without it the SVG figures are not, and ``compute_stats_`` names
them in one warning.
"""

from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np
import pandas as pd
from pydantic import BaseModel, ConfigDict, Field

from stamp_tpu_torch.types import PandasLabel, Task
from stamp_tpu_torch.utils.figures import warn_not_written

__all__ = ["StatsConfig", "compute_stats_"]


class StatsConfig(BaseModel):
    model_config = ConfigDict(extra="ignore")
    task: Task = Field(default="classification")
    output_dir: Path
    pred_csvs: list[Path]
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None = None
    true_class: str | None = None
    time_label: str | None = None
    status_label: str | None = None


def _read_predictions(csv: Path, **kwargs) -> pd.DataFrame:
    if csv.suffix == ".xlsx":
        return pd.read_excel(csv, **kwargs)
    return pd.read_csv(csv, **kwargs)


def _curves_for_class(
    folds: dict[str, pd.DataFrame],
    *,
    target_label: str,
    cls: str,
    output_dir: Path,
) -> list[Path]:
    """ROC and PR SVGs for one (target, class) pair over all folds; returns
    those not written."""
    from stamp_tpu_torch.statistics import plots

    y_trues, y_scores = [], []
    probability_column = f"{target_label}_{cls}"
    for preds in folds.values():
        if probability_column not in preds.columns:
            continue
        y_trues.append((preds[target_label] == cls).to_numpy())
        y_scores.append(preds[probability_column].astype(float).to_numpy())
    if not y_trues:
        return []

    title = f"{target_label} = {cls}"
    not_written = []
    for family, stem in ((plots.ROC, "roc-curve"), (plots.PR, "pr-curve")):
        out_file = output_dir / f"{stem}_{target_label}={cls}.svg"
        if not plots.render_curve_figure(family, y_trues, y_scores, title=title, out_file=out_file):
            not_written.append(out_file)
    return not_written


def _classification_report(
    *,
    output_dir: Path,
    pred_csvs: Sequence[Path],
    target_labels: Sequence[str],
    classes_per_target: dict[str, list[str] | None],
) -> list[Path]:
    """Curves + score tables for one or many classification targets;
    returns the curve SVGs not written.

    ``classes_per_target[t]`` restricts which classes get curve SVGs
    (single-target mode plots only ``true_class``); ``None`` plots all.
    """
    from stamp_tpu_torch.statistics import categorical

    output_dir.mkdir(parents=True, exist_ok=True)

    available = _read_predictions(Path(pred_csvs[0]), nrows=0).columns
    missing = [t for t in target_labels if t not in available]
    if missing:
        raise ValueError(
            f"Target labels not found in CSV: {missing}. "
            f"Available columns: {list(available)}"
        )

    # parse each fold CSV once, reused across every target; keyed by
    # parent_stem so both crossval (split-i/patient-preds.csv) and deploy
    # ensembles (patient-preds-{0,1}.csv in ONE directory) stay distinct
    all_folds = {
        f"{Path(csv).parent.name}_{Path(csv).stem}": _read_predictions(
            Path(csv), dtype=str
        )
        for csv in pred_csvs
    }

    aggregates: dict[str, pd.DataFrame] = {}
    not_written: list[Path] = []
    for target_label in target_labels:
        folds = {
            fold: preds
            for fold, raw in all_folds.items()
            if len(preds := raw.dropna(subset=[target_label]))
        }
        if not folds:
            continue

        classes = classes_per_target.get(target_label) or sorted(
            np.unique(np.concatenate([f[target_label].to_numpy() for f in folds.values()]))
        )
        for cls in classes:
            not_written += _curves_for_class(
                folds, target_label=target_label, cls=cls, output_dir=output_dir
            )

        tables = {
            fold: categorical.fold_score_table(preds, target_label)
            for fold, preds in folds.items()
        }
        aggregates[target_label] = categorical.write_classification_tables(
            tables, output_dir=output_dir, target_label=target_label
        )

    if not aggregates:
        raise ValueError(
            "No classification rows with ground truth available for statistics."
        )
    if len(target_labels) > 1:
        categorical.write_multitarget_summary(aggregates, output_dir=output_dir)
    return not_written


def compute_stats_(
    *,
    task: Task,
    output_dir: Path,
    pred_csvs: Sequence[Path],
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None = None,
    true_class: str | None = None,
    time_label: str | None = None,
    status_label: str | None = None,
) -> None:
    """Compute and save statistics for the given task's prediction CSVs;
    the figures not written (no matplotlib) are named in one warning."""
    not_written: list[Path] = []
    match task:
        case "classification":
            multitarget = (
                isinstance(ground_truth_label, (list, tuple))
                and len(ground_truth_label) > 1
            )
            if multitarget:
                targets = [str(t) for t in ground_truth_label]  # type: ignore[union-attr]
                not_written = _classification_report(
                    output_dir=output_dir,
                    pred_csvs=pred_csvs,
                    target_labels=targets,
                    classes_per_target={t: None for t in targets},
                )
            else:
                if true_class is None or ground_truth_label is None:
                    raise ValueError(
                        "both true_class and ground_truth_label are required in "
                        "statistic configuration"
                    )
                if not isinstance(ground_truth_label, str):
                    raise ValueError(
                        "ground_truth_label must be a string for single-target "
                        "classification"
                    )
                not_written = _classification_report(
                    output_dir=output_dir,
                    pred_csvs=pred_csvs,
                    target_labels=[ground_truth_label],
                    classes_per_target={ground_truth_label: [true_class]},
                )

        case "regression":
            from stamp_tpu_torch.statistics.regression import write_regression_report

            if ground_truth_label is None:
                raise ValueError(
                    "no ground_truth_label configuration supplied in statistic"
                )
            if not isinstance(ground_truth_label, str):
                raise ValueError(
                    "ground_truth_label must be a string for regression "
                    "(multi-target regression not yet supported)"
                )
            not_written = write_regression_report(
                pred_csvs=pred_csvs,
                output_dir=output_dir,
                ground_truth_label=ground_truth_label,
            )

        case "survival":
            from stamp_tpu_torch.statistics.survival import write_survival_report

            if time_label is None or status_label is None:
                raise ValueError(
                    "both time_label and status_label are required in statistic "
                    "configuration"
                )
            not_written = write_survival_report(
                pred_csvs=[Path(p) for p in pred_csvs],
                output_dir=output_dir,
                time_label=time_label,
                status_label=status_label,
            )
    warn_not_written(not_written)
