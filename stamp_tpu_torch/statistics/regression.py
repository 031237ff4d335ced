"""Regression report: per-fold scores, scatter SVGs, Student-t aggregate.

Copy of ``stamp_tpu/statistics/regression.py``; returns the scatter SVGs it
could not write (no matplotlib).
"""

from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

import numpy as np
import pandas as pd

from stamp_tpu_torch.statistics import core, plots


def write_regression_report(
    *,
    pred_csvs: Sequence[Path],
    output_dir: Path,
    ground_truth_label: str,
) -> list[Path]:
    output_dir.mkdir(parents=True, exist_ok=True)

    per_fold: dict[str, dict[str, float]] = {}
    not_written: list[Path] = []
    for csv in pred_csvs:
        # parent_stem like the survival report: crossval folds all name their
        # CSV patient-preds.csv, so the stem alone would collide (the
        # reference keys by stem and silently overwrites, regression.py:59)
        fold = f"{Path(csv).parent.name}_{Path(csv).stem}"
        preds = pd.read_csv(csv).dropna(subset=[ground_truth_label, "pred"])
        y_true = preds[ground_truth_label].to_numpy(dtype=float)
        y_pred = preds["pred"].to_numpy(dtype=float)

        per_fold[fold] = core.regression_scores(y_true, y_pred)
        scatter = output_dir / "plots" / f"fold_{fold}_scatter.svg"
        if not plots.render_regression_scatter(
            y_true,
            y_pred,
            per_fold[fold],
            x_label=ground_truth_label,
            title=fold,
            out_file=scatter,
        ):
            not_written.append(scatter)

    individual = pd.DataFrame(per_fold).transpose()
    individual.to_csv(
        output_dir / f"{ground_truth_label}_regression-stats_individual.csv"
    )

    ci = {
        metric: core.students_t_ci(individual[metric].to_numpy(dtype=float))
        for metric in individual.columns
    }
    aggregated = pd.DataFrame(
        {
            "mean": {m: v[0] for m, v in ci.items()},
            "95%_low": {m: v[1] for m, v in ci.items()},
            "95%_high": {m: v[2] for m, v in ci.items()},
        }
    ).reindex(np.asarray(individual.columns))
    aggregated.to_csv(
        output_dir / f"{ground_truth_label}_regression-stats_aggregated.csv"
    )
    return not_written
