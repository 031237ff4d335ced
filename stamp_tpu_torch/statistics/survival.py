"""Survival report: C-index, median/cut-off risk split, log-rank, KM SVGs.

Copy of ``stamp_tpu/statistics/survival.py`` (the estimators of
``survival_util.py`` in place of lifelines); returns the KM SVGs it could
not write (no matplotlib).
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pandas as pd

from stamp_tpu_torch.statistics import plots
from stamp_tpu_torch.statistics.survival_util import concordance_index, logrank_test

RISK_COLUMN = "pred_score"


@dataclass(frozen=True)
class FoldSurvival:
    """One fold's cleaned survival data, split at the risk threshold."""

    time: np.ndarray
    event: np.ndarray
    risk: np.ndarray
    threshold: float  # training-set cut-off if recorded, else median risk

    @classmethod
    def from_predictions(
        cls,
        preds: pd.DataFrame,
        *,
        time_label: str,
        status_label: str,
        cut_off: float | None,
    ) -> "FoldSurvival":
        preds = preds.replace(["NaN", "nan", "None", "Inf", "inf"], np.nan)
        preds = preds.dropna(subset=[time_label, status_label, RISK_COLUMN])
        preds = preds[preds[status_label].isin([0, 1])]
        if not len(preds):
            raise ValueError(
                "No usable survival rows (all NaN or invalid status)."
            )
        risk = preds[RISK_COLUMN].to_numpy(dtype=float)
        return cls(
            time=preds[time_label].to_numpy(dtype=float),
            event=preds[status_label].to_numpy(dtype=int),
            risk=risk,
            threshold=float(cut_off) if cut_off is not None else float(
                np.nanmedian(risk)
            ),
        )

    @property
    def low(self) -> np.ndarray:
        return self.risk <= self.threshold

    @property
    def high(self) -> np.ndarray:
        return self.risk > self.threshold

    def c_index(self) -> float:
        # higher risk ↔ shorter survival, so rank by negated risk
        return float(concordance_index(self.time, -self.risk, self.event))

    def comparable_pairs(self) -> int:
        earlier_event = (self.time[:, None] < self.time[None, :]) & (
            self.event[:, None] == 1
        )
        return int(earlier_event.sum())

    def logrank_p(self) -> float:
        if not (self.low.any() and self.high.any()):
            return float("nan")
        result = logrank_test(
            self.time[self.low],
            self.time[self.high],
            event_observed_A=self.event[self.low],
            event_observed_B=self.event[self.high],
        )
        return float(result.p_value)

    def summary(self) -> pd.Series:
        return pd.Series(
            {
                "c_index": self.c_index(),
                "logrank_p": self.logrank_p(),
                "count": len(self.time),
                "events": int(self.event.sum()),
                "censored": int((self.event == 0).sum()),
                "comparable_pairs": self.comparable_pairs(),
                "threshold": self.threshold,
            }
        )


def _recorded_cut_off(preds: pd.DataFrame) -> float | None:
    """Deploy stores the training cut-off as a ``cut_off=<x>`` marker column
    appended to the CSV (reference deploy.py:687-690)."""
    marker = preds.columns[-1]
    if marker.startswith("cut_off") and "=" in marker:
        return float(marker.split("=", 1)[1])
    return None


def write_survival_report(
    *,
    pred_csvs: list[Path],
    output_dir: Path,
    time_label: str,
    status_label: str,
) -> list[Path]:
    output_dir.mkdir(parents=True, exist_ok=True)

    summaries: dict[str, pd.Series] = {}
    not_written: list[Path] = []
    for csv in pred_csvs:
        preds = pd.read_csv(csv)
        key = f"{Path(csv).parent.name}_{Path(csv).stem}"
        fold = FoldSurvival.from_predictions(
            preds,
            time_label=time_label,
            status_label=status_label,
            cut_off=_recorded_cut_off(preds),
        )
        summaries[key] = fold.summary()

        km_figure = output_dir / "plots" / f"fold_{key}_km_curve.svg"
        if not plots.render_km_figure(
            {
                "Low risk": (fold.time[fold.low], fold.event[fold.low]),
                "High risk": (fold.time[fold.high], fold.event[fold.high]),
            },
            annotations={
                "Log-rank p": fold.logrank_p(),
                "C-index": fold.c_index(),
                "Cut-off": fold.threshold,
            },
            title=f"{key} – Kaplan–Meier Survival Curve",
            out_file=km_figure,
        ):
            not_written.append(km_figure)

    table = pd.DataFrame(summaries).transpose()
    table.index.name = "fold_name"
    table.to_csv(output_dir / "survival-stats_individual.csv", index=True)
    return not_written
