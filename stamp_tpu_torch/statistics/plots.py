"""All matplotlib rendering for the statistics reports.

Copy of ``stamp_tpu/statistics/plots.py``: one generic curve renderer
parameterised per curve family plus the regression scatter and Kaplan-Meier
figures.  matplotlib is imported inside the renderers only
(``utils.figures.pyplot``); where it is not installed each renderer writes
nothing and returns False, and the report names the figure in its warning.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from stamp_tpu_torch.statistics import core
from stamp_tpu_torch.statistics.survival_util import KaplanMeier
from stamp_tpu_torch.utils.figures import pyplot

FIGURE_WIDTH_INCHES = 3.8
CURVE_ASPECT = 1.08
N_BOOTSTRAP = 1000


@dataclass(frozen=True)
class CurveFamily:
    """How to render one kind of classifier curve (ROC or PR)."""

    short_name: str  # in the legend/title: "AUC" / "PRC"
    title_stat: str  # in the single-fold title: "AUROC" / "AUPRC"
    x_label: str
    y_label: str
    points: Callable[[np.ndarray, np.ndarray], core.Curve]

    def reference_line(self, ax, y_trues: Sequence[np.ndarray]) -> None:
        raise NotImplementedError


class _RocFamily(CurveFamily):
    def reference_line(self, ax, y_trues):
        ax.plot([0, 1], [0, 1], "r--")  # chance diagonal


class _PrFamily(CurveFamily):
    def reference_line(self, ax, y_trues):
        pooled = np.concatenate(list(y_trues))
        prevalence = pooled.sum() / len(pooled)
        ax.plot([0, 1], [prevalence, prevalence], "r--")


ROC = _RocFamily(
    short_name="AUC",
    title_stat="AUROC",
    x_label="False Positive Rate",
    y_label="True Positive Rate",
    points=core.roc_points,
)
PR = _PrFamily(
    short_name="PRC",
    title_stat="AUPRC",
    x_label="Recall",
    y_label="Precision",
    points=core.pr_points,
)


def render_curve_figure(
    family: CurveFamily,
    y_trues: Sequence[np.ndarray],
    y_scores: Sequence[np.ndarray],
    *,
    title: str,
    out_file: Path,
) -> bool:
    """One decorated SVG: bootstrapped band for a single fold, one curve per
    fold (sorted best-first, Student-t CI of the mean score in the title)
    for multiple folds.  Mirrors reference roc.py:19-124 / prc.py:50-115.
    Returns whether it was written.
    """
    plt = pyplot()
    if plt is None:
        return False

    fig, ax = plt.subplots(
        figsize=(FIGURE_WIDTH_INCHES, FIGURE_WIDTH_INCHES * CURVE_ASPECT), dpi=300
    )

    curves = [family.points(t, s) for t, s in zip(y_trues, y_scores)]

    if len(curves) == 1:
        curve = curves[0]
        band = core.bootstrap_band(
            y_trues[0], y_scores[0], family.points, n_samples=N_BOOTSTRAP
        )
        ax.fill_between(band.grid, band.y_lower, band.y_upper, alpha=0.5)
        ax.plot(curve.x, curve.y, label=f"{family.short_name} = {curve.score:0.2f}")
        stat_line = (
            f"{family.title_stat} = {curve.score:.2f} "
            f"[{band.score_lower:.2f}-{band.score_upper:.2f}]"
        )
    else:
        for curve in sorted(curves, key=lambda c: c.score, reverse=True):
            ax.plot(curve.x, curve.y, label=f"{family.short_name} = {curve.score:0.2f}")
        ax.legend(loc="lower right")
        mean, lower, upper = core.students_t_ci(np.array([c.score for c in curves]))
        lower, upper = max(0.0, lower), min(1.0, upper)
        stat_line = f"{family.short_name} = {mean:0.2f} [{lower:0.2f}-{upper:0.2f}]"

    family.reference_line(ax, y_trues)
    ax.set_aspect("equal")
    ax.set_xlabel(family.x_label)
    ax.set_ylabel(family.y_label)
    ax.set_title(f"{title}\n{stat_line}")

    fig.tight_layout()
    out_file.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return True


def render_regression_scatter(
    y_true: np.ndarray,
    y_pred: np.ndarray,
    scores: dict[str, float],
    *,
    x_label: str,
    title: str,
    out_file: Path,
) -> bool:
    """Truth-vs-prediction scatter with a least-squares line ± its standard
    error and an R²/Pearson annotation (reference regression.py:50-116).
    Returns whether it was written."""
    import scipy.stats as st

    plt = pyplot()
    if plt is None:
        return False

    fig, ax = plt.subplots(figsize=(3.2, 3.2), dpi=300)
    ax.scatter(y_true, y_pred, color="black", s=15)

    fit = st.linregress(y_true, y_pred)
    line_x = np.linspace(y_true.min(), y_true.max(), 100)
    line_y = fit.intercept + fit.slope * line_x
    ax.plot(line_x, line_y, color="royalblue", linewidth=1.5)
    ax.fill_between(
        line_x,
        line_y - fit.stderr,
        line_y + fit.stderr,
        color="royalblue",
        alpha=0.2,
    )

    ax.set_xlabel(x_label)
    ax.set_ylabel("Prediction")
    ax.set_title(title)
    ax.text(
        0.05,
        0.95,
        (
            rf"$R^2$={scores['r2_score']:.2f} | "
            rf"Pearson R={scores['pearson_r']:.2f}"
            "\n"
            rf"$p$={scores['pearson_p']:.1e}"
        ),
        ha="left",
        va="top",
        transform=ax.transAxes,
        fontsize=8,
    )

    fig.tight_layout()
    out_file.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file)
    plt.close(fig)
    return True


def render_km_figure(
    groups: dict[str, tuple[np.ndarray, np.ndarray]],  # label -> (time, event)
    *,
    annotations: dict[str, float],  # "Log-rank p" / "C-index" / "Cut-off"
    title: str,
    out_file: Path,
) -> bool:
    """Kaplan-Meier curves per risk group with an at-risk table and a stats
    box (reference survival.py:60-181).  Returns whether it was written."""
    plt = pyplot()
    if plt is None:
        return False

    fig, ax = plt.subplots(figsize=(8, 6))

    colors = {"Low risk": "blue", "High risk": "red"}
    fitted: list[KaplanMeier] = []
    for label, (time, event) in groups.items():
        if len(time) == 0:
            continue
        km = KaplanMeier.fit(time, event, label=label)
        km.plot(ax, color=colors.get(label))
        fitted.append(km)

    if fitted:
        ticks = np.linspace(0.0, max(km.timeline.max() for km in fitted), 6)
        risk_rows = [
            f"{km.label}: " + "  ".join(str(int(c)) for c in km.at_risk_at(ticks))
            for km in fitted
        ]
        ax.text(
            0.0,
            -0.18,
            "At risk\n" + "\n".join(risk_rows),
            transform=ax.transAxes,
            fontsize=9,
            va="top",
        )

    box_lines = []
    for name, value in annotations.items():
        fmt = ".4e" if name == "Log-rank p" else ".3f"
        box_lines.append(f"{name} = {value:{fmt}}")
    ax.text(
        0.6,
        0.08,
        "\n".join(box_lines),
        transform=ax.transAxes,
        fontsize=11,
        bbox=dict(facecolor="white", edgecolor="black", boxstyle="round,pad=0.3"),
    )

    ax.set_title(title, fontsize=13, weight="bold")
    ax.set_xlabel("Time")
    ax.set_ylabel("Survival probability")
    ax.grid(True, linestyle="--", alpha=0.6)
    ax.set_ylim(0, 1)
    ax.legend()
    fig.tight_layout()

    out_file.parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_file, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return True
