"""Survival-analysis primitives (concordance index, log-rank test, Kaplan-Meier).

Copy of ``stamp_tpu/statistics/survival_util.py``, the standard estimators
written from their definitions in place of ``lifelines``:

* Harrell's concordance index with lifelines' conventions (higher predicted
  value = longer survival; tied predictions get ½ credit; pairs with tied
  event times where both are events are counted, credited 1 when
  predictions tie and ½ otherwise);
* the two-sample log-rank test (χ², 1 dof);
* the Kaplan-Meier product-limit estimator with at-risk counts for plotting.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy import stats as st


def concordance_index(
    event_times: np.ndarray,
    predicted_scores: np.ndarray,
    event_observed: np.ndarray | None = None,
) -> float:
    """Harrell's C-index.

    Convention (same as lifelines): ``predicted_scores`` where *higher* means
    *longer* expected survival.  Callers with Cox risk scores negate them.
    """
    t = np.asarray(event_times, dtype=float).ravel()
    s = np.asarray(predicted_scores, dtype=float).ravel()
    e = (
        np.ones_like(t, dtype=bool)
        if event_observed is None
        else np.asarray(event_observed).astype(bool).ravel()
    )
    if len(t) != len(s) or len(t) != len(e):
        raise ValueError("inputs must have the same length")

    num_correct = 0.0
    num_pairs = 0.0

    dt = t[:, None] - t[None, :]  # dt[i,j] = t_i - t_j
    ds = np.sign(s[:, None] - s[None, :])

    ei = e[:, None]
    ej = e[None, :]

    # case 1: t_i < t_j and i had the event — j survived longer
    usable = (dt < 0) & ei
    num_pairs += usable.sum()
    num_correct += ((ds < 0) & usable).sum() + 0.5 * ((ds == 0) & usable).sum()

    # case 2: tied times
    tied = dt == 0
    iu = np.triu(np.ones_like(tied), k=1).astype(bool)  # each unordered pair once
    # 2a: both events — credited 1 if predictions tie, else ½
    both_events = tied & ei & ej & iu
    num_pairs += both_events.sum()
    num_correct += ((ds == 0) & both_events).sum() + 0.5 * ((ds != 0) & both_events).sum()
    # 2b: exactly one event — event subject should have lower prediction
    one_event = tied & ei & ~ej
    num_pairs += one_event.sum()
    num_correct += ((ds < 0) & one_event).sum() + 0.5 * ((ds == 0) & one_event).sum()

    if num_pairs == 0:
        raise ZeroDivisionError("No admissible pairs in the dataset.")
    return float(num_correct / num_pairs)


@dataclass
class LogrankResult:
    test_statistic: float
    p_value: float


def logrank_test(
    durations_a: np.ndarray,
    durations_b: np.ndarray,
    event_observed_A: np.ndarray | None = None,
    event_observed_B: np.ndarray | None = None,
) -> LogrankResult:
    """Two-sample log-rank test (χ² with 1 dof)."""
    ta = np.asarray(durations_a, dtype=float).ravel()
    tb = np.asarray(durations_b, dtype=float).ravel()
    ea = (
        np.ones_like(ta, bool)
        if event_observed_A is None
        else np.asarray(event_observed_A).astype(bool).ravel()
    )
    eb = (
        np.ones_like(tb, bool)
        if event_observed_B is None
        else np.asarray(event_observed_B).astype(bool).ravel()
    )

    event_times = np.unique(np.concatenate([ta[ea], tb[eb]]))
    if len(event_times) == 0 or len(ta) == 0 or len(tb) == 0:
        return LogrankResult(np.nan, np.nan)

    obs_a = 0.0
    exp_a = 0.0
    var_a = 0.0
    for tau in event_times:
        n_a = float((ta >= tau).sum())
        n_b = float((tb >= tau).sum())
        d_a = float(((ta == tau) & ea).sum())
        d_b = float(((tb == tau) & eb).sum())
        n = n_a + n_b
        d = d_a + d_b
        if n <= 1:
            continue
        obs_a += d_a
        exp_a += d * n_a / n
        var_a += d * (n_a / n) * (n_b / n) * (n - d) / (n - 1)

    if var_a <= 0:
        return LogrankResult(np.nan, np.nan)
    chi2 = (obs_a - exp_a) ** 2 / var_a
    p = float(st.chi2.sf(chi2, df=1))
    return LogrankResult(float(chi2), p)


@dataclass
class KaplanMeier:
    """Product-limit estimator with the bits needed for KM plots."""

    timeline: np.ndarray  # event/censoring times (sorted, unique, with 0)
    survival: np.ndarray  # S(t) at each timeline point
    at_risk: np.ndarray  # number at risk just before each timeline point
    label: str = ""

    @classmethod
    def fit(
        cls,
        durations: np.ndarray,
        event_observed: np.ndarray | None = None,
        label: str = "",
    ) -> "KaplanMeier":
        t = np.asarray(durations, dtype=float).ravel()
        e = (
            np.ones_like(t, bool)
            if event_observed is None
            else np.asarray(event_observed).astype(bool).ravel()
        )
        order = np.argsort(t, kind="stable")
        t, e = t[order], e[order]

        timeline = np.unique(np.concatenate([[0.0], t]))
        surv = np.empty_like(timeline)
        risk = np.empty_like(timeline)
        s = 1.0
        for i, tau in enumerate(timeline):
            at_risk = (t >= tau).sum()
            d = ((t == tau) & e).sum()
            risk[i] = at_risk
            if tau > 0 and at_risk > 0 and d > 0:
                s *= 1.0 - d / at_risk
            surv[i] = s
        return cls(timeline=timeline, survival=surv, at_risk=risk, label=label)

    def at_risk_at(self, times: np.ndarray) -> np.ndarray:
        """Number at risk at each of `times` (step lookup)."""
        idx = np.searchsorted(self.timeline, times, side="left")
        idx = np.clip(idx, 0, len(self.timeline) - 1)
        return self.at_risk[idx]

    def plot(self, ax, *, color: str | None = None):
        ax.step(
            self.timeline,
            self.survival,
            where="post",
            color=color,
            label=self.label,
        )
        return ax
