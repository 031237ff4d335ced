"""Harrell's concordance index.

Copy of ``concordance_index`` from ``stamp_tpu/statistics/survival_util.py``
(lifelines' conventions: higher predicted value = longer survival; tied
predictions get ½ credit; pairs with tied event times where both are events
are counted, credited 1 when predictions tie and ½ otherwise).  The
log-rank test and Kaplan-Meier estimator of that module belong to
``statistics``, which is not ported yet.
"""

from __future__ import annotations

import numpy as np


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
