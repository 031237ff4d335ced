"""The program's own spans and counts inside the traced window.

While a ``torch.profiler`` runs, the port records spans and counts
(``stamp_tpu_torch.utils.profiling``) stamped on ``time.time_ns()``'s
clock, the host clock the profiler stamps its events with.  So the
benchmark's ``bench/window`` span, as the trace holds it, selects them: a
reader keeps the spans that start and end inside it and the counts made
inside it.  A port that keeps no such records gives none, and the metric
that reads them is left out of the line.
"""

from __future__ import annotations

from typing import NamedTuple

from benchmark.harness.trace import WINDOW_SPAN


class Records(NamedTuple):
    spans: list  # the port's ``Span``s: name, start_ns, end_ns, parent, root, thread, self_ns
    counts: list  # its ``Count``s: time_ns, name, n


def in_window(trace) -> Records | None:
    """The port's records inside the window, or None where there are none."""
    window = next(((s, e) for s, e, n in trace.spans if n == WINDOW_SPAN), None)
    from stamp_tpu_torch.utils import profiling

    records = getattr(profiling, "records", None)
    if window is None or records is None:
        return None
    w0, w1 = window
    spans, counts = [], []
    for r in records():
        if hasattr(r, "self_ns"):
            if w0 <= r.start_ns and r.end_ns <= w1:
                spans.append(r)
        elif w0 <= r.time_ns <= w1:
            counts.append(r)
    return Records(spans, counts) if spans or counts else None


def mean_self_ms(trace, name: str) -> float | None:
    """The mean self time, in ms, of the port's spans called ``name`` in the window."""
    found = in_window(trace)
    selfs = [s.self_ns for s in found.spans if s.name == name] if found else []
    return 1e-6 * sum(selfs) / len(selfs) if selfs else None


def count_total(trace, name: str) -> int | None:
    """The sum of the port's counts called ``name`` in the window, or None where it made none."""
    found = in_window(trace)
    ns = [c.n for c in found.counts if c.name == name] if found else []
    return sum(ns) if ns else None
