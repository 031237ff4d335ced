"""Host milliseconds inside the training step call (the training engine:
``modeling/train.py``, ``parallel/mesh.py``'s ``make_dp_train_step``), the
mean over the window's steps of the benchmark's span around each call.  It
includes the profiler's own cost on the host."""

from __future__ import annotations

SPAN = "bench/step"


def read(trace) -> float | None:
    seconds = trace.span_seconds(SPAN)
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
