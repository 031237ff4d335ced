"""Host milliseconds of the spatial-ALiBi distance statistic a step (the
training engine: ``models/vision_transformer.py``'s forward, once a
training step), the mean self time of the port's own ``train/alibi_stats``
spans in the window: the launch of ``pairwise_distance_sums`` (on the card
one kernel, ``csrc/alibi_stats.cu``), the division and, in a step over a
mesh, the sums over ranks.  A program without the span reads nothing.  It
includes the profiler's own cost on the host."""

from __future__ import annotations

from benchmark.harness.program import mean_self_ms

SPAN = "train/alibi_stats"


def read(trace) -> float | None:
    return mean_self_ms(trace, SPAN)
