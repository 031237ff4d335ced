"""Host milliseconds of ``Extractor.forward``'s upload a batch (the
extraction driver's layer: ``preprocessing/extractor/``), the mean self
time of the port's own ``extract/upload`` spans in the window: the copy of
the uint8 batch to the card and its pad, including the wait of a blocking
copy behind the work queued before it.  It includes the profiler's own
cost on the host."""

from __future__ import annotations

from benchmark.harness.program import mean_self_ms

SPAN = "extract/upload"


def read(trace) -> float | None:
    return mean_self_ms(trace, SPAN)
