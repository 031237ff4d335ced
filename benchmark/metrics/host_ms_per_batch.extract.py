"""Host milliseconds inside ``Extractor.forward`` a batch (the extraction
driver's layer: ``preprocessing/extractor/``), the mean over the window's
batches of the benchmark's span around each call.  It includes the
profiler's own cost on the host."""

from __future__ import annotations

SPAN = "bench/Extractor.forward"


def read(trace) -> float | None:
    seconds = trace.span_seconds(SPAN)
    return 1e3 * sum(seconds) / len(seconds) if seconds else None
