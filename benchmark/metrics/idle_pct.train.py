"""The share of the traced training window in which no kernel, copy or
memset ran on the card, in %."""

from __future__ import annotations


def read(trace) -> float | None:
    return trace.idle_pct if trace.window_s > 0 else None
