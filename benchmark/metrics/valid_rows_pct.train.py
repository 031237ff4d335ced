"""The share of the rows the MIL backbone computes that are tiles, not
padding (the training engine: ``modeling/train.py``'s ``forward_batch``),
in %: 100 × the port's ``train/tiles`` counts (each bag's valid tiles) over
its ``train/rows`` counts (B·T of each bag handed to the backbone) in the
window.  Whole-slide bags padded to their bucket read below 100."""

from __future__ import annotations

from benchmark.harness.program import count_total


def read(trace) -> float | None:
    tiles, rows = count_total(trace, "train/tiles"), count_total(trace, "train/rows")
    return 100.0 * tiles / rows if tiles is not None and rows else None
