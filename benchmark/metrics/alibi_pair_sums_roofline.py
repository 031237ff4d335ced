"""``pairwise_distance_sums``'s share of its roofline (the spatial-ALiBi
Welford statistic of the MIL model: ``ops/attention.py`` +
``csrc/alibi_stats.cu``), over every call in the window.

Its least time: 6 operations a valid pair (two subtractions, a product, an
FMA, the square root and the weighted add) at the f32 peak, against its
bytes, the coordinates and masks read once (9 bytes a row or key, from
each call's shapes).  The valid pairs are the program's own
``train/alibi_pairs`` counts in the window (Σ (tiles + 1)² of each step's
bags, from the host's sizes: the CLS token counts); a program that makes
no such count reads nothing."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.program import count_total
from benchmark.harness.trace import Wrap

OPS_PER_PAIR = 6.0
BYTES_PER_ROW = 9  # two f32 coordinates and a bool mask


def describe(args: tuple, kwargs: dict) -> dict:
    coords, coords_k = args[0], kwargs.get("coords_k")
    rows = coords.shape[0] * coords.shape[1]
    return {"rows": rows, "keys": rows if coords_k is None else coords_k.shape[0] * coords_k.shape[1]}


WRAPS = (Wrap("stamp_tpu_torch.models.vision_transformer", "pairwise_distance_sums", "alibi_pair_sums", describe),)


def least_seconds(calls: list, pairs: int, peaks: dict) -> float:
    nbytes = BYTES_PER_ROW * sum(c.info["rows"] + c.info["keys"] for c in calls)
    return bound_seconds(nbytes, {"fp32": OPS_PER_PAIR * pairs}, peaks)[0]


def read(trace) -> float | None:
    calls = trace.ops.get("alibi_pair_sums", [])
    pairs = count_total(trace, "train/alibi_pairs")
    device_s = sum(c.device_s for c in calls)
    if not calls or pairs is None or trace.peaks is None or device_s <= 0.0:
        return None
    return 100.0 * least_seconds(calls, pairs, trace.peaks) / device_s
