"""The spatial-ALiBi flash forward's share of its roofline (row 6:
``ops/flash_attention.py``'s ``_flash_alibi_forward`` + ``csrc/flash_attn.cu``
and the distance-weighted sum of ``csrc/flash_attn_bwd.cu``), over every
call in the window.

Counted as ``PERF.md``'s kernel table counts rows 4–8, over the valid keys:
a call over q [BH, Q, d] with V valid keys in all (``key_mask``, summed
per (batch·head)) needs q·kᵀ and P·V, 4·Q·V·d TF32 operations, and D·V,
2·Q·V·d f32-accurate ones (at the better of the f32 rate and three TF32
products), against its bytes: q, k, v, the coordinates, the scale and the
mask read once, the output, the softmax output, D·V and the log-sum-exp
written once.  The valid keys are summed on the card when the call returns
(one small reduction, outside the call's span, read after the window)."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    q, k, key_mask = args[0], args[1], args[6]
    bh, tq, d = q.shape
    return {"bh": bh, "tq": tq, "tk": k.shape[1], "d": d, "valid_keys": key_mask.sum()}


WRAPS = (Wrap("stamp_tpu_torch.ops.flash_attention", "_flash_alibi_forward", "flash_alibi_forward", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    bh, tq, tk, d = info["bh"], info["tq"], info["tk"], info["d"]
    pairs = tq * int(info["valid_keys"])
    nbytes = 4 * bh * (tq * d + 2 * tk * d + 2 * tq + 2 * tk + 1) + bh * tk + 4 * bh * (3 * tq * d + tq)
    return bound_seconds(nbytes, {"tf32": 4.0 * pairs * d, "fp32_dot": 2.0 * pairs * d}, peaks)[0]


def read(trace) -> float | None:
    return roofline_pct(trace.ops.get("flash_alibi_forward", []), least_seconds, trace.peaks)
