"""The spatial-ALiBi flash backward's share of its roofline (rows 7–8:
``ops/flash_attention.py``'s ``_flash_alibi_backward``, the dQ and dK/dV
kernels of ``csrc/flash_attn_bwd.cu`` and the distance-weighted sum for the
bias branch), over every call in the window.

Counted as ``PERF.md``'s kernel table counts rows 5, 7 and 8, over the
pairs whose work is needed: the queries whose dO is nonzero (the kernels
skip the others' tiles; the last layer's dO is the CLS row's alone) against
the valid keys, per (batch·head).  A pair needs five TF32 products (q·kᵀ
again, dO·vᵀ, Pᵀ·dO, dS·k, dSᵀ·q: 10·d operations) and the f32-accurate
Dᵀ·(scale·dO) (2·d, at the better of the f32 rate and three TF32
products), against the bytes: q, k, v, the softmax output, D·V, dO, the
log-sum-exp, the coordinates and the mask read once, dq, dk, dv written
once.  The pairs are summed on the card when the call returns (one small
reduction over dO, outside the call's span, read after the window)."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    q, k, key_mask, do = args[0], args[1], args[6], args[10]
    bh, tq, d = q.shape
    pairs = (do.ne(0).any(dim=-1).sum(dim=-1) * key_mask.sum(dim=-1)).sum()
    return {"bh": bh, "tq": tq, "tk": k.shape[1], "d": d, "pairs": pairs}


WRAPS = (Wrap("stamp_tpu_torch.ops.flash_attention", "_flash_alibi_backward", "flash_alibi_backward", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    bh, tq, tk, d = info["bh"], info["tq"], info["tk"], info["d"]
    pairs = int(info["pairs"])
    nbytes = 4 * bh * (4 * tq * d + 2 * tk * d + 3 * tq + 2 * tk + 1) + bh * tk + 4 * bh * (tq * d + 2 * tk * d)
    return bound_seconds(nbytes, {"tf32": 10.0 * pairs * d, "fp32_dot": 2.0 * pairs * d}, peaks)[0]


def read(trace) -> float | None:
    return roofline_pct(trace.ops.get("flash_alibi_backward", []), least_seconds, trace.peaks)
