"""The flash backward with attention dropout: its share of its roofline
(row 5 with keep bits: ``ops/flash_attention.py``'s ``_flash_backward``
given ``keep``, the dropout forms of the dQ and dK/dV kernels of
``csrc/flash_attn_bwd.cu``), over every such call in the window.  Calls
without ``keep`` are left out, and a program whose training never passes
``keep`` gives nothing.

Counted as ``PERF.md``'s kernel table counts row 5, over the pairs whose
work is needed: the queries whose dO is nonzero (the kernels skip the
others' tiles; the last layer's dO is the CLS row's alone) against the
valid keys, per (batch·head).  A pair needs five products (q·kᵀ again,
dO·vᵀ, Pᵀ·dO, dS·k, dSᵀ·q: 10·d operations), each f32-accurate (three
TF32 products: "fp32_dot"), against the bytes: q, k, v, the output, dO,
the log-sum-exp, the mask and the keep bits read once, dq, dk, dv written
once.  The pairs are summed on the card when the call returns (one small
reduction over dO, outside the call's span, read after the window)."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    q, k, key_mask, do = args[0], args[1], args[3], args[6]
    if kwargs.get("keep", args[8] if len(args) > 8 else None) is None:
        return {"keep": False}
    bh, tq, d = q.shape
    pairs = (do.ne(0).any(dim=-1).sum(dim=-1) * key_mask.sum(dim=-1)).sum()
    return {"keep": True, "bh": bh, "tq": tq, "tk": k.shape[1], "d": d, "pairs": pairs}


WRAPS = (Wrap("stamp_tpu_torch.ops.flash_attention", "_flash_backward", "flash_backward", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    bh, tq, tk, d = info["bh"], info["tq"], info["tk"], info["d"]
    pairs = int(info["pairs"])
    words = -(-tk // 32)
    nbytes = 4 * bh * (3 * tq * d + 2 * tk * d + tq + tq * words) + bh * tk + 4 * bh * (tq * d + 2 * tk * d)
    return bound_seconds(nbytes, {"fp32_dot": 10.0 * pairs * d}, peaks)[0]


def read(trace) -> float | None:
    calls = [c for c in trace.ops.get("flash_backward", []) if c.info["keep"]]
    return roofline_pct(calls, least_seconds, trace.peaks)
