"""The flash forward with attention dropout: its share of its roofline
(row 4 with keep bits: ``ops/flash_attention.py``'s ``_flash_forward``
given ``keep``, which runs the pack of the draws into keep bits and the
dropout forward of ``csrc/flash_attn.cu``), over every such call in the
window.  Calls without ``keep`` are left out, and a program whose training
never passes ``keep`` gives nothing.

Counted as ``PERF.md``'s kernel table counts row 4, over the valid keys: a
call over q [BH, Q, d] with V valid keys in all (``key_mask``, summed per
(batch·head)) needs q·kᵀ and P·V, 4·Q·V·d operations, each f32-accurate
(three TF32 products: "fp32_dot"), against its bytes: the draws of the
valid pairs (4 B each) read by the pack, q, k, v and the mask read once,
the keep bits, the output and the log-sum-exp written once.  The valid
keys are summed on the card when the call returns (one small reduction,
outside the call's span, read after the window)."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    q, k, key_mask = args[0], args[1], args[3]
    if kwargs.get("keep", args[5] if len(args) > 5 else None) is None:
        return {"keep": False}
    bh, tq, d = q.shape
    return {"keep": True, "bh": bh, "tq": tq, "tk": k.shape[1], "d": d, "valid_keys": key_mask.sum()}


WRAPS = (Wrap("stamp_tpu_torch.ops.flash_attention", "_flash_forward", "flash_forward", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    bh, tq, tk, d = info["bh"], info["tq"], info["tk"], info["d"]
    pairs = tq * int(info["valid_keys"])
    words = -(-tk // 32)
    nbytes = 4 * pairs + 4 * bh * (tq * d + 2 * tk * d) + bh * tk + 4 * bh * (tq * words + tq * d + tq)
    return bound_seconds(nbytes, {"fp32_dot": 4.0 * pairs * d}, peaks)[0]


def read(trace) -> float | None:
    calls = [c for c in trace.ops.get("flash_forward", []) if c.info["keep"]]
    return roofline_pct(calls, least_seconds, trace.peaks)
