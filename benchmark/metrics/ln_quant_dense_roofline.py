"""``ln_quant_dense``'s share of its roofline (row 3: the LayerNorm-fed W8A8
GEMMs, ``ops/ln_dense.py`` + ``csrc/ln_quant_dense.cu``), over every call in
the window.

A call's least time is its product, 2·M·N·K int8 operations, against its
bytes: the bf16 x, the int8 weight, its f32 scales, γ, β and the bias read
once, the output written once."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds, dtype_kind
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    x, weight_q = args[0], args[4]
    k = x.shape[-1]
    partial = kwargs.get("partial", False)
    return {"m": x.numel() // k, "k": k, "n": weight_q.shape[0], "x_bytes": x.element_size(),
            "out_bytes": 4 if partial else x.element_size(), "kind": dtype_kind(weight_q.dtype)}  # fmt: skip


WRAPS = (Wrap("stamp_tpu_torch.models.vit_image", "ln_quant_dense", "ln_quant_dense", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    m, k, n = info["m"], info["k"], info["n"]
    nbytes = m * k * info["x_bytes"] + n * k + m * n * info["out_bytes"] + 2 * k * info["x_bytes"] + n * (4 + info["x_bytes"])
    return bound_seconds(nbytes, {info["kind"]: 2.0 * m * n * k}, peaks)[0]


def read(trace) -> float | None:
    return roofline_pct(trace.ops.get("ln_quant_dense", []), least_seconds, trace.peaks)
