"""``ln_dense``'s share of its roofline (row 2: the LayerNorm-fed bf16 GEMMs,
``ops/ln_dense.py`` + ``csrc/ln_dense.cu``), over every call in the window.

A call's least time is its product, 2·M·N·K operations at the peak of the
weight's type, against its bytes: x, the weight, γ, β and the bias read once,
the output written once."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds, dtype_kind
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    x, weight = args[0], args[3]
    k = x.shape[-1]
    partial = kwargs.get("partial", False)
    return {"m": x.numel() // k, "k": k, "n": weight.shape[0], "x_bytes": x.element_size(),
            "w_bytes": weight.element_size(), "out_bytes": 4 if partial else x.element_size(),
            "kind": dtype_kind(weight.dtype)}  # fmt: skip


WRAPS = (Wrap("stamp_tpu_torch.models.vit_image", "ln_dense", "ln_dense", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    m, k, n = info["m"], info["k"], info["n"]
    nbytes = m * k * info["x_bytes"] + n * k * info["w_bytes"] + m * n * info["out_bytes"] + (2 * k + n) * info["w_bytes"]
    return bound_seconds(nbytes, {info["kind"]: 2.0 * m * n * k}, peaks)[0]


def read(trace) -> float | None:
    return roofline_pct(trace.ops.get("ln_dense", []), least_seconds, trace.peaks)
