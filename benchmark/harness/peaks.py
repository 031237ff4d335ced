"""Peak rates of the card and the least time a piece of work needs.

The peaks are NVIDIA's data-sheet figures for the H100 SXM (dense, without
sparsity), at the card's full power limit of 700 W; a result line names the
card and its power limit beside every share of them.  ``bound_seconds`` is
the rule of ``chip_smoke.py``'s ``_bound``: the larger of the bytes over the
memory rate and the operations over the peak rate of their type (summed
over types), where an f32-accurate product ("fp32_dot") counts at the better
of the f32 rate and three TF32 products.
"""

from __future__ import annotations

#: card name (as ``torch.cuda.get_device_name`` gives it, matched as a part of it) → peaks
CARDS: dict[str, dict] = {
    "H100 80GB HBM3": {
        "bytes_per_s": 3.35e12,
        "flops": {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12, "fp8": 1979e12},
    },
}


def card_peaks(card_name: str) -> dict | None:
    """The peaks of the card named ``card_name``, or None for a card the table lacks."""
    return next((peaks for key, peaks in CARDS.items() if key in card_name), None)


def _op_seconds(kind: str, n: float, flops: dict[str, float]) -> float:
    if kind == "fp32_dot":
        return min(n / flops["fp32"], 3 * n / flops["tf32"])
    return n / flops[kind]


def bound_seconds(nbytes: float, ops: dict[str, float], peaks: dict) -> tuple[float, str]:
    """(least seconds the card could take, "bytes" or "operations"): ``nbytes``
    moved once, ``ops`` operations by type ("bf16", "int8", "tf32", ...)."""
    t_bytes = nbytes / peaks["bytes_per_s"]
    t_ops = sum(_op_seconds(kind, n, peaks["flops"]) for kind, n in ops.items())
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dtype_kind(dtype) -> str:
    """The peak a product of operands of ``dtype`` runs at: "bf16", "fp16",
    "int8", "fp8", or "tf32" for float32 (the fastest rate an f32 product
    reaches on the tensor cores)."""
    name = str(dtype).removeprefix("torch.")
    return {"bfloat16": "bf16", "float16": "fp16", "int8": "int8", "float8_e4m3fn": "fp8",
            "float8_e5m2": "fp8", "float32": "tf32"}[name]  # fmt: skip
