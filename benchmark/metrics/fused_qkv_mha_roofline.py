"""``fused_qkv_mha``'s share of its roofline (row 1: the extractor towers'
attention off the packed qkv projection, ``ops/flash_attention.py`` +
``csrc/fused_qkv_attn.cu``), over every call in the window.

A call over qkv [B, N, 3·dim] with H heads needs two products over every
(query, key) pair, 4·B·N²·dim operations at the peak of qkv's type, against
its bytes: qkv read once, the [B, N, dim] output written once."""

from __future__ import annotations

from benchmark.harness.peaks import bound_seconds, dtype_kind
from benchmark.harness.trace import Wrap, roofline_pct


def describe(args: tuple, kwargs: dict) -> dict:
    qkv = args[0]
    b, n, three_dim = qkv.shape
    return {"b": b, "n": n, "dim": three_dim // 3, "bytes": qkv.element_size(), "kind": dtype_kind(qkv.dtype)}


WRAPS = (Wrap("stamp_tpu_torch.models.vit_image", "fused_qkv_mha", "fused_qkv_mha", describe),)


def least_seconds(info: dict, peaks: dict) -> float:
    b, n, dim = info["b"], info["n"], info["dim"]
    nbytes = 4 * b * n * dim * info["bytes"]  # q, k, v in, the output out
    return bound_seconds(nbytes, {info["kind"]: 4.0 * b * n * n * dim}, peaks)[0]


def read(trace) -> float | None:
    return roofline_pct(trace.ops.get("fused_qkv_mha", []), least_seconds, trace.peaks)
