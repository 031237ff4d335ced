"""Multi-head attention read straight off a packed qkv projection.

Counterpart of ``stamp_tpu.ops.flash_attention.fused_qkv_mha``.  On a CUDA
tensor ``fused_qkv_mha`` launches the hand-written kernel in
``csrc/fused_qkv_attn.cu``; on a CPU tensor it runs the plain PyTorch
version, ``fused_qkv_mha_reference``.  There is no fallback between the two:
a CUDA tensor the kernel does not take raises.  Forward only.

Both follow the Pallas kernel's order of operations: scores q·kᵀ in f32,
scaled by d^-1/2 in f32 after the dot, an exact softmax in f32 (max, exp,
sum, divide), the probabilities cast to the activation dtype before P·V,
P·V accumulated in f32 and cast once.
"""

from __future__ import annotations

import torch

from stamp_tpu_torch.ops import _build

#: kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0

_HEAD_DIMS = (64, 80)  # the kernel's template instances


def fused_qkv_mha_reference(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version: [B, N, 3·H·d] → [B, N, H·d].

    The matmuls run on f32 copies of the inputs, so bf16 operands are
    multiplied exactly and summed in f32, as on the tensor cores."""
    b, n, three_dim = qkv.shape
    dim = three_dim // 3
    head_dim = dim // num_heads
    q, k, v = qkv.reshape(b, n, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4).float()
    scores = torch.matmul(q, k.transpose(-1, -2)) * head_dim**-0.5
    p = torch.softmax(scores, dim=-1).to(qkv.dtype)
    out = torch.matmul(p.float(), v).to(qkv.dtype)  # [B, H, N, d]
    return out.permute(0, 2, 1, 3).reshape(b, n, dim)


def fused_qkv_mha(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Fused multi-head attention over a packed qkv tensor.

    Args:
        qkv: [B, N, 3·dim], lane order [q | k | v], each ``dim`` wide with
            heads contiguous (timm's qkv layout).  On CUDA: bf16,
            contiguous, head_dim = dim / num_heads in (64, 80).
        num_heads: number of heads; dim % num_heads == 0.

    Returns: [B, N, dim] attention output (before the output projection).
    """
    if qkv.device.type == "cpu":
        return fused_qkv_mha_reference(qkv, num_heads)
    if qkv.device.type != "cuda":
        raise ValueError(f"fused_qkv_mha: unsupported device {qkv.device}")
    if qkv.dim() != 3 or qkv.shape[-1] % 3:
        raise ValueError(f"fused_qkv_mha: qkv must be [B, N, 3·dim], got {tuple(qkv.shape)}")
    b, n, three_dim = qkv.shape
    dim = three_dim // 3
    if dim % num_heads:
        raise ValueError(f"fused_qkv_mha: dim {dim} is not a multiple of {num_heads} heads")
    head_dim = dim // num_heads
    if head_dim not in _HEAD_DIMS:
        raise ValueError(
            f"fused_qkv_mha: head_dim {head_dim} has no kernel instance {_HEAD_DIMS}"
        )
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"fused_qkv_mha: the CUDA kernel takes bfloat16, got {qkv.dtype}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("fused_qkv_mha: qkv must be contiguous and 16-byte aligned")
    if not 0 < n or not 0 < b <= 65535 or num_heads > 65535:
        raise ValueError(f"fused_qkv_mha: unsupported shape {tuple(qkv.shape)}")

    out = torch.empty((b, n, dim), dtype=qkv.dtype, device=qkv.device)
    lib = _build.load_library()
    err = lib.stamp_fused_qkv_attn(
        qkv.data_ptr(),
        out.data_ptr(),
        b,
        n,
        num_heads,
        head_dim,
        qkv.device.index,
        torch.cuda.current_stream(qkv.device).cuda_stream,
    )
    _build.check(err, "fused_qkv_mha")
    global LAUNCHES
    LAUNCHES += 1
    return out
