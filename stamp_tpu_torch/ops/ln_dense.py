"""LayerNorm fused into the matmul that consumes it.

Counterpart of ``stamp_tpu.ops.ln_dense.ln_dense``: every pre-LN block of
the extractor ViTs feeds a LayerNorm straight into a matmul (norm1→qkv,
norm2→fc1 and SwiGLU's inner norm→fc2).  On a CUDA tensor ``ln_dense``
launches the hand-written kernel in ``csrc/ln_dense.cu``, which never writes
the normalized activation to device memory; on a CPU tensor it runs the
plain PyTorch version, ``ln_dense_reference``.  There is no fallback between
the two: a CUDA tensor the kernel does not take raises.  Unlike the TPU
kernel there is no tile gate — every row count launches.  Forward only.
"""

from __future__ import annotations

import torch

from stamp_tpu_torch.ops import _build

#: kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0


def ln_dense_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    weight: torch.Tensor,
    dense_bias: torch.Tensor | None = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's semantics on ``x [M, K]``:
    LayerNorm in f32 (two-pass mean and variance), cast to ``x.dtype``,
    a matmul with f32 accumulation against ``weight [N, K]``, the dense bias
    added in f32, one cast to ``x.dtype``."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    y = (c * torch.rsqrt(var + eps) * scale.float() + bias.float()).to(x.dtype)
    acc = torch.matmul(y.float(), weight.to(x.dtype).float().t())
    if dense_bias is not None:
        acc = acc + dense_bias.float()
    return acc.to(x.dtype)


def ln_dense(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    weight: torch.Tensor,
    dense_bias: torch.Tensor | None = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``LayerNorm(x; scale, bias) @ weight.T + dense_bias`` as one kernel.

    ``x``: [..., K]; ``scale``/``bias``: [K] LayerNorm parameters;
    ``weight``: [N, K] in ``nn.Linear``'s layout (the transpose of the JAX
    kernel's [K, N]); ``dense_bias``: [N] or None.  Returns [..., N].  On
    CUDA every tensor is bfloat16, contiguous and 16-byte aligned, and K is
    a multiple of 8.
    """
    k = x.shape[-1]
    n = weight.shape[0]
    x2d = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = ln_dense_reference(x2d, scale, bias, weight, dense_bias, eps=eps)
        return out.reshape(*x.shape[:-1], n)
    if x.device.type != "cuda":
        raise ValueError(f"ln_dense: unsupported device {x.device}")
    m = x2d.shape[0]
    tensors = {"x": x, "scale": scale, "bias": bias, "weight": weight}
    if dense_bias is not None:
        tensors["dense_bias"] = dense_bias
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"ln_dense: {name} is on {t.device}, x on {x.device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"ln_dense: the CUDA kernel takes bfloat16, {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_dense: {name} must be contiguous and 16-byte aligned")
    if tuple(weight.shape) != (n, k) or scale.shape != (k,) or bias.shape != (k,):
        raise ValueError(
            f"ln_dense: shapes x {tuple(x.shape)}, weight {tuple(weight.shape)}, "
            f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)} do not match"
        )
    if dense_bias is not None and dense_bias.shape != (n,):
        raise ValueError(f"ln_dense: dense_bias must be [{n}], got {tuple(dense_bias.shape)}")
    if k % 8 or not 0 < m <= 65535 * 128 or n <= 0:  # grid.y: 128-row blocks
        raise ValueError(f"ln_dense: unsupported shape M={m}, K={k}, N={n}")

    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    lib = _build.load_library()
    err = lib.stamp_ln_dense(
        x2d.data_ptr(),
        scale.data_ptr(),
        bias.data_ptr(),
        weight.data_ptr(),
        None if dense_bias is None else dense_bias.data_ptr(),
        out.data_ptr(),
        m,
        n,
        k,
        eps,
        x.device.index,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "ln_dense")
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)
