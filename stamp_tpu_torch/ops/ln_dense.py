"""LayerNorm fused into the matmul that consumes it.

Counterpart of ``stamp_tpu.ops.ln_dense.ln_dense``: every pre-LN block of
the extractor ViTs feeds a LayerNorm straight into a matmul (norm1→qkv,
norm2→fc1 and SwiGLU's inner norm→fc2).  On a CUDA tensor ``ln_dense``
launches the hand-written Hopper kernels in ``csrc/ln_dense.cu`` (row
statistics, then a TMA-fed wgmma GEMM that applies the LayerNorm to its A
operand in registers: the normalized activation never reaches device
memory); on a CPU tensor it runs the plain PyTorch version,
``ln_dense_reference``.  There is no fallback between the two: a CUDA tensor
the kernel does not take raises.  Unlike the TPU kernel there is no tile
gate — every row count launches.  Forward only.

``ln_quant_dense`` is the int8 (W8A8) counterpart,
``stamp_tpu.ops.ln_dense.ln_quant_dense``: LayerNorm, static per-tensor
int8 quantization, an int8 matmul with exact i32 sums and an f32 dequantize,
as the kernel in ``csrc/ln_quant_dense.cu`` on a CUDA tensor and as
``ln_quant_dense_reference`` on a CPU tensor.  Its JAX VJP (the plain
formulation differentiated, the quantize blocking the gradient to x) is not
ported: the int8 extractor runs inference only.
"""

from __future__ import annotations

import torch

from stamp_tpu_torch.ops import _build

#: kernel launches since the last reset (the main path's proof of use)
LAUNCHES = 0


def layer_norm_f32(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis in f32 (two-pass mean and variance), as
    the JAX package's kernels and their references compute it."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


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
    y = layer_norm_f32(x, scale, bias, eps).to(x.dtype)
    acc = torch.matmul(y.float(), weight.to(x.dtype).float().t())
    if dense_bias is not None:
        acc = acc + dense_bias.float()
    return acc.to(x.dtype)


def _check_shape(what: str, m: int, k: int, n: int) -> None:
    """Raise on a shape the kernels do not take: TMA needs 16-byte rows of
    the bf16 x [M, K]."""
    if k % 8 or m <= 0 or n <= 0:
        raise ValueError(f"{what}: unsupported shape M={m}, K={k}, N={n}")


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
    _check_shape("ln_dense", m, k, n)

    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    scratch = torch.empty(2 * k + 2 * m, dtype=torch.float32, device=x.device)  # f32 γ, β; row μ, 1/σ
    err = _build.load_library().stamp_ln_dense(
        x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), weight.data_ptr(),
        None if dense_bias is None else dense_bias.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        m, n, k, eps, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "ln_dense")
    global LAUNCHES
    LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)


# --- int8 (W8A8): LayerNorm → quantize → int8 matmul → dequantize ------------

#: ``ln_quant_dense`` kernel launches since the last reset
QUANT_LAUNCHES = 0


def quantize_activation(y: torch.Tensor, s_x: torch.Tensor) -> torch.Tensor:
    """Static per-tensor int8 quantization of an activation, as the JAX
    package's ``QuantDense`` and its fused kernel do it:
    ``clip(round_half_even(y_f32 · (127 / s_x)), −127, 127)``, the factor
    formed in f32 first."""
    return torch.clamp(torch.round(y.float() * (127.0 / s_x)), -127, 127).to(torch.int8)


def int8_matmul_exact(a_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """``a_q [M, K] @ w_q [N, K]ᵀ`` of int8 operands as int32, exactly: the
    products are summed in f64, whose 53-bit mantissa holds every partial
    sum (|Σ| ≤ 127² · K), on any device and at any shape."""
    return torch.matmul(a_q.double(), w_q.double().t()).to(torch.int32)


def ln_quant_dense_reference(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    s_x: torch.Tensor,
    weight_q: torch.Tensor,
    w_scale: torch.Tensor,
    dense_bias: torch.Tensor | None = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel's semantics on ``x [M, K]``
    (``stamp_tpu.ops.ln_dense.ln_quant_dense_reference``): LayerNorm in f32
    (two-pass), cast to ``x.dtype``, quantized with the static scale
    ``s_x``, an exact int8 product with ``weight_q [N, K]`` summed as
    integers, dequantized as ``acc · (s_x / 127) · w_scale`` in f32, the
    dense bias added in f32, one cast to ``x.dtype``."""
    y = layer_norm_f32(x, scale, bias, eps).to(x.dtype)
    acc = int8_matmul_exact(quantize_activation(y, s_x), weight_q)
    out = acc.float() * (s_x / 127.0) * w_scale.float()
    if dense_bias is not None:
        out = out + dense_bias.float()
    return out.to(x.dtype)


def ln_quant_dense(
    x: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    s_x: torch.Tensor,
    weight_q: torch.Tensor,
    w_scale: torch.Tensor,
    dense_bias: torch.Tensor | None = None,
    *,
    eps: float = 1e-6,
) -> torch.Tensor:
    """``dequant(int8_dot(quantize(LayerNorm(x)), weight_q)) + dense_bias``
    as one kernel (``stamp_tpu.ops.ln_dense.ln_quant_dense``, forward only).

    ``x``: [..., K] activation; ``scale``/``bias``: [K] LayerNorm
    parameters; ``s_x``: 0-dim f32 static activation scale (the calibrated
    amax with headroom), left on the device; ``weight_q``: [N, K] int8 in
    ``nn.Linear``'s layout (the transpose of the JAX package's
    ``kernel_q [K, N]``); ``w_scale``: [N] f32 per-output-channel dequant
    scale; ``dense_bias``: [N] or None.  Returns [..., N] in ``x.dtype``.
    On CUDA ``x``, ``scale``, ``bias`` and ``dense_bias`` are bfloat16,
    every tensor is contiguous and 16-byte aligned, and K is a multiple of
    8.  Where K is not a multiple of 16 (Virchow's fc2, K = 3,416) the
    kernel gets a copy of ``weight_q`` padded with zero columns to the next
    multiple of 16, made here at every call: TMA needs the int8 rows to be
    a multiple of 16 bytes.  The padded columns are never read (TMA
    zero-fills A and W past K), so the sums are those of the [N, K] weight.
    """
    k = x.shape[-1]
    n = weight_q.shape[0]
    x2d = x.reshape(-1, k)
    if x.device.type == "cpu":
        out = ln_quant_dense_reference(x2d, scale, bias, s_x, weight_q, w_scale, dense_bias, eps=eps)
        return out.reshape(*x.shape[:-1], n)
    if x.device.type != "cuda":
        raise ValueError(f"ln_quant_dense: unsupported device {x.device}")
    m = x2d.shape[0]
    dtypes = {"x": torch.bfloat16, "scale": torch.bfloat16, "bias": torch.bfloat16,
              "s_x": torch.float32, "weight_q": torch.int8, "w_scale": torch.float32}  # fmt: skip
    tensors = {"x": x, "scale": scale, "bias": bias, "s_x": s_x, "weight_q": weight_q, "w_scale": w_scale}
    if dense_bias is not None:
        dtypes["dense_bias"] = torch.bfloat16
        tensors["dense_bias"] = dense_bias
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"ln_quant_dense: {name} is on {t.device}, x on {x.device}")
        if t.dtype != dtypes[name]:
            raise TypeError(f"ln_quant_dense: the CUDA kernel takes {dtypes[name]} {name}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"ln_quant_dense: {name} must be contiguous and 16-byte aligned")
    if (tuple(weight_q.shape) != (n, k) or scale.shape != (k,) or bias.shape != (k,)
            or w_scale.shape != (n,) or s_x.numel() != 1):  # fmt: skip
        raise ValueError(
            f"ln_quant_dense: shapes x {tuple(x.shape)}, weight_q {tuple(weight_q.shape)}, "
            f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)}, w_scale {tuple(w_scale.shape)}, "
            f"s_x {tuple(s_x.shape)} do not match"
        )
    if dense_bias is not None and dense_bias.shape != (n,):
        raise ValueError(f"ln_quant_dense: dense_bias must be [{n}], got {tuple(dense_bias.shape)}")
    _check_shape("ln_quant_dense", m, k, n)
    if k % 16:
        weight_q = torch.nn.functional.pad(weight_q, (0, -k % 16))

    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    scratch = torch.empty(2 * k + 2 * m, dtype=torch.float32, device=x.device)  # f32 γ, β; row μ, 1/σ
    err = _build.load_library().stamp_ln_quant_dense(
        x2d.data_ptr(), scale.data_ptr(), bias.data_ptr(), s_x.data_ptr(),
        weight_q.data_ptr(), w_scale.data_ptr(),
        None if dense_bias is None else dense_bias.data_ptr(), scratch.data_ptr(), out.data_ptr(),
        m, n, k, eps, x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "ln_quant_dense")
    global QUANT_LAUNCHES
    QUANT_LAUNCHES += 1
    return out.reshape(*x.shape[:-1], n)
