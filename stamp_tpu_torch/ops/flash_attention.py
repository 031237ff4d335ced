"""Attention kernels: packed-qkv attention for the extractor ViTs, the
masked flash attention (plain and spatial-ALiBi) of the MIL ViT, and the
pre-softmax 2-D-ALiBi flash attention of the TITAN slide encoder.

Counterparts of ``stamp_tpu.ops.flash_attention.fused_qkv_mha`` (forward),
of ``flash_mha`` and ``flash_alibi_mha`` with their custom VJPs, and of
``flash_alibi2d_mha`` (forward).  On a CUDA tensor each wrapper launches its
hand-written kernel (``csrc/fused_qkv_attn.cu`` and, for N > 272,
``csrc/fused_qkv_long.cu``; ``csrc/flash_attn.cu``, for
the backward ``csrc/flash_attn_bwd.cu``, ``csrc/flash_alibi2d.cu``); on a
CPU tensor it runs the plain PyTorch version beside it (``*_reference``).
There is no fallback between the two: a CUDA tensor a kernel does not take
raises.

``fused_qkv_mha`` follows the Pallas kernel's order of operations: scores
q·kᵀ in f32, scaled by d^-1/2 in f32 after the dot, an exact softmax in f32
(max, exp, sum, divide), the probabilities cast to the activation dtype
before P·V, P·V accumulated in f32 and cast once.

``flash_mha`` and ``flash_alibi_mha`` take f32 ``[BH, T, d]`` q/k/v and a
``[BH, T]`` bool key mask (True = valid).  The kernels are built for d =
32, 64 and 128; any d up to 128 runs on the next of them, q, k and v
zero-padded along d and the output and gradients sliced back (the true
d^-1/2 is passed on).  Scores are scaled after the dot,
masked keys get −1e30, and the output is Σ exp(s − m)·v / Σ exp(s − m) with
its log-sum-exp.  The ALiBi variant also accumulates D·V, D the per-axis
Euclidean distance between query and key coordinates (0 for masked keys),
and returns ``O − dist_scale·(D·V)``: the reference's bias is subtracted
after the softmax.  On the card the forward is a pre-pass (TF32 copies of q
and k, Vᵀ, the mask as scores), a list of the key tiles that hold a valid
key, and a TMA-fed TF32 wgmma kernel over those tiles with the online
softmax in registers (``csrc/flash_attn.cu``); the ALiBi forward runs the
distance-weighted sum below for D·V first (a 3×TF32 split accurate to
f32), then that kernel with an epilogue that writes ``O − dist_scale·dacc``.
The plain versions run everything in f32.

``flash_mha`` also takes attention dropout (``AttentionDropout``: the
uniform draws ``ops.attention.dropout`` would make for the weights, and the
rate), which the JAX package's kernels do not have: a pack kernel turns the
draws into keep bits [BH, Q, ⌈K/32⌉] (``csrc/flash_attn.cu``), the forward
multiplies each tile of probabilities by its bits before P·V and divides
by (1 − rate) at the end (the row sums and the lse stay the undropped
softmax's), and the backward runs FlashAttention-2's dropout backward
(dV = (P∘M)ᵀ·dO/(1 − rate), dS = P∘(M∘dP/(1 − rate) − rowsum(dO∘O))).
These dropout forms compute every product f32-accurate, as three TF32
products (hi·hi + hi·lo + lo·hi, as the distance-weighted sum below), for
head widths up to 64.

Both are ``torch.autograd.Function``s whose backward is the JAX package's
(``_flash_core_bwd``, ``_alibi_core_bwd``): the probabilities are recomputed
from the saved lse, and a pre-pass kernel (TF32 and transposed copies,
D = rowsum(dO∘O), lists of the tiles that contribute) feeds a dQ and a
dK/dV kernel (TF32 wgmma; key tiles with no valid key and query tiles whose
dO is zero are skipped, their contribution being exactly zero).  The ALiBi
backward runs them on its softmax output and adds the bias branch:
dV −= Dᵀ·(dist_scale·dO) on valid keys, through the distance-weighted sum
(three TF32 wgmma products, f32-accurate; query tiles whose dO is zero and
key rows that are masked are skipped), and d dist_scale = −Σ dO∘(D·V) in
plain torch.  Coordinates and the mask get no gradient.

``flash_alibi2d_mha`` runs a pre-pass (TF32 copies of q and k, Vᵀ, padded
coordinates) and a TMA-fed TF32 wgmma kernel with the bias and the online
softmax in registers.
"""

from __future__ import annotations

import ctypes

import torch

from stamp_tpu_torch.ops import _build
from stamp_tpu_torch.utils.shapecheck import Bool, Float, shapechecked

# kernel launches since the last reset (the main path's proof of use)
#: ``fused_qkv_mha`` (both of its kernels)
LAUNCHES = 0
#: ``fused_qkv_mha``'s two-pass kernel, N > ``ONE_PASS_MAX_N`` (also in ``LAUNCHES``)
LONG_LAUNCHES = 0
#: ``flash_mha``
FLASH_MHA_LAUNCHES = 0
#: ``flash_alibi_mha``
FLASH_ALIBI_MHA_LAUNCHES = 0
#: the backward of ``flash_mha`` (its dQ and dK/dV kernels)
FLASH_MHA_BWD_LAUNCHES = 0
#: ``flash_mha`` with attention dropout (the pack and the dropout forward)
FLASH_MHA_DROPOUT_LAUNCHES = 0
#: its backward (the dropout forms of the dQ and dK/dV kernels)
FLASH_MHA_DROPOUT_BWD_LAUNCHES = 0
#: the backward of ``flash_alibi_mha`` (the same two kernels)
FLASH_ALIBI_MHA_BWD_LAUNCHES = 0
#: ``_dist_weighted_sum`` (the ALiBi backward's bias branch)
DIST_WEIGHTED_SUM_LAUNCHES = 0

_HEAD_DIMS = (64, 80)  # fused_qkv_attn.cu's and fused_qkv_long.cu's template instances
#: the longest sequence ``fused_qkv_mha``'s one-pass kernel takes (its
#: ``kMaxKeys``); a longer one runs the two-pass kernel
ONE_PASS_MAX_N = 272
_FLASH_HEAD_DIMS = (32, 64, 128)  # flash_attn.cu's and flash_attn_bwd.cu's template instances
#: the widest head the dropout forms of the flash kernels take (their instances: 32 and 64)
FLASH_DROPOUT_MAX_HEAD_DIM = 64
_NEG_INF = -1e30


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


@shapechecked
def fused_qkv_mha(
    qkv: Float[torch.Tensor, "b n three_dim"], num_heads: int
) -> Float[torch.Tensor, "b n dim"]:
    """Fused multi-head attention over a packed qkv tensor.

    Args:
        qkv: [B, N, 3·dim], lane order [q | k | v], each ``dim`` wide with
            heads contiguous (timm's qkv layout).  On CUDA: bf16,
            contiguous, head_dim = dim / num_heads in (64, 80).
        num_heads: number of heads; dim % num_heads == 0.

    Returns: [B, N, dim] attention output (before the output projection).
    On CUDA, N <= ``ONE_PASS_MAX_N`` runs the one-pass kernel (scores in
    registers, ``csrc/fused_qkv_attn.cu``), a longer N the two-pass kernel
    (``csrc/fused_qkv_long.cu``: TMA and bf16 wgmma, a pass over the key
    tiles for the rows' max and sum, a second for p and P·V); both count
    in ``LAUNCHES``, the two-pass one also in ``LONG_LAUNCHES``.
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
    long_form = n > ONE_PASS_MAX_N
    entry = lib.stamp_fused_qkv_long if long_form else lib.stamp_fused_qkv_attn
    err = entry(
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
    global LAUNCHES, LONG_LAUNCHES
    LAUNCHES += 1
    LONG_LAUNCHES += long_form
    return out


# --- masked flash attention (the MIL ViT at seq_len >= 4096) -----------------


def _pairwise_distances(coords_q: torch.Tensor, coords_k: torch.Tensor) -> torch.Tensor:
    """[BH, Q, K] Euclidean distances from per-axis differences (the Gram
    identity cancels catastrophically for nearby µm coordinates)."""
    dist = (coords_q[:, :, None, 0] - coords_k[:, None, :, 0]).square_()
    dist += (coords_q[:, :, None, 1] - coords_k[:, None, :, 1]).square_()
    return dist.sqrt_()


class AttentionDropout:
    """Attention dropout of one ``flash_mha`` call: ``rate`` and the
    uniform float32 draws [BH, Q, K] that ``ops.attention.dropout`` would
    compare with 1 − rate for the same [BH, Q, K] weights (a weight is kept
    where its draw lies below).  The forward packs the draws into ``bits``
    ([BH, Q, ⌈K/32⌉] int32: bit j of word w is key 32w + j, set where that
    key is valid and kept) and lets the draws go; the backward reads the
    bits."""

    def __init__(self, draws: torch.Tensor, rate: float) -> None:
        self.draws: torch.Tensor | None = draws
        self.rate = float(rate)
        self.bits: torch.Tensor | None = None

    def pack(self, key_mask: torch.Tensor, packer) -> torch.Tensor:
        """The keep bits, packed by ``packer(draws, rate, key_mask)`` at the first call."""
        if self.bits is None:
            self.bits = packer(self.draws, self.rate, key_mask)
            self.draws = None
        return self.bits


def _pack_keep_reference(draws: torch.Tensor, rate: float, key_mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the pack: [BH, Q, K] draws and the [BH, K]
    key mask → keep bits [BH, Q, ⌈K/32⌉] int32 (see ``AttentionDropout``)."""
    bh, tq, tk = draws.shape
    keep = (draws < 1.0 - rate) & key_mask[:, None, :]
    words = -(-tk // 32)
    keep = torch.nn.functional.pad(keep, (0, 32 * words - tk)).view(bh, tq, words, 32)
    bits = torch.zeros((bh, tq, words), dtype=torch.int32, device=draws.device)
    for j in range(32):
        bits |= keep[..., j].int() << j
    return bits


def _unpack_keep(bits: torch.Tensor, tk: int) -> torch.Tensor:
    """The keep bits as a bool mask [BH, Q, tk]."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    keep = (bits[..., None] >> shifts) & 1
    return keep.view(*bits.shape[:-1], -1)[..., :tk].bool()


def _flash_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    scale: float | None = None,
    keep: torch.Tensor | None = None,
    rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash forward: (out [BH, Q, d], lse
    [BH, Q]), all in f32, scores scaled by ``scale`` (d^-1/2 when None).
    With ``keep`` ([BH, Q, K] bool) the probabilities it drops are 0 in
    P·V and the output is divided by 1 − ``rate`` too; the lse is the
    undropped softmax's.  Materialises the [BH, Q, K] scores, updated in
    place to keep one such tensor alive."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.matmul(q, k.transpose(-1, -2)).mul_(scale)
    s.masked_fill_(~key_mask[:, None, :], _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = s.sub_(m).exp_()
    denom = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    if keep is None:
        out = torch.matmul(p, v).div_(denom)
    else:
        out = torch.matmul(p.masked_fill_(~keep, 0.0), v).div_(denom * (1.0 - rate))
    return out, (m + denom.log()).squeeze(-1)


def _flash_forward_plain(q, k, v, key_mask, scale=None, keep: AttentionDropout | None = None):
    """``_flash_forward`` in plain PyTorch on any device: the plain pack of
    ``keep``'s draws, then the plain forward."""
    if keep is None:
        return _flash_forward_reference(q, k, v, key_mask, scale)
    bits = keep.pack(key_mask, _pack_keep_reference)
    return _flash_forward_reference(q, k, v, key_mask, scale, _unpack_keep(bits, k.shape[1]), keep.rate)


def _flash_alibi_forward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coords_q: torch.Tensor,
    coords_k: torch.Tensor,
    key_mask: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused ALiBi pass: (softmax out, dacc =
    D·V, lse), all in f32."""
    out_sm, lse = _flash_forward_reference(q, k, v, key_mask, scale)
    dist = _pairwise_distances(coords_q.float(), coords_k.float())
    dist.masked_fill_(~key_mask[:, None, :], 0.0)
    return out_sm, torch.matmul(dist, v), lse


def flash_mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, key_mask: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_mha``."""
    return _flash_forward_reference(q, k, v, key_mask)[0]


def flash_alibi_mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coords_q: torch.Tensor,
    coords_k: torch.Tensor,
    dist_scale: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_alibi_mha``."""
    out_sm, dacc, _ = _flash_alibi_forward_reference(q, k, v, coords_q, coords_k, key_mask)
    return out_sm - dist_scale[:, None, None] * dacc


def flash_width(what: str, head_dim: int) -> int:
    """The flash kernel instance a head width runs on: the narrowest of
    ``_FLASH_HEAD_DIMS`` that holds it.  ``flash_mha`` and
    ``flash_alibi_mha`` zero-pad q, k and v to it (zero columns change
    neither q·kᵀ nor the distances) and pass the true d^-1/2.  A wider head
    raises, naming the JAX package, which takes every width."""
    for width in _FLASH_HEAD_DIMS:
        if head_dim <= width:
            return width
    raise ValueError(
        f"{what}: head_dim {head_dim} is wider than the flash kernels take (up to {_FLASH_HEAD_DIMS[-1]}; "
        f"narrower widths are zero-padded to one of {_FLASH_HEAD_DIMS}); run this model with `python -m stamp_tpu`"
    )


def _pad_heads(width: int, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Each [BH, T, d] tensor zero-padded to [BH, T, width] (differentiable)."""
    return [torch.nn.functional.pad(t, (0, width - t.shape[-1])) for t in tensors]


def _check_flash_args(what: str, q, k, v, key_mask, coords_q=None, coords_k=None, dist_scale=None):
    """Raise on any input the CUDA kernel does not take."""
    if q.dim() != 3 or k.dim() != 3 or v.shape != k.shape or q.shape[::2] != k.shape[::2]:
        raise ValueError(
            f"{what}: q must be [BH, Q, d] and k, v [BH, K, d], got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, tq, d = q.shape
    tk = k.shape[1]
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {d} has no kernel instance {_FLASH_HEAD_DIMS}")
    if not (0 < bh <= 65535 and tq > 0 and tk > 0):
        raise ValueError(f"{what}: unsupported shape {tuple(q.shape)}, {tuple(k.shape)}")
    if key_mask.shape != (bh, tk) or key_mask.dtype != torch.bool:
        raise ValueError(
            f"{what}: key_mask must be bool [{bh}, {tk}], got {key_mask.dtype} {tuple(key_mask.shape)}"
        )
    tensors = {"q": q, "k": k, "v": v, "key_mask": key_mask}
    if coords_q is not None:
        if coords_q.shape != (bh, tq, 2) or coords_k.shape != (bh, tk, 2) or dist_scale.shape != (bh,):
            raise ValueError(
                f"{what}: coords must be [BH, Q, 2] / [BH, K, 2] and dist_scale [BH], got "
                f"{tuple(coords_q.shape)}, {tuple(coords_k.shape)}, {tuple(dist_scale.shape)}"
            )
        tensors |= {"coords_q": coords_q, "coords_k": coords_k, "dist_scale": dist_scale}
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is on {t.device}, q on {q.device}")
        if name != "key_mask" and t.dtype != torch.float32:
            raise TypeError(f"{what}: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def _workspace(entry: str, what: str, device: torch.device, *shape: int) -> torch.Tensor:
    """The scratch memory a kernel's pre-pass fills, sized by its C entry
    point ``entry`` (bytes for ``shape``, written as an int64)."""
    nbytes = ctypes.c_int64()
    _build.check(getattr(_build.load_library(), entry)(*shape, ctypes.addressof(nbytes)), what)
    return torch.empty(nbytes.value, dtype=torch.uint8, device=device)


def _launch_flash(q, k, v, key_mask, scale=None):
    """``stamp_flash_attn_fwd`` (the pre-pass, the tile list and the
    attention kernel) with the workspace its pre-pass fills; scores scaled
    by ``scale`` (d^-1/2 when None).  Returns (o, lse)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    workspace = _workspace("stamp_flash_attn_fwd_workspace", "flash_mha", q.device, bh, tq, tk, d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    err = _build.load_library().stamp_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), workspace.data_ptr(),
        o.data_ptr(), lse.data_ptr(), bh, tq, tk, d, scale,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash_mha")
    return o, lse


def _launch_flash_alibi(q, k, v, key_mask, coords_q, coords_k, dist_scale, scale=None):
    """``stamp_flash_alibi_fwd`` (the distance-weighted sum for dacc, then
    the flash forward's three kernels with the ALiBi epilogue) with its
    workspace.  Returns (out, o, dacc, lse)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    workspace = _workspace("stamp_flash_alibi_fwd_workspace", "flash_alibi_mha", q.device, bh, tq, tk, d)
    o, dacc, out = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    err = _build.load_library().stamp_flash_alibi_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
        coords_q.data_ptr(), coords_k.data_ptr(), dist_scale.data_ptr(), workspace.data_ptr(),
        o.data_ptr(), dacc.data_ptr(), out.data_ptr(), lse.data_ptr(), bh, tq, tk, d, scale,
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash_alibi_mha")
    return out, o, dacc, lse


def _check_dropout_args(what: str, q, k, keep: AttentionDropout) -> None:
    """Raise on attention dropout the dropout kernels do not take."""
    bh, tq, d = q.shape
    if d > FLASH_DROPOUT_MAX_HEAD_DIM:
        raise ValueError(f"{what}: attention dropout takes head widths up to {FLASH_DROPOUT_MAX_HEAD_DIM}, got {d}")
    if not 0.0 <= keep.rate < 1.0:
        raise ValueError(f"{what}: dropout rate {keep.rate} is not in [0, 1)")
    t = keep.draws if keep.bits is None else keep.bits
    want = (bh, tq, k.shape[1]) if keep.bits is None else (bh, tq, -(-k.shape[1] // 32))
    dtype = torch.float32 if keep.bits is None else torch.int32
    if t.shape != want or t.dtype != dtype or t.device != q.device:
        raise ValueError(f"{what}: dropout's {'draws' if keep.bits is None else 'bits'} must be {dtype} {list(want)} "
                         f"on {q.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")  # fmt: skip
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{what}: dropout's draws or bits must be contiguous and 16-byte aligned")


def _pack_keep(draws: torch.Tensor, rate: float, key_mask: torch.Tensor) -> torch.Tensor:
    """The pack kernel (``stamp_flash_keep_pack``): ``_pack_keep_reference``
    on the card.  It reads the draws of the 32-key words that hold a valid
    key only (the others' bits are 0)."""
    bh, tq, tk = draws.shape
    bits = torch.empty((bh, tq, -(-tk // 32)), dtype=torch.int32, device=draws.device)
    err = _build.load_library().stamp_flash_keep_pack(
        draws.data_ptr(), key_mask.data_ptr(), bits.data_ptr(), bh, tq, tk, 1.0 - rate,
        draws.device.index, torch.cuda.current_stream(draws.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash_mha's dropout pack")
    return bits


def _launch_flash_drop(q, k, v, key_mask, bits, rate, scale=None):
    """``stamp_flash_attn_fwd_drop`` (the dropout forward's pre-pass, tile
    list and attention kernel) with its workspace.  Returns (o, lse)."""
    bh, tq, d = q.shape
    tk = k.shape[1]
    scale = d**-0.5 if scale is None else scale
    workspace = _workspace("stamp_flash_attn_fwd_drop_workspace", "flash_mha", q.device, bh, tq, tk, d)
    o = torch.empty_like(q)
    lse = torch.empty((bh, tq), dtype=torch.float32, device=q.device)
    err = _build.load_library().stamp_flash_attn_fwd_drop(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(), bits.data_ptr(), workspace.data_ptr(),
        o.data_ptr(), lse.data_ptr(), bh, tq, tk, d, scale, 1.0 / (1.0 - rate),
        q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash_mha with dropout")
    return o, lse


def _flash_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    scale: float | None = None,
    keep: AttentionDropout | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(out [BH, Q, d], lse [BH, Q]) of masked flash attention, scores
    scaled by ``scale`` (d^-1/2 when None).  With ``keep`` the weights are
    dropped as its draws say and the kept ones scaled by 1 / (1 − rate):
    on the card the pack kernel first (``keep.bits``), then the dropout
    forward; the lse stays the undropped softmax's."""
    if q.device.type == "cpu":
        return _flash_forward_plain(q, k, v, key_mask, scale, keep)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha: unsupported device {q.device}")
    _check_flash_args("flash_mha", q, k, v, key_mask)
    global FLASH_MHA_LAUNCHES, FLASH_MHA_DROPOUT_LAUNCHES
    if keep is None:
        o, lse = _launch_flash(q, k, v, key_mask, scale)
        FLASH_MHA_LAUNCHES += 1
        return o, lse
    _check_dropout_args("flash_mha", q, k, keep)
    o, lse = _launch_flash_drop(q, k, v, key_mask, keep.pack(key_mask, _pack_keep), keep.rate, scale)
    FLASH_MHA_DROPOUT_LAUNCHES += 1
    return o, lse


@shapechecked
def flash_mha(
    q: Float[torch.Tensor, "bh q d"],
    k: Float[torch.Tensor, "bh k d"],
    v: Float[torch.Tensor, "bh k d"],
    key_mask: Bool[torch.Tensor, "bh k"],
    *,
    keep: AttentionDropout | None = None,
) -> torch.Tensor:
    """Masked flash attention over flattened (batch×head) sequences.

    Args:
        q: [BH, Q, d]; k, v: [BH, K, d]; on CUDA f32 and contiguous; d up
            to 128, zero-padded to the next of (32, 64, 128) when it is none
            of them (``flash_width``).
        key_mask: [BH, K] bool, True = valid key.
        keep: attention dropout (training), for d up to
            ``FLASH_DROPOUT_MAX_HEAD_DIM``: the weights its draws drop are 0
            and the others scaled by 1 / (1 − rate), as
            ``ops.attention.dropout`` does to them.

    Returns: [BH, Q, d].  Differentiable in q, k and v.
    """
    d = q.shape[-1]
    width = flash_width("flash_mha", d)
    if keep is not None and width > FLASH_DROPOUT_MAX_HEAD_DIM:
        raise ValueError(f"flash_mha: attention dropout takes head widths up to {FLASH_DROPOUT_MAX_HEAD_DIM}, got {d}")
    extra = () if keep is None else (keep,)
    if width == d:
        return _FlashMHA.apply(q, k, v, key_mask, d**-0.5, *extra)
    return _FlashMHA.apply(*_pad_heads(width, q, k, v), key_mask, d**-0.5, *extra)[..., :d]


def _flash_alibi_forward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coords_q: torch.Tensor,
    coords_k: torch.Tensor,
    dist_scale: torch.Tensor,
    key_mask: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, softmax out, dacc = D·V, lse) of the fused ALiBi pass."""
    if q.device.type == "cpu":
        out_sm, dacc, lse = _flash_alibi_forward_reference(q, k, v, coords_q, coords_k, key_mask, scale)
        return out_sm - dist_scale[:, None, None] * dacc, out_sm, dacc, lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_alibi_mha: unsupported device {q.device}")
    _check_flash_args("flash_alibi_mha", q, k, v, key_mask, coords_q, coords_k, dist_scale)
    parts = _launch_flash_alibi(q, k, v, key_mask, coords_q, coords_k, dist_scale, scale)
    global FLASH_ALIBI_MHA_LAUNCHES
    FLASH_ALIBI_MHA_LAUNCHES += 1
    return parts


def flash_alibi_mha(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coords_q: torch.Tensor,
    coords_k: torch.Tensor,
    dist_scale: torch.Tensor,
    key_mask: torch.Tensor,
) -> torch.Tensor:
    """Fused spatial-ALiBi attention (post-softmax distance bias).

    Args:
        q: [BH, Q, d]; k, v: [BH, K, d]; coords_q: [BH, Q, 2] and coords_k:
            [BH, K, 2] in µm; dist_scale: [BH] (bias_scale / running_mean
            per (batch, head)); on CUDA all f32 and contiguous; d up to
            128, zero-padded as in ``flash_mha``.
        key_mask: [BH, K] bool, True = valid key.

    Returns: [BH, Q, d] = softmax(q·kᵀ/√d)·v − dist_scale·(D·v).
    Differentiable in q, k, v and dist_scale.
    """
    d = q.shape[-1]
    width = flash_width("flash_alibi_mha", d)
    if width == d:
        return _FlashALiBiMHA.apply(q, k, v, coords_q, coords_k, dist_scale, key_mask, d**-0.5)
    qp, kp, vp = _pad_heads(width, q, k, v)
    return _FlashALiBiMHA.apply(qp, kp, vp, coords_q, coords_k, dist_scale, key_mask, d**-0.5)[..., :d]


# --- backward (whole-slide training) -------------------------------------------


def _flash_backward_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
    keep: torch.Tensor | None = None,
    rate: float = 0.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the flash backward (``_flash_core_bwd``):
    (dq, dk, dv), all in f32, from the forward's output and lse.  With
    ``keep`` (the forward's [BH, Q, K] bool mask and ``rate``),
    FlashAttention-2's dropout backward: dV = (P∘M)ᵀ·dO / (1 − rate) and
    dS = P∘(M∘dP / (1 − rate) − rowsum(dO∘O)), O the dropped output.
    Materialises the [BH, Q, K] probabilities, updated in place to keep two
    such tensors alive (three with ``keep``)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    dvec = (do * out).sum(dim=-1, keepdim=True)
    p = torch.matmul(q, k.transpose(-1, -2)).mul_(scale)
    p.masked_fill_(~key_mask[:, None, :], _NEG_INF)
    p = p.sub_(lse[:, :, None]).exp_()
    dp = torch.matmul(do, v.transpose(-1, -2))
    if keep is None:
        dv = torch.matmul(p.transpose(-1, -2), do)
    else:
        dv = torch.matmul(torch.where(keep, p / (1.0 - rate), 0.0).transpose(-1, -2), do)
        dp = torch.where(keep, dp / (1.0 - rate), 0.0)
    ds = dp.sub_(dvec).mul_(p).mul_(scale)
    del p
    return torch.matmul(ds, k), torch.matmul(ds.transpose(-1, -2), q), dv


def _flash_backward_plain(q, k, v, key_mask, out, lse, do, scale=None, keep: AttentionDropout | None = None):
    """``_flash_backward`` in plain PyTorch on any device (``keep`` as the
    forward left it: packed)."""
    if keep is None:
        return _flash_backward_reference(q, k, v, key_mask, out, lse, do, scale)
    mask = _unpack_keep(keep.pack(key_mask, _pack_keep_reference), k.shape[1])
    return _flash_backward_reference(q, k, v, key_mask, out, lse, do, scale, mask, keep.rate)


def _dist_weighted_sum_reference(
    coords_a: torch.Tensor,
    coords_b: torch.Tensor,
    values: torch.Tensor,
    b_mask: torch.Tensor | None,
    a_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain PyTorch version of ``_dist_weighted_sum``: [BH, A, d] ←
    Σ_b ‖c_a − c_b‖·values_b over the b that ``b_mask`` keeps (every b
    with ``None``), in f32; rows a that ``a_mask`` drops are zero."""
    dist = _pairwise_distances(coords_a.float(), coords_b.float())
    if b_mask is not None:
        dist.masked_fill_(~b_mask[:, None, :], 0.0)
    out = torch.matmul(dist, values)
    if a_mask is not None:
        out.masked_fill_(~a_mask[:, :, None], 0.0)
    return out


def _launch_flash_bwd(q, k, v, key_mask, out, lse, do, scale=None):
    """The flash backward on the card (``stamp_flash_attn_bwd``: the
    pre-pass, the tile lists, the dQ and the dK/dV kernels), with the
    workspace the pre-pass fills (TF32 and transposed copies, D, tile
    lists)."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bh, tq, d = q.shape
    tk = k.shape[1]
    workspace = _workspace("stamp_flash_attn_bwd_workspace", "flash attention backward", q.device, bh, tq, tk, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.load_library().stamp_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
        do.data_ptr(), out.data_ptr(), lse.data_ptr(), workspace.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, tq, tk, d, scale, q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash attention backward")
    return dq, dk, dv


def _launch_flash_bwd_drop(q, k, v, key_mask, out, lse, do, bits, rate, scale=None):
    """The dropout backward on the card (``stamp_flash_attn_bwd_drop``: its
    pre-pass, the tile lists, the dQ and the dK/dV kernels) with its
    workspace."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    bh, tq, d = q.shape
    tk = k.shape[1]
    workspace = _workspace("stamp_flash_attn_bwd_drop_workspace", "flash attention backward", q.device, bh, tq, tk, d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    err = _build.load_library().stamp_flash_attn_bwd_drop(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), key_mask.data_ptr(),
        do.data_ptr(), out.data_ptr(), lse.data_ptr(), bits.data_ptr(), workspace.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        bh, tq, tk, d, scale, 1.0 / (1.0 - rate), q.device.index, torch.cuda.current_stream(q.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash attention backward with dropout")
    return dq, dk, dv


def _check_bwd_args(what: str, q, out, lse, do) -> None:
    """Raise on backward inputs the CUDA kernels do not take."""
    if out.shape != q.shape or do.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError(
            f"{what}: out and dO must be {tuple(q.shape)} and lse {tuple(q.shape[:2])}, got "
            f"{tuple(out.shape)}, {tuple(do.shape)}, {tuple(lse.shape)}"
        )
    for name, t in {"out": out, "lse": lse, "dO": do}.items():
        if t.device != q.device or t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32 on {q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be contiguous and 16-byte aligned")


def _flash_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    key_mask: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
    keep: AttentionDropout | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``flash_mha`` for the upstream gradient ``do``; with
    ``keep`` (as the forward packed it) the dropout backward."""
    if q.device.type == "cpu":
        return _flash_backward_plain(q, k, v, key_mask, out, lse, do, scale, keep)
    if q.device.type != "cuda":
        raise ValueError(f"flash_mha backward: unsupported device {q.device}")
    _check_flash_args("flash_mha backward", q, k, v, key_mask)
    _check_bwd_args("flash_mha backward", q, out, lse, do)
    global FLASH_MHA_BWD_LAUNCHES, FLASH_MHA_DROPOUT_BWD_LAUNCHES
    if keep is None:
        grads = _launch_flash_bwd(q, k, v, key_mask, out, lse, do, scale)
        FLASH_MHA_BWD_LAUNCHES += 1
        return grads
    if keep.bits is None:
        raise ValueError("flash_mha backward: dropout's keep bits are missing (the forward packs them)")
    _check_dropout_args("flash_mha backward", q, k, keep)
    grads = _launch_flash_bwd_drop(q, k, v, key_mask, out, lse, do, keep.bits, keep.rate, scale)
    FLASH_MHA_DROPOUT_BWD_LAUNCHES += 1
    return grads


def _dist_weighted_sum(
    coords_a: torch.Tensor,
    coords_b: torch.Tensor,
    values: torch.Tensor,
    b_mask: torch.Tensor | None,
    a_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """[BH, A, d] ← Σ_b ‖c_a − c_b‖·values_b over the b that ``b_mask``
    ([BH, B] bool, or ``None`` for every b) keeps; f32-accurate.  Rows a
    that ``a_mask`` ([BH, A] bool, or ``None`` for every a) drops are zero:
    the kernel skips them, and b tiles whose kept values are all zero.

    Its own transpose: the VJP of ``dacc = D·V`` wrt V is ``Dᵀ·dO``, this
    function with the coordinate sides swapped."""
    if values.device.type == "cpu":
        return _dist_weighted_sum_reference(coords_a, coords_b, values, b_mask, a_mask)
    if values.device.type != "cuda":
        raise ValueError(f"_dist_weighted_sum: unsupported device {values.device}")
    bh, tb, d = values.shape
    ta = coords_a.shape[1]
    if coords_a.shape != (bh, ta, 2) or coords_b.shape != (bh, tb, 2) or d not in _FLASH_HEAD_DIMS:
        raise ValueError(
            f"_dist_weighted_sum: coords must be [BH, A, 2] / [BH, B, 2] and values [BH, B, d] with d in "
            f"{_FLASH_HEAD_DIMS}, got {tuple(coords_a.shape)}, {tuple(coords_b.shape)}, {tuple(values.shape)}"
        )
    if not (0 < bh <= 65535 and ta > 0 and tb > 0):
        raise ValueError(f"_dist_weighted_sum: unsupported shape {tuple(values.shape)}, A = {ta}")
    masks = {"b_mask": (b_mask, tb), "a_mask": (a_mask, ta)}
    for name, (mask, n) in masks.items():
        if mask is not None and (mask.shape != (bh, n) or mask.dtype != torch.bool):
            raise ValueError(f"_dist_weighted_sum: {name} must be bool [{bh}, {n}], got {mask.dtype} {tuple(mask.shape)}")
    tensors = {"coords_a": coords_a, "coords_b": coords_b, "values": values, "b_mask": b_mask, "a_mask": a_mask}
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != values.device:
            raise ValueError(f"_dist_weighted_sum: {name} is on {t.device}, values on {values.device}")
        if name not in masks and t.dtype != torch.float32:
            raise TypeError(f"_dist_weighted_sum: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"_dist_weighted_sum: {name} must be contiguous and 16-byte aligned")
    workspace = _workspace("stamp_dist_weighted_sum_workspace", "_dist_weighted_sum", values.device, bh, ta, tb, d)
    out = torch.empty((bh, ta, d), dtype=torch.float32, device=values.device)
    err = _build.load_library().stamp_dist_weighted_sum(
        coords_a.data_ptr(), coords_b.data_ptr(), values.data_ptr(),
        None if b_mask is None else b_mask.data_ptr(), None if a_mask is None else a_mask.data_ptr(),
        workspace.data_ptr(), out.data_ptr(),
        bh, ta, tb, d, values.device.index, torch.cuda.current_stream(values.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "_dist_weighted_sum")
    global DIST_WEIGHTED_SUM_LAUNCHES
    DIST_WEIGHTED_SUM_LAUNCHES += 1
    return out


def _alibi_bias_branch(dv, do, dacc, dv_bias):
    """The post-softmax bias branch of ``_alibi_core_bwd``: (dv with the
    bias term, d dist_scale = −Σ dO∘dacc per (batch·head)).  ``dv_bias`` is
    the distance-weighted sum with the key mask as its a-mask: zero on the
    masked keys, as ``where(key_mask, dv_bias, 0)`` makes it there."""
    return dv - dv_bias, -(do * dacc).sum(dim=(1, 2))


def _flash_alibi_backward_reference(
    q, k, v, coords_q, coords_k, dist_scale, key_mask, out_sm, dacc, lse, do, scale=None
):
    """Plain PyTorch version of the ALiBi backward: (dq, dk, dv, d dist_scale)."""
    dq, dk, dv = _flash_backward_reference(q, k, v, key_mask, out_sm, lse, do, scale)
    dv_bias = _dist_weighted_sum_reference(coords_k, coords_q, do * dist_scale[:, None, None], None, key_mask)
    return (dq, dk, *_alibi_bias_branch(dv, do, dacc, dv_bias))


def _flash_alibi_backward(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coords_q: torch.Tensor,
    coords_k: torch.Tensor,
    dist_scale: torch.Tensor,
    key_mask: torch.Tensor,
    out_sm: torch.Tensor,
    dacc: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv, d dist_scale) of ``flash_alibi_mha`` for ``do``."""
    args = (q, k, v, coords_q, coords_k, dist_scale, key_mask, out_sm, dacc, lse, do, scale)
    if q.device.type == "cpu":
        return _flash_alibi_backward_reference(*args)
    if q.device.type != "cuda":
        raise ValueError(f"flash_alibi_mha backward: unsupported device {q.device}")
    _check_flash_args("flash_alibi_mha backward", q, k, v, key_mask, coords_q, coords_k, dist_scale)
    _check_bwd_args("flash_alibi_mha backward", q, out_sm, lse, do)
    dq, dk, dv = _launch_flash_bwd(q, k, v, key_mask, out_sm, lse, do, scale)
    global FLASH_ALIBI_MHA_BWD_LAUNCHES
    FLASH_ALIBI_MHA_BWD_LAUNCHES += 1
    dv_bias = _dist_weighted_sum(coords_k, coords_q, do * dist_scale[:, None, None], None, key_mask)
    return (dq, dk, *_alibi_bias_branch(dv, do, dacc, dv_bias))


class _FlashMHA(torch.autograd.Function):
    """``flash_mha`` with the flash backward (``_flash_core`` and its VJP);
    ``scale`` is d^-1/2 of the unpadded head width; ``keep`` (attention
    dropout, or None) keeps its bits, not its draws, for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale, keep=None):
        dropout = {} if keep is None else {"keep": keep}
        out, lse = _flash_forward(q, k, v, key_mask, scale, **dropout)
        ctx.save_for_backward(q, k, v, key_mask, out, lse)
        ctx.scale, ctx.dropout = scale, dropout
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_backward(q, k, v, key_mask, out, lse, do.contiguous(), ctx.scale, **ctx.dropout)
        return dq, dk, dv, None, None, None


class _FlashALiBiMHA(torch.autograd.Function):
    """``flash_alibi_mha`` with its backward (``_alibi_core`` and its VJP);
    ``scale`` as in ``_FlashMHA``."""

    @staticmethod
    def forward(ctx, q, k, v, coords_q, coords_k, dist_scale, key_mask, scale):
        out, out_sm, dacc, lse = _flash_alibi_forward(q, k, v, coords_q, coords_k, dist_scale, key_mask, scale)
        ctx.save_for_backward(q, k, v, coords_q, coords_k, dist_scale, key_mask, out_sm, dacc, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv, ddist_scale = _flash_alibi_backward(*ctx.saved_tensors, do.contiguous(), ctx.scale)
        return dq, dk, dv, None, None, ddist_scale, None, None


# --- pre-softmax 2-D ALiBi flash attention (the TITAN slide encoder) ---------

#: ``flash_alibi2d_mha``
FLASH_ALIBI2D_LAUNCHES = 0


def flash_alibi2d_mha_reference(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    coords: torch.Tensor,
    slopes: torch.Tensor,
    *,
    exempt_first: bool = True,
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_alibi2d_mha``, all in f32.
    Materialises the [BH, N, N] scores, updated in place to keep two such
    tensors alive."""
    bias = _pairwise_distances(coords.float(), coords.float()).mul_(-slopes.float()[:, None, None])
    if exempt_first:
        bias[:, 0, :] = 0.0
        bias[:, :, 0] = 0.0
    s = torch.matmul(q, k.transpose(-1, -2)).mul_(q.shape[-1] ** -0.5).add_(bias)
    del bias
    p = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    denom = p.sum(dim=-1, keepdim=True).clamp_min_(1e-30)
    return torch.matmul(p, v).div_(denom)


@shapechecked
def flash_alibi2d_mha(
    q: Float[torch.Tensor, "bh n d"],
    k: Float[torch.Tensor, "bh n d"],
    v: Float[torch.Tensor, "bh n d"],
    coords: Float[torch.Tensor, "bh n 2"],
    slopes: Float[torch.Tensor, "bh"],
    *,
    exempt_first: bool = True,
) -> torch.Tensor:
    """Pre-softmax 2-D-ALiBi flash attention (``stamp_tpu.ops.
    flash_attention.flash_alibi2d_mha``; forward only, as there).

    Args:
        q, k, v: [BH, N, d]; queries and keys share the sequence.
        coords: [BH, N, 2] positions (tile-grid units for TITAN).
        slopes: [BH] ALiBi slope per (batch·head).
        exempt_first: no bias on row 0 and column 0 (the CLS token).

    Returns: [BH, N, d] = softmax(q·kᵀ·d^-1/2 − slope·‖c_i − c_j‖)·v.  On
    CUDA every tensor is f32, contiguous and 16-byte aligned, d in
    (32, 64, 128).
    """
    if q.device.type == "cpu":
        return flash_alibi2d_mha_reference(q, k, v, coords, slopes, exempt_first=exempt_first)
    if q.device.type != "cuda":
        raise ValueError(f"flash_alibi2d_mha: unsupported device {q.device}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"flash_alibi2d_mha: q, k, v must be [BH, N, d], got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    bh, n, d = q.shape
    if d not in _FLASH_HEAD_DIMS:
        raise ValueError(f"flash_alibi2d_mha: head_dim {d} has no kernel instance {_FLASH_HEAD_DIMS}")
    if not (0 < bh <= 65535 and n > 0):
        raise ValueError(f"flash_alibi2d_mha: unsupported shape {tuple(q.shape)}")
    if coords.shape != (bh, n, 2) or slopes.shape != (bh,):
        raise ValueError(
            f"flash_alibi2d_mha: coords must be [{bh}, {n}, 2] and slopes [{bh}], got "
            f"{tuple(coords.shape)}, {tuple(slopes.shape)}"
        )
    for name, t in {"q": q, "k": k, "v": v, "coords": coords, "slopes": slopes}.items():
        if t.device != q.device:
            raise ValueError(f"flash_alibi2d_mha: {name} is on {t.device}, q on {q.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"flash_alibi2d_mha: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_alibi2d_mha: {name} must be contiguous and 16-byte aligned")
    workspace = _workspace("stamp_flash_alibi2d_workspace", "flash_alibi2d_mha", q.device, bh, n, d)
    out = torch.empty_like(q)
    err = _build.load_library().stamp_flash_alibi2d_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), coords.data_ptr(), slopes.data_ptr(), workspace.data_ptr(),
        out.data_ptr(), bh, n, d, d**-0.5, int(exempt_first), q.device.index,
        torch.cuda.current_stream(q.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "flash_alibi2d_mha")
    global FLASH_ALIBI2D_LAUNCHES
    FLASH_ALIBI2D_LAUNCHES += 1
    return out
