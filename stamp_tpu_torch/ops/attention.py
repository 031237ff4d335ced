"""Attention primitives of the MIL transformers, in plain PyTorch.

Counterparts of ``stamp_tpu.ops.attention``'s ``masked_softmax``,
``multi_head_attention``, ``pairwise_distances`` and ``alibi_attention``: the
einsum path the MIL ViT takes below ``FLASH_ATTENTION_MIN_SEQ`` tiles (at or
above it, ``ops.flash_attention`` computes the same without a [T, T]
matrix).  Two details are the reference's and are kept:

* the spatial-ALiBi bias is subtracted from the attention weights *after*
  the softmax (reference vision_tranformer.py:65-70);
* distances come from per-axis differences, never from the Gram identity
  |a|² + |b|² − 2a·b, which cancels for nearby µm coordinates.

Invalid keys (``key_mask`` False) are excluded from the softmax and zeroed
afterwards, so a bucket-padded bag gives the result of the unpadded one.
Training adds attention dropout (drawn from an explicit generator; in a
step over a mesh the whole batch's masks, ``StepGroup.draw``) and
``pairwise_distance_sums``, the total and pair count of the ALiBi Welford
statistic, kept apart so that a step over a mesh sums them over ranks
before it divides: on the card one kernel (``csrc/alibi_stats.cu``), on the
CPU its plain version streamed in row blocks.  Queries and keys may differ in
number (``Q`` ≠ ``K``): under sequence parallelism a rank holds its own
share of the queries and the whole sequence's keys.
"""

from __future__ import annotations

import math

import torch

from stamp_tpu_torch.ops import _build
from stamp_tpu_torch.ops.step_group import SINGLE, StepGroup

_NEG_INF = -1e30
#: ``pairwise_distance_sums``'s kernel launches since the last reset (the main path's proof of use)
ALIBI_PAIR_SUMS_LAUNCHES = 0


def masked_softmax(
    logits: torch.Tensor, key_mask: torch.Tensor | None, dim: int = -1
) -> torch.Tensor:
    """Softmax over ``dim`` where invalid keys get zero weight; a plain
    softmax with ``key_mask=None``."""
    if key_mask is None:
        return torch.softmax(logits, dim=dim)
    weights = torch.softmax(logits.masked_fill(~key_mask, _NEG_INF), dim=dim)
    return weights.masked_fill(~key_mask, 0.0)


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: torch.Generator | None,
    group: StepGroup = SINGLE,
    *,
    seq_dim: int | None = None,
    lead: int = 0,
) -> torch.Tensor:
    """flax ``nn.Dropout``: keep each element with probability 1 − rate
    (a uniform draw below it) and scale the kept ones by 1 / (1 − rate).
    Identity without a generator (inference) or at rate 0.  In a step over
    a mesh the mask is this rank's part of the whole batch's draw
    (``group.draw``; ``seq_dim`` and ``lead`` say where x holds a share of
    the sequence)."""
    if rate == 0.0 or generator is None:
        return x

    def uniform(shape):
        return torch.rand(shape, generator=generator, device=x.device)

    keep = group.draw(x.shape, uniform, seq_dim=seq_dim, lead=lead) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def attention_weights(q: torch.Tensor, k: torch.Tensor, key_mask: torch.Tensor | None) -> torch.Tensor:
    """The masked softmax of q·kᵀ/√d, [B, H, Q, K] (``key_mask`` [B, K])."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    return masked_softmax(logits, key_mask[:, None, None, :] if key_mask is not None else None)


def multi_head_attention(
    q: torch.Tensor,  # [B, H, Q, D]
    k: torch.Tensor,  # [B, H, K, D]
    v: torch.Tensor,  # [B, H, K, D]
    *,
    key_mask: torch.Tensor | None = None,  # [B, K] True = valid
    dropout_rate: float = 0.0,
    generator: torch.Generator | None = None,  # training: dropout on the weights
    group: StepGroup = SINGLE,
    lead: int = 0,  # queries every rank holds before its share (the CLS token)
) -> torch.Tensor:
    """Scaled-dot-product attention. Returns [B, H, Q, D]."""
    weights = dropout(attention_weights(q, k, key_mask), dropout_rate, generator, group, seq_dim=2, lead=lead)
    return torch.matmul(weights, v)


def pairwise_distances(coords_q: torch.Tensor, coords_k: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [B, Q, K] of [B, Q, 2] and [B, K, 2] (torch.cdist
    p=2 semantics, from per-axis differences)."""
    diff = coords_q[:, :, None, :] - coords_k[:, None, :, :]
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))


def pairwise_distance_sums_reference(
    coords: torch.Tensor,
    *,
    mask: torch.Tensor | None = None,
    block: int = 512,
    coords_k: torch.Tensor | None = None,
    key_mask: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of ``pairwise_distance_sums``, in row blocks of
    ``block`` tiles (no [B, T, T] tensor), in the coordinates' dtype."""
    row_valid = mask.to(coords.dtype) if mask is not None else coords.new_ones(coords.shape[:2])
    if coords_k is None:
        coords_k, col_valid = coords, row_valid
    else:
        col_valid = key_mask.to(coords.dtype) if key_mask is not None else coords.new_ones(coords_k.shape[:2])
    total = coords.new_zeros(())
    for start in range(0, coords.shape[1], block):
        d = pairwise_distances(coords[:, start : start + block], coords_k)  # [B, block, K]
        rows = row_valid[:, start : start + block]
        total = total + torch.sum(d * rows[:, :, None] * col_valid[:, None, :])
    return total, torch.sum(torch.sum(row_valid, dim=1) * torch.sum(col_valid, dim=1))


def pairwise_distance_sums(
    coords: torch.Tensor,  # [B, T, 2]
    *,
    mask: torch.Tensor | None = None,  # [B, T] True = valid tile
    block: int = 512,
    coords_k: torch.Tensor | None = None,  # [B, K, 2]
    key_mask: torch.Tensor | None = None,  # [B, K]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the Euclidean distances over all ordered pairs of valid
    tiles, number of such pairs).  With ``mask`` (bucket-padded bags) only
    valid–valid pairs count.  The numerator and denominator of
    ``stamp_tpu/ops/attention.py:77-115`` (``mean_pairwise_distance``).

    With ``coords_k`` the pairs are (row of ``coords``, row of
    ``coords_k``), the latter valid where ``key_mask`` says: a rank's share
    of the rows against the whole sequence, whose sums over the sequence
    group are the whole bag's.

    On a CUDA tensor one kernel (``csrc/alibi_stats.cu``) reads the
    coordinates and masks once and returns both as float64 scalars (f32
    sums within a block, f64 across blocks); it takes f32 coordinates and
    bool masks, contiguous.  On the CPU the plain version streams row blocks
    of ``block`` tiles, in the coordinates' dtype."""
    if coords.device.type == "cpu":
        return pairwise_distance_sums_reference(coords, mask=mask, block=block, coords_k=coords_k, key_mask=key_mask)
    if coords.device.type != "cuda":
        raise ValueError(f"pairwise_distance_sums: unsupported device {coords.device}")
    if coords_k is None:
        coords_k, key_mask = coords, mask
    b, tq = coords.shape[:2]
    tk = coords_k.shape[1]
    if coords.shape != (b, tq, 2) or coords_k.shape != (b, tk, 2) or not (0 < b <= 65535 and tq > 0 and tk > 0):
        raise ValueError(
            f"pairwise_distance_sums: coords must be [B, T, 2] and coords_k [B, K, 2], got "
            f"{tuple(coords.shape)}, {tuple(coords_k.shape)}"
        )
    tensors = {"coords": (coords, None), "coords_k": (coords_k, None), "mask": (mask, (b, tq)),
               "key_mask": (key_mask, (b, tk))}  # fmt: skip
    for name, (t, mask_shape) in tensors.items():
        if t is None:
            continue
        if t.device != coords.device:
            raise ValueError(f"pairwise_distance_sums: {name} is on {t.device}, coords on {coords.device}")
        if mask_shape is not None and (t.dtype != torch.bool or t.shape != mask_shape):
            raise ValueError(f"pairwise_distance_sums: {name} must be bool {list(mask_shape)}, got {t.dtype} "
                             f"{tuple(t.shape)}")  # fmt: skip
        if mask_shape is None and t.dtype != torch.float32:
            raise TypeError(f"pairwise_distance_sums: the CUDA kernel takes float32, {name} is {t.dtype}")
        if not t.is_contiguous() or (mask_shape is None and t.data_ptr() % 8):
            aligned = "" if mask_shape else " and 8-byte aligned"
            raise ValueError(f"pairwise_distance_sums: {name} must be contiguous{aligned}")
    out = torch.zeros(2, dtype=torch.float64, device=coords.device)
    err = _build.load_library().stamp_alibi_pair_sums(
        coords.data_ptr(), None if mask is None else mask.data_ptr(), coords_k.data_ptr(),
        None if key_mask is None else key_mask.data_ptr(), out.data_ptr(), b, tq, tk,
        coords.device.index, torch.cuda.current_stream(coords.device).cuda_stream,
    )  # fmt: skip
    _build.check(err, "pairwise_distance_sums")
    global ALIBI_PAIR_SUMS_LAUNCHES
    ALIBI_PAIR_SUMS_LAUNCHES += 1
    return out[0], out[1]


def alibi_attention(
    q: torch.Tensor,  # [B, H, Q, D]
    k: torch.Tensor,  # [B, H, K, D]
    v: torch.Tensor,  # [B, H, K, D]
    *,
    scaled_distances: torch.Tensor,  # [B, H, Q, K], divided by running mean × bias_scale
    key_mask: torch.Tensor | None = None,  # [B, K] True = valid
) -> torch.Tensor:
    """Spatial-ALiBi attention with the reference's post-softmax bias:
    weights = softmax(QKᵀ/√d) − scaled_distances.  (The JAX function's
    ``alibi_mask``, which no caller of the port passes, is not ported.)"""
    weights = attention_weights(q, k, key_mask) - scaled_distances
    if key_mask is not None:
        weights = weights.masked_fill(~key_mask[:, None, None, :], 0.0)
    return torch.matmul(weights, v)
