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
statistic streamed in row blocks, kept apart so that a step over a mesh
sums them over ranks before it divides.  Queries and keys may differ in
number (``Q`` ≠ ``K``): under sequence parallelism a rank holds its own
share of the queries and the whole sequence's keys.
"""

from __future__ import annotations

import math

import torch

from stamp_tpu_torch.ops.step_group import SINGLE, StepGroup

_NEG_INF = -1e30


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


def pairwise_distance_sums(
    coords: torch.Tensor,  # [B, T, 2]
    *,
    mask: torch.Tensor | None = None,  # [B, T] True = valid tile
    block: int = 512,
    coords_k: torch.Tensor | None = None,  # [B, K, 2]
    key_mask: torch.Tensor | None = None,  # [B, K]
) -> tuple[torch.Tensor, torch.Tensor]:
    """(sum of the Euclidean distances over all ordered pairs of valid
    tiles, number of such pairs), in row blocks of ``block`` tiles (no
    [B, T, T] tensor).  With ``mask`` (bucket-padded bags) only valid–valid
    pairs count.  The numerator and denominator of
    ``stamp_tpu/ops/attention.py:77-115`` (``mean_pairwise_distance``).

    With ``coords_k`` the pairs are (row of ``coords``, row of
    ``coords_k``), the latter valid where ``key_mask`` says: a rank's share
    of the rows against the whole sequence, whose sums over the sequence
    group are the whole bag's."""
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
