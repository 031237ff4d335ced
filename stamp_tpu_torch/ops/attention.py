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
Inference only: the JAX module's attention dropout and the streamed mean
pairwise distance of ALiBi training are not ported yet.
"""

from __future__ import annotations

import math

import torch

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


def multi_head_attention(
    q: torch.Tensor,  # [B, H, Q, D]
    k: torch.Tensor,  # [B, H, K, D]
    v: torch.Tensor,  # [B, H, K, D]
    *,
    key_mask: torch.Tensor | None = None,  # [B, K] True = valid
) -> torch.Tensor:
    """Scaled-dot-product attention. Returns [B, H, Q, D]."""
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = key_mask[:, None, None, :] if key_mask is not None else None
    return torch.matmul(masked_softmax(logits, mask), v)


def pairwise_distances(coords_q: torch.Tensor, coords_k: torch.Tensor) -> torch.Tensor:
    """Euclidean distances [B, Q, K] of [B, Q, 2] and [B, K, 2] (torch.cdist
    p=2 semantics, from per-axis differences)."""
    diff = coords_q[:, :, None, :] - coords_k[:, None, :, :]
    return torch.sqrt(torch.clamp_min(torch.sum(diff * diff, dim=-1), 0.0))


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
    logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    mask = key_mask[:, None, None, :] if key_mask is not None else None
    weights = masked_softmax(logits, mask) - scaled_distances
    if mask is not None:
        weights = weights.masked_fill(~mask, 0.0)
    return torch.matmul(weights, v)
