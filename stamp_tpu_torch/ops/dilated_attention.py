"""LongNet dilated attention (GigaPath's slide encoder), in plain PyTorch.

Counterpart of ``stamp_tpu/ops/dilated_attention.py`` (plain JAX there too:
no Pallas kernel).  For each (segment length w, dilation r) pair the
sequence is cut into segments of length w, and inside a segment position i
attends only to the positions of its sparse group i mod r (Ding et al.,
*LongNet*, 2023).  The heads are split evenly across the configurations.
Each configuration regroups [H, L, D] into dense [H, n_seg, r, w/r, D]
blocks and runs ordinary softmax attention inside each block, so the work
is batched matmuls with no [L, L] matrix.

The layout is the JAX package's, element for element: position i of a
segment lies in group i mod r at offset i // r; a configuration pads the
sequence only to ``w_eff = min(w, ⌈L / 8r⌉·8r)`` and then to a multiple of
``w_eff``; padded keys get a −1e30 logit, padded queries are computed and
dropped.  ``dilated_attention_reference`` is the naive masked form the
tests hold both to.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_NEG_INF = -1e30


def _segment_dilated(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: int, r: int, n_valid: int
) -> torch.Tensor:
    """Softmax attention within segments of length ``w`` at dilation ``r``
    on [H, L, D] (L a multiple of w); keys at positions ≥ ``n_valid`` are
    padding and masked."""
    h, L, d = q.shape
    n_seg, sub = L // w, w // r

    def regroup(t: torch.Tensor) -> torch.Tensor:
        # [H, L, D] → [H, n_seg, r, sub, D]: position i of segment s is in
        # sparse group i % r at offset i // r
        return t.reshape(h, n_seg, sub, r, d).transpose(2, 3)

    qg, kg, vg = regroup(q), regroup(k), regroup(v)
    logits = torch.matmul(qg * d**-0.5, kg.transpose(-1, -2))  # [H, n_seg, r, sub, sub]
    if n_valid < L:
        # global position of regrouped element (s, g, j) = s·w + g + j·r
        seg = torch.arange(n_seg, device=q.device)[:, None, None]
        grp = torch.arange(r, device=q.device)[None, :, None]
        off = torch.arange(sub, device=q.device)[None, None, :]
        valid = (seg * w + grp + off * r) < n_valid  # [n_seg, r, sub]
        logits = torch.where(valid[None, :, :, None, :], logits, _NEG_INF)
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.matmul(weights, vg)
    return out.transpose(2, 3).reshape(h, L, d)


def dilated_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    segment_lengths: tuple[int, ...],
    dilation_rates: tuple[int, ...],
) -> torch.Tensor:
    """[H, L, D] → [H, L, D]: head group i attends with
    ``(segment_lengths[i], dilation_rates[i])``.  A sequence shorter than a
    segment uses one segment rounded up to 8·r instead of the full w (the
    mask, same segment and same sparse group, is unchanged)."""
    h, L, d = q.shape
    n_cfg = len(segment_lengths)
    if len(dilation_rates) != n_cfg or h % n_cfg:
        raise ValueError(
            f"{h} heads over {n_cfg} segment lengths and {len(dilation_rates)} dilation rates: "
            "one rate a segment length, and the heads must divide evenly across them"
        )
    hc = h // n_cfg
    outs = []
    for i, (w, r) in enumerate(zip(segment_lengths, dilation_rates)):
        unit = r * 8  # keeps sub = w/r integral, as in the JAX package
        w_eff = min(w, -(-L // unit) * unit)
        pad = (-L) % w_eff
        qi, ki, vi = (t[i * hc : (i + 1) * hc] for t in (q, k, v))
        if pad:
            qi, ki, vi = (F.pad(t, (0, 0, 0, pad)) for t in (qi, ki, vi))
        outs.append(_segment_dilated(qi, ki, vi, w_eff, r, L)[:, :L])
    return torch.cat(outs, dim=0)


def dilated_attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, w: int, r: int) -> torch.Tensor:
    """Naive masked form of one (w, r) configuration (the test oracle)."""
    L, d = q.shape[1], q.shape[2]
    idx = torch.arange(L, device=q.device)
    mask = ((idx[:, None] // w) == (idx[None, :] // w)) & ((idx[:, None] % r) == (idx[None, :] % r))
    logits = torch.matmul(q * d**-0.5, k.transpose(-1, -2))
    weights = torch.softmax(torch.where(mask, logits, _NEG_INF), dim=-1)
    return torch.matmul(torch.where(mask, weights, 0.0), v)
