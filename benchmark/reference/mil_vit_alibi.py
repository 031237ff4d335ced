"""Plain PyTorch training steps of STAMP's spatial-ALiBi attention-MIL ViT, in float32.

The model is STAMP v2.5.0's ``vit`` with ``use_alibi: true``
(``src/stamp/modeling/models/vision_tranformer.py:34-154``): a linear
projection of the tiles and GELU, a learned class token in front, pre-norm
blocks of spatial-ALiBi attention and a GELU feed-forward, each added to its
input, a final LayerNorm and a linear head on the class token.  ALiBi
attention subtracts a learned per-head distance term after the softmax::

    out_h = (softmax(q_h·k_hᵀ/√d) − (bias_scale_h / running_mean_h)·D)·v_h

with D the µm distance between every pair of tokens, and in training every
layer first makes a Welford update of its per-head ``running_mean`` with the
bag's mean pairwise distance (``running_mean += (mean − running_mean) /
items_so_far``, then ``items_so_far += 1``) and uses the updated mean in the
same forward.  Loss and AdamW update are ``reference/mil_vit.py``'s.
Parameters and buffers carry the program's names; nothing here imports the
program.

Departures from upstream, each the program's too:

- The class token sits at coordinate (0, 0) and counts as a tile in the
  mean pairwise distance (the JAX package's placement).  The mean is over
  every ordered pair of the bag's tokens, a token with itself included.
- The mean is summed in float64 and computed once a step: every layer's
  update takes the same number (upstream computes it in each layer, from
  the same coordinates, in float32).  A batch's mean is the ratio of its
  bags' sums, as the program forms it.
- Each bag is whole (no padding, no mask), so the masking of a padded
  program is checked, not copied.
- Dropout (the configuration's ``dropout``) is replayed as
  ``reference/mil_vit.py`` replays it: after the projection and after the
  feed-forward's GELU and its second linear, drawn at the program's padded
  shapes.  There is no dropout on the attention weights, as upstream.
- Attention runs in blocks of ``block`` queries, each recomputed in the
  backward (``torch.utils.checkpoint``), so that no [heads, T, T] tensor
  is formed whole and a bag of 48,001 tokens fits on one card; a block's
  weights are formed as upstream forms them (the softmax less the scaled
  distances, then one product with V).

``dtype=torch.bfloat16`` is the control: the network's forward and
backward in bfloat16 (parameters, inputs and the distances cast), the
coordinates, the distance statistic and the update in float32 and float64.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.mil_vit import _dropout, _linear, _norm, class_weights, learning_rate, loss_fn
from benchmark.reference.precision import float32_exact

__all__ = ["attention", "class_weights", "forward", "learning_rate", "pairwise_distance_sums", "train"]

#: queries a block of attention (a [heads, BLOCK, T] f32 tensor: 1.5 GB at T = 48,001)
BLOCK = 1024
BUFFERS = ("running_mean", "items_so_far")


def _distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[A, B] Euclidean distances of [A, 2] and [B, 2], from per-axis differences."""
    return torch.sqrt((a[:, None, 0] - b[None, :, 0]) ** 2 + (a[:, None, 1] - b[None, :, 1]) ** 2)


def pairwise_distance_sums(coords: torch.Tensor, block: int = BLOCK) -> tuple[torch.Tensor, int]:
    """(the sum of the distances over every ordered pair of ``coords`` [T,
    2], summed in float64 in blocks of rows, the number of pairs T²)."""
    c = coords.double()
    total = c.new_zeros(())
    for start in range(0, len(c), block):
        total = total + _distances(c[start : start + block], c).sum()
    return total, len(c) ** 2


def _block_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cq: torch.Tensor, ck: torch.Tensor,
                     dist_scale: torch.Tensor) -> torch.Tensor:  # fmt: skip
    """One block of queries: q [H, b, d] against k, v [H, T, d]."""
    weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    weights = weights - dist_scale[:, None, None] * _distances(cq, ck).to(q.dtype)[None]
    return weights @ v


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, coords: torch.Tensor, dist_scale: torch.Tensor,
              block: int | None = BLOCK) -> torch.Tensor:  # fmt: skip
    """ALiBi attention of one bag: q, k, v [H, T, d], coords [T, 2], dist_scale
    [H] (bias_scale / running_mean) → [H, T, d].  In blocks of ``block``
    queries recomputed in the backward; ``block=None`` is the dense form,
    one [H, T, T] tensor."""
    if block is None:
        return _block_attention(q, k, v, coords, coords, dist_scale)
    outs = [checkpoint(_block_attention, q[:, s : s + block], k, v, coords[s : s + block], coords, dist_scale,
                       use_reentrant=False)  # fmt: skip
            for s in range(0, q.shape[1], block)]
    return torch.cat(outs, dim=1)


def forward(p: dict[str, torch.Tensor], buffers: dict[str, torch.Tensor], bags: torch.Tensor, coords: torch.Tensor,
            config: dict, generator: torch.Generator | None = None, padded: int | None = None, *,
            train: bool = False, block: int | None = BLOCK) -> torch.Tensor:  # fmt: skip
    """bags [B, n, dim_input] and their coordinates [B, n, 2] (µm) →
    logits [B, n_classes].  With ``generator``, dropout's masks drawn as the
    program draws them for bags padded to ``padded`` tiles (n by default);
    with ``train``, each layer's Welford update of ``buffers`` (float32
    tensors, updated in place) before its attention."""
    eps, heads, rate = config["norm_eps"], config["n_heads"], config["dropout"]
    b, n = bags.shape[:2]
    tp = (padded or n) + 1  # the program's tokens: its padded tiles and the class token
    x = F.gelu(_linear(bags, p, "project"))
    dtype, d, f = x.dtype, x.shape[2], config["dim_feedforward"]
    x = _dropout(x, rate, generator, (b, tp - 1, d))
    x = torch.cat([p["class_token"].expand(b, 1, -1), x], dim=1)
    coords = torch.cat([coords.new_zeros(b, 1, 2), coords], dim=1).float()  # the class token at (0, 0)
    t = x.shape[1]
    if train:
        sums = [pairwise_distance_sums(coords[j]) for j in range(b)]
        mean = sum(total for total, _ in sums) / sum(n for _, n in sums)
    for i in range(config["n_layers"]):
        blk = f"block_{i}."
        if train:
            with torch.no_grad():
                rm, items = buffers[blk + "mhsa.running_mean"], buffers[blk + "mhsa.items_so_far"]
                rm.copy_(rm.double() + (mean - rm.double()) / items.double())
                items.add_(1.0)
        h = _norm(x, p, blk + "attn_norm", eps)
        q, k, v = (_linear(h, p, blk + f"mhsa.{name}_proj").reshape(b, t, heads, d // heads).transpose(1, 2)
                   for name in ("q", "k", "v"))  # fmt: skip
        dist_scale = p[blk + "mhsa.bias_scale"] / buffers[blk + "mhsa.running_mean"].to(dtype)
        att = torch.stack([attention(q[j], k[j], v[j], coords[j], dist_scale, block) for j in range(b)])
        x = x + _linear(att.transpose(1, 2).reshape(b, t, d), p, blk + "mhsa.fc")
        hid = _dropout(F.gelu(_linear(_norm(x, p, blk + "ff.norm", eps), p, blk + "ff.fc1")), rate, generator,
                       (b, tp, f))  # fmt: skip
        x = x + _dropout(_linear(hid, p, blk + "ff.fc2"), rate, generator, (b, tp, d))
    return _linear(_norm(x, p, "norm", eps)[:, 0], p, "head")


def train(state: dict[str, torch.Tensor], batches: list[tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]],
          weights: torch.Tensor, config: dict, schedule: dict, dtype: torch.dtype = torch.float32, *,
          generator: torch.Generator | None = None, moments: tuple[dict, dict] | None = None, count: int = 0,
          block: int | None = BLOCK) -> dict:  # fmt: skip
    """Steps over ``batches`` ((bags [B, n, F], coordinates [B, n, 2],
    one-hot targets [B, C], the program's padded tiles) each) from
    ``state`` (parameters and the ALiBi buffers, by the program's names;
    and AdamW's ``moments`` of the parameters after ``count`` updates, or
    none): each step's loss and gradient, each parameter's change after the
    last step, and the buffers and AdamW's moments after it, float32."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-2
    buffers = {name: t.detach().clone().float() for name, t in state.items() if name.rsplit(".", 1)[-1] in BUFFERS}
    p = {name: t.detach().clone().float() for name, t in state.items() if name not in buffers}
    if moments is None:
        m = {name: torch.zeros_like(t) for name, t in p.items()}
        v = {name: torch.zeros_like(t) for name, t in p.items()}
    else:
        m, v = ({name: moment[name].detach().clone().float() for name in p} for moment in moments)
    losses, grads_by_step = [], []
    with float32_exact():
        for count, (bags, coords, targets, padded) in enumerate(batches, start=count):
            leaves = {name: t.requires_grad_(True) for name, t in p.items()}
            cast = {name: t.to(dtype) for name, t in leaves.items()}
            logits = forward(cast, buffers, bags.to(dtype), coords, config, generator, padded, train=True, block=block)
            loss = loss_fn(logits, targets, weights)
            grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
            losses.append(float(loss.detach()))
            grads_by_step.append({name: g.float() for name, g in grads.items()})
            lr = learning_rate(count, **schedule)
            with torch.no_grad():
                for name, g in grads.items():
                    g = g.float()
                    m[name] = b1 * m[name] + (1 - b1) * g
                    v[name] = b2 * v[name] + (1 - b2) * g * g
                    m_hat = m[name] / (1 - b1 ** (count + 1))
                    v_hat = v[name] / (1 - b2 ** (count + 1))
                    p[name] = p[name].detach() * (1 - lr * wd) - lr * m_hat / (v_hat.sqrt() + eps)
    change = {name: p[name].detach() - state[name].float() for name in p}
    return {"losses": losses, "grads": grads_by_step, "change": change, "buffers": buffers, "moments": (m, v)}
