"""Plain PyTorch training steps of STAMP's attention-MIL ViT, in float32.

The model (STAMP's ``VisionTransformer`` over tile features): a linear
projection of the tiles and GELU, a learned class token in front, pre-norm
blocks of multi-head softmax attention and a GELU feed-forward, each added
to its input, a final LayerNorm and a linear head on the class token.  Each
bag is whole (no padding, no mask), so the masking of a padded program is
checked, not copied.  The loss is −mean over the batch of Σ_c w_c·t_c·log p_c
with inverse-frequency class weights normalised to sum to one; the update
is AdamW (β 0.9, 0.999, ε 1e-8, weight decay 1e-2 on every parameter,
decoupled) at the learning rate of the cosine one-cycle schedule after
``count`` updates.  Parameters carry the program's names; nothing here
imports the program.

Dropout (the configuration's ``dropout``) keeps an element where a uniform
draw lies below 1 − rate and scales it by 1 / (1 − rate): after the
projection, on the attention weights, after the feed-forward's GELU and
after its second linear.  The uniform draws are replayed from a generator
the caller seeds as it seeded the program's: in the program's order and at
the program's shapes (a bag padded to ``padded`` tiles), each mask cut to
the bag's own rows and columns.

``dtype=torch.bfloat16`` is the control: the forward and backward in
bfloat16 (parameters and inputs cast, gradients back to float32), the
update in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.precision import float32_exact


def class_weights(labels: torch.Tensor, n_classes: int) -> torch.Tensor:
    counts = torch.bincount(labels, minlength=n_classes).double()
    reciprocal = counts.sum() / counts
    return (reciprocal / reciprocal.sum()).float()


def learning_rate(count: int, *, total_steps: int, max_lr: float, div_factor: float,
                  pct_start: float = 0.3, final_div_factor: float = 1e4) -> float:  # fmt: skip
    """The cosine one-cycle schedule (optax's) after ``count`` updates."""
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    values = [max_lr / div_factor, max_lr, max_lr / (div_factor * final_div_factor)]
    for i in range(2):
        if bounds[i] <= count < bounds[i + 1]:
            pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
            return values[i + 1] + (values[i] - values[i + 1]) / 2 * (math.cos(math.pi * pct) + 1)
    return values[-1]


def _norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[f"{name}.weight"], p[f"{name}.bias"], eps)


def _linear(x, p, name):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def _dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None, shape: tuple[int, ...]) -> torch.Tensor:
    """``x`` with the mask of one draw at ``shape`` (the program's), cut to ``x``'s own extent."""
    if generator is None or rate == 0.0:
        return x
    draw = torch.rand(shape, generator=generator, device=x.device)
    keep = draw[tuple(slice(0, n) for n in x.shape)] < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def forward(p: dict[str, torch.Tensor], bags: torch.Tensor, config: dict,
            generator: torch.Generator | None = None, padded: int | None = None) -> torch.Tensor:  # fmt: skip
    """bags [B, n, dim_input] → logits [B, n_classes]; with ``generator``
    (training) dropout's masks drawn as the program draws them for bags
    padded to ``padded`` tiles (n by default)."""
    eps, heads, rate = config["norm_eps"], config["n_heads"], config["dropout"]
    b, n = bags.shape[:2]
    tp = (padded or n) + 1  # the program's tokens: its padded tiles and the class token
    x = F.gelu(_linear(bags, p, "project"))
    d, f = x.shape[2], config["dim_feedforward"]
    x = _dropout(x, rate, generator, (b, tp - 1, d))
    x = torch.cat([p["class_token"].expand(b, 1, -1), x], dim=1)
    t = x.shape[1]
    for i in range(config["n_layers"]):
        blk = f"block_{i}."
        qkv = _linear(_norm(x, p, blk + "attn_norm", eps), p, blk + "mhsa.in_proj")
        q, k, v = qkv.reshape(b, t, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
        weights = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d // heads), dim=-1)
        weights = _dropout(weights, rate, generator, (b, heads, tp, tp))
        x = x + _linear((weights @ v).transpose(1, 2).reshape(b, t, d), p, blk + "mhsa.out_proj")
        h = _dropout(F.gelu(_linear(_norm(x, p, blk + "ff.norm", eps), p, blk + "ff.fc1")), rate, generator, (b, tp, f))
        x = x + _dropout(_linear(h, p, blk + "ff.fc2"), rate, generator, (b, tp, d))
    return _linear(_norm(x, p, "norm", eps)[:, 0], p, "head")


def loss_fn(logits: torch.Tensor, targets: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    return -torch.mean(torch.sum(targets * torch.log_softmax(logits.float(), dim=-1) * weights[None, :], dim=-1))


def train(params: dict[str, torch.Tensor], batches: list[tuple[torch.Tensor, torch.Tensor, int]],
          weights: torch.Tensor, config: dict, schedule: dict, dtype: torch.dtype = torch.float32, *,
          generator: torch.Generator | None = None, moments: tuple[dict, dict] | None = None,
          count: int = 0) -> dict:  # fmt: skip
    """Steps over ``batches`` ((bags [B, n, F], one-hot targets [B, C], the
    program's padded tiles) each) from ``params`` (and AdamW's ``moments``
    after ``count`` updates, or none): each step's loss and gradient and
    each parameter's change after the last step, float32."""
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 1e-2
    p = {name: t.detach().clone().float() for name, t in params.items()}
    if moments is None:
        m = {name: torch.zeros_like(t) for name, t in p.items()}
        v = {name: torch.zeros_like(t) for name, t in p.items()}
    else:
        m, v = ({name: t.detach().clone().float() for name, t in moment.items()} for moment in moments)
    losses, grads_by_step = [], []
    with float32_exact():
        for count, (bags, targets, padded) in enumerate(batches, start=count):
            leaves = {name: t.requires_grad_(True) for name, t in p.items()}
            cast = {name: t.to(dtype) for name, t in leaves.items()}
            logits = forward(cast, bags.to(dtype), config, generator, padded)
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
    change = {name: p[name].detach() - params[name].float() for name in p}
    return {"losses": losses, "grads": grads_by_step, "change": change}
