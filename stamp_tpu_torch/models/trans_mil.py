"""TransMIL with Nyström linear attention.

Counterpart of ``stamp_tpu/models/trans_mil.py:24-217``: the tiles projected
(Linear → ReLU), the square grid filled by repeating the first
``side² − n`` tokens, a CLS token prepended, two Nyström attention blocks
around the PPEG positional encoding (depthwise 7/5/3 convolutions on the
grid), LayerNorm (ε = 1e-6, flax's) and the CLS head.  The details that
decide the numbers are the JAX module's:

* the sequence is padded on the *left* to a multiple of the landmarks, and
  the last ``n`` outputs kept;
* ``moore_penrose_iter_pinv`` scales by the *global* max of the column and
  row sums, over batch and heads (in a step over a mesh, over the whole
  batch's ranks: ``StepGroup.max``), then takes six Newton–Schulz steps;
* the residual convolution is 33 × 1 over (sequence, head width), one
  filter per head, without bias; PPEG's convolutions have biases.

The depthwise convolutions are sums of shifted products in f32
(:class:`DepthwiseConv2d`), not cuDNN calls: neither TF32 nor any global
flag touches them, forward or backward.  Attention dropout (0.1 after
``to_out``, the JAX module's fixed rate) draws from the caller's
``generator`` in training.  The submodules carry the JAX tree's names;
a convolution's flax ``{name}_kernel`` [kh, kw, 1, C] is the port's
``{name}.weight`` [C, 1, kh, kw] (and ``{name}_bias`` its ``bias``).
TransMIL takes no coordinates and no key mask (``supports_coords`` False).

Under sequence parallelism (a ``group`` with ``seq_parts`` > 1) each rank
projects its share of the tiles (``fc1``, the one per-tile layer) and then
gathers the projected tokens of the whole bag (``group.gather_seq``, whose
backward reduce-scatters their gradient to the owners).  Every layer after
it needs the whole sequence: the square grid's filler repeats the bag's
first tokens, the sequence is padded on the left to a multiple of the
landmarks, the landmarks pool groups that straddle any split, and PPEG
convolves the grid.  So each rank runs them on the whole sequence, and the
output is the same on every rank; the step counts its gradient once
(``parallel.mesh``).  The dropout draws cover the whole sequence on every
rank, as without sharding.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import weights
from stamp_tpu_torch.ops.attention import dropout
from stamp_tpu_torch.ops.step_group import SINGLE, StepGroup

_EPS = 1e-6  # flax LayerNorm's default epsilon


def moore_penrose_iter_pinv(x: torch.Tensor, iters: int = 6, group: StepGroup = SINGLE) -> torch.Tensor:
    """Iterative Moore–Penrose pseudo-inverse of [..., n, n] (reference
    trans_mil.py:23-37)."""
    abs_x = x.abs()
    col = abs_x.sum(dim=-1)
    row = abs_x.sum(dim=-2)
    # maxima over the whole batch (in a step over a mesh, over the ranks)
    z = x.transpose(-1, -2) / (group.max(col.max()) * group.max(row.max()))
    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)[None]
    for _ in range(iters):
        xz = x @ z
        z = 0.25 * z @ (13 * eye - (xz @ (15 * eye - (xz @ (7 * eye - xz)))))
    return z


class DepthwiseConv2d(nn.Module):
    """``nn.Conv2d(C, C, (kh, kw), padding=(kh // 2, kw // 2), groups=C)``
    (same ``weight`` [C, 1, kh, kw] and ``bias``), computed as kh·kw shifted
    products of the zero-padded input summed in f32."""

    def __init__(self, channels: int, kernel_size: tuple[int, int], *, bias: bool) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(channels, 1, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, H, W]
        kh, kw = self.weight.shape[-2:]
        h, w = x.shape[-2:]
        padded = F.pad(x, (kw // 2, kw // 2, kh // 2, kh // 2))
        out = None
        for i in range(kh):
            for j in range(kw):
                term = padded[..., i : i + h, j : j + w] * self.weight[:, 0, i, j, None, None]
                out = term if out is None else out + term
        return out if self.bias is None else out + self.bias[:, None, None]


class NystromAttention(nn.Module):
    """Nyström approximation of self-attention (reference trans_mil.py:43-163)."""

    def __init__(
        self,
        dim: int,
        *,
        dim_head: int = 64,
        heads: int = 8,
        num_landmarks: int = 256,
        pinv_iterations: int = 6,
        residual_conv_kernel: int = 33,
        dropout: float = 0.0,
    ) -> None:
        super().__init__()
        self.heads, self.dim_head, self.num_landmarks = heads, dim_head, num_landmarks
        self.pinv_iterations = pinv_iterations
        self.dropout = dropout
        inner_dim = heads * dim_head
        self.to_qkv = nn.Linear(dim, inner_dim * 3, bias=False)
        self.to_out = nn.Linear(inner_dim, dim)
        self.res_conv = DepthwiseConv2d(heads, (residual_conv_kernel, 1), bias=False)

    def forward(
        self, x: torch.Tensor, *, generator: torch.Generator | None = None, group: StepGroup = SINGLE
    ) -> torch.Tensor:
        b, n, _ = x.shape
        h, m, dh = self.heads, self.num_landmarks, self.dim_head
        if remainder := n % m:  # pad on the LEFT (reference F.pad(x, (0, 0, pad, 0)))
            x = F.pad(x, (0, 0, m - remainder, 0))
        n_padded = x.shape[1]
        q, k, v = (
            t.reshape(b, n_padded, h, dh).transpose(1, 2) for t in self.to_qkv(x).chunk(3, dim=-1)
        )  # [b, h, n_padded, dh]
        q = q * dh**-0.5

        # landmarks: sum-pool groups of l = ceil(n / m) tokens
        l = math.ceil(n / m)
        groups = n_padded // l
        q_land = q.reshape(b, h, groups, l, dh).sum(dim=3) / l
        k_land = k.reshape(b, h, groups, l, dh).sum(dim=3) / l

        attn1 = torch.softmax(q @ k_land.transpose(-1, -2), dim=-1)
        attn2 = torch.softmax(q_land @ k_land.transpose(-1, -2), dim=-1)
        attn3 = torch.softmax(q_land @ k.transpose(-1, -2), dim=-1)
        attn2_inv = moore_penrose_iter_pinv(attn2, self.pinv_iterations, group)

        out = (attn1 @ attn2_inv) @ (attn3 @ v) + self.res_conv(v)  # conv over (sequence, head width)
        out = self.to_out(out.transpose(1, 2).reshape(b, n_padded, h * dh))
        return dropout(out, self.dropout, generator, group)[:, -n:]


class TransLayer(nn.Module):
    """x + NystromAttention(LayerNorm(x)) (reference trans_mil.py:245-263)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=_EPS)
        self.attn = NystromAttention(dim, dim_head=dim // 8, heads=8, num_landmarks=dim // 2, dropout=0.1)

    def forward(
        self, x: torch.Tensor, *, generator: torch.Generator | None = None, group: StepGroup = SINGLE
    ) -> torch.Tensor:
        return x + self.attn(self.norm(x), generator=generator, group=group)


class PPEG(nn.Module):
    """Pyramid positional-encoding generator: depthwise 7/5/3 convolutions
    with bias on the square token grid (reference trans_mil.py:266-283)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.proj = DepthwiseConv2d(dim, (7, 7), bias=True)
        self.proj1 = DepthwiseConv2d(dim, (5, 5), bias=True)
        self.proj2 = DepthwiseConv2d(dim, (3, 3), bias=True)

    def forward(self, x: torch.Tensor, side: int) -> torch.Tensor:
        b, _, c = x.shape
        cls_token, feat_token = x[:, :1], x[:, 1:]
        img = feat_token.transpose(1, 2).reshape(b, c, side, side)  # token i at row i // side
        out = self.proj(img) + img + self.proj1(img) + self.proj2(img)
        return torch.cat([cls_token, out.flatten(2).transpose(1, 2)], dim=1)


class TransMIL(nn.Module):
    """Reference trans_mil.py:286-326."""

    supports_coords = False

    def __init__(self, *, dim_output: int, dim_input: int, dim_hidden: int = 512) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim_input, dim_hidden)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, dim_hidden))
        self.layer1 = TransLayer(dim_hidden)
        self.pos_layer = PPEG(dim_hidden)
        self.layer2 = TransLayer(dim_hidden)
        self.norm = nn.LayerNorm(dim_hidden, eps=_EPS)
        self.fc2 = nn.Linear(dim_hidden, dim_output)

    def forward(
        self,
        h: torch.Tensor,
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        group: StepGroup = SINGLE,  # a step's collectives; a share of the bag under sp
    ) -> torch.Tensor:  # [B, T, F] → [B, out]
        if train and generator is None:
            raise ValueError("training draws the attention dropout from a generator; pass one")
        generator = generator if train else None
        h = group.gather_seq(F.relu(self.fc1(h)), dim=1)  # the whole bag from here on
        n = h.shape[1]
        side = int(math.ceil(math.sqrt(n)))
        h = torch.cat([h, h[:, : side * side - n]], dim=1)
        h = torch.cat([self.cls_token.expand(h.shape[0], 1, -1), h], dim=1)
        h = self.layer1(h, generator=generator, group=group)
        h = self.pos_layer(h, side)
        h = self.layer2(h, generator=generator, group=group)
        return self.fc2(self.norm(h)[:, 0])

    @staticmethod
    def model_params_keys() -> list[str]:
        return ["dim_hidden"]


_CONVS = ("res_conv", "proj", "proj1", "proj2")


def variables_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX module's variables → a ``state_dict`` of :class:`TransMIL`:
    ``models.weights``' rule, and each convolution's HWIO kernel as its
    [C, 1, kh, kw] weight."""
    state: dict[str, torch.Tensor] = {}
    for name, value in weights.state_dict_from_tree(variables).items():
        module, _, leaf = name.rpartition(".")
        conv, _, part = leaf.rpartition("_")
        if conv in _CONVS:
            if part == "kernel":
                part, value = "weight", value.permute(3, 2, 0, 1).contiguous()
            name = ".".join(filter(None, (module, conv, part)))
        state[name] = value
    return state


def variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The exact inverse of :func:`variables_from_jax`."""
    renamed: dict[str, torch.Tensor] = {}
    for name, tensor in state_dict.items():
        *module, conv, leaf = ["", *name.split(".")]
        if conv in _CONVS:
            if leaf == "weight":
                leaf, tensor = "kernel", tensor.permute(2, 3, 1, 0).contiguous()
            name = ".".join([*module[1:], f"{conv}_{leaf}"])
        renamed[name] = tensor
    return weights.tree_from_state_dict(renamed)


def init_random_weights_(model: TransMIL, generator: torch.Generator) -> TransMIL:
    """flax's initializers' distributions (kernels ``lecun_normal``, the
    convolutions' with fan-in kh·kw, biases zero, the CLS token N(0, 1)),
    drawn on the CPU from ``generator``; the values differ from flax's."""
    weights.init_layers_(model, generator)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, DepthwiseConv2d):
                weights.lecun_normal_(module.weight, module.weight[0].numel(), generator)
                if module.bias is not None:
                    module.bias.zero_()
        model.cls_token.normal_(0.0, 1.0, generator=generator)
    return model
