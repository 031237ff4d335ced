"""TICON tile-contextualizer encoder, in PyTorch.

Counterpart of ``stamp_tpu.models.ticon``: a per-source input-projection
MLP feeding a 6-block, 1536-d, 24-head transformer whose attention adds the
classic ALiBi bias ``−slope_h · euclid_dist(coords)`` to the logits *before*
the softmax, SiLU-gated MLPs (hidden 16/3·d, packed halves), LayerScale
residuals and a final encoder norm.  The attention and its bias are plain
einsum, as in the JAX package (not the port's TITAN kernel).

Submodules carry the flax tree's names (``models.towers``);
``convert_ticon_state_dict`` maps the TICON backbone checkpoint onto them.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models.towers import (
    init_random_weights_ as _init_tower_,
    merge_heads,
    numpy_state_dict,
    softmax_attention,
    split_heads,
    state_dict_from_flax,
)
from stamp_tpu_torch.models.vit_image import QuantDense


def get_slopes(n: int) -> list[float]:
    """ALiBi head slopes (Press et al., 2021)."""

    def power_of_2(n: int) -> list[float]:
        start = 2 ** (-(2 ** -(math.log2(n) - 3)))
        return [start * start**i for i in range(n)]

    if math.log2(n).is_integer():
        return power_of_2(n)
    closest = 2 ** math.floor(math.log2(n))
    return power_of_2(closest) + get_slopes(2 * closest)[0::2][: n - closest]


class _TiconAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, quant: str) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = QuantDense(dim, dim, mode=quant)
        self.k_proj = QuantDense(dim, dim, mode=quant)
        self.v_proj = QuantDense(dim, dim, mode=quant)
        self.proj = QuantDense(dim, dim, mode=quant)

    def forward(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:  # [B, N, D], [B, N, 2]
        q, k, v = (split_heads(proj(x), self.num_heads) for proj in (self.q_proj, self.k_proj, self.v_proj))
        diff = coords[:, :, None, :] - coords[:, None, :, :]
        dist = torch.sqrt(torch.clamp_min((diff * diff).sum(-1), 0.0))  # [B, N, N]
        slopes = torch.tensor(get_slopes(self.num_heads), dtype=x.dtype, device=x.device)
        bias = -slopes[None, :, None, None] * dist[:, None]
        out = softmax_attention(q, k, v, logit_divisor=math.sqrt(q.shape[-1]), bias=bias)
        return self.proj(merge_heads(out))


class _TiconMlp(nn.Module):
    """fc1 → halves → silu(x1)·x2 → fc2, hidden 16/3·dim."""

    def __init__(self, dim: int, quant: str) -> None:
        super().__init__()
        hidden = int(dim * 16 / 3)
        self.fc1 = QuantDense(dim, hidden, mode=quant)
        self.fc2 = QuantDense(hidden // 2, dim, mode=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.fc1(x).chunk(2, dim=-1)
        return self.fc2(F.silu(x1) * x2)


class _TiconBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, quant: str) -> None:
        super().__init__()
        self.gamma1 = nn.Parameter(torch.ones(dim))
        self.gamma2 = nn.Parameter(torch.ones(dim))
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _TiconAttention(dim, num_heads, quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = _TiconMlp(dim, quant)

    def forward(self, x: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        x = x + self.gamma1 * self.attn(self.norm1(x), coords)
        return x + self.gamma2 * self.mlp(self.norm2(x))


class _ProjectionMlp(nn.Module):
    """fc1 → silu → fc2 → LayerNorm."""

    def __init__(self, in_dim: int, hidden: int, out: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(in_dim, hidden)
        self.fc2 = nn.Linear(hidden, out)
        self.norm = nn.LayerNorm(out, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.norm(self.fc2(F.silu(self.fc1(x))))


#: the encoder's block count (the reference's ``out_layer``, its last)
DEPTH = 6


class TiconEncoder(nn.Module):
    """input_proj → ``depth`` ALiBi blocks → enc_norm; [B, N, in_dim]
    features and [B, N, 2] coordinates → [B, N, embed_dim]."""

    def __init__(
        self, embed_dim: int = 1536, depth: int = DEPTH, num_heads: int = 24, in_dim: int = 1536, quant: str = "off"
    ) -> None:
        super().__init__()
        self.depth = depth
        self.input_proj = _ProjectionMlp(in_dim, embed_dim, embed_dim)
        for i in range(depth):
            self.add_module(f"block_{i}", _TiconBlock(embed_dim, num_heads, quant))
        self.enc_norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, feats: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
        x = self.input_proj(feats)
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x, coords)
        return self.enc_norm(x)


def init_random_weights_(model: TiconEncoder, generator: torch.Generator) -> TiconEncoder:
    """Seeded random weights with the flax module's distributions (the
    LayerScale gammas one)."""
    return _init_tower_(model, generator, {"gamma1": ("constant", 1.0), "gamma2": ("constant", 1.0)})


def ticon_quant_sites(depth: int) -> list[str]:
    """QuantDense sites of the TICON encoder (the input projection stays bf16)."""
    return [
        f"block_{i}.{site}"
        for i in range(depth)
        for site in ("attn.q_proj", "attn.k_proj", "attn.v_proj", "attn.proj", "mlp.fc1", "mlp.fc2")
    ]


def convert_ticon_state_dict(
    state_dict: dict[str, Any], *, tile_encoder_key: str = "hoptimus1", depth: int = DEPTH
) -> dict[str, torch.Tensor]:
    """Map the TICON backbone checkpoint (``backbone.`` prefix stripped) onto
    ``TiconEncoder``'s state dict; the JAX package's converter, copied."""
    sd = numpy_state_dict(state_dict)

    def t(name: str) -> np.ndarray:
        return sd[name]

    def ln(name: str) -> dict:
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    def dense(name: str) -> dict:
        return {"kernel": t(name + ".weight").T, "bias": t(name + ".bias")}

    ip = f"input_proj_dict.input_proj_{tile_encoder_key}."
    params: dict[str, Any] = {
        "input_proj": {"fc1": dense(ip + "fc1"), "fc2": dense(ip + "fc2"), "norm": ln(ip + "norm")},
        "enc_norm": ln("enc_norm"),
    }
    for i in range(depth):
        p = f"encoder.blocks.{i}."
        params[f"block_{i}"] = {
            "gamma1": t(p + "residual1.gamma"),
            "gamma2": t(p + "residual2.gamma"),
            "norm1": ln(p + "residual1.norm"),
            "norm2": ln(p + "residual2.norm"),
            "attn": {
                name: dense(p + f"residual1.fn.{name}") for name in ("q_proj", "k_proj", "v_proj", "proj")
            },
            "mlp": {"fc1": dense(p + "residual2.fn.fc1"), "fc2": dense(p + "residual2.fn.fc2")},
        }
    return state_dict_from_flax({"params": params})
