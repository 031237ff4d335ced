"""GigaPath's slide encoder (LongNetViT), in PyTorch.

Counterpart of ``sincos_position_embedding``, ``_LongNetBlock``,
``LongNetViT`` and ``convert_gigapath_slide_state_dict`` in
``stamp_tpu/models/slide_encoders.py`` (lines 208-295 and 506-528), split
from ``models/slide_encoders.py`` to keep that file short.
``gigapath_slide_enc12l768d``: 1536-d tile features projected to 768, 2-D
sin-cos position embeddings of the (float) tile-grid coordinates, a CLS
token, 12 pre-LN blocks of 12 heads whose attention is LongNet's dilated
attention (``ops.dilated_attention``; segments 128, 512, 2048, 8192 at
dilations 1, 2, 4, 8, three heads each), a final LayerNorm and the mean
over the tile tokens.

The sin-cos frequencies ``1 / 10000^(i/quarter)`` are formed on the CPU
from the correctly rounded f32 power (the power in f64, rounded once), as
barspoon's are: a card's f32 ``pow`` may be an ulp off.  Submodules are
named after the JAX module's flax tree; ``gigapath_state_dict`` is the JAX
package's upstream converter (torchscale's names, q/k/v packed into one
qkv projection), copied.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import weights
from stamp_tpu_torch.models.slide_encoders import _linear, _ln, _strip_prefixes, _t
from stamp_tpu_torch.ops.dilated_attention import dilated_attention


def sincos_frequencies(quarter: int) -> torch.Tensor:
    """``1 / 10000^(i / quarter)``, i = 0 … quarter − 1, as f32 on the CPU:
    the exponent an f32 quotient and the reciprocal an f32 division, as the
    JAX module forms them, the power correctly rounded to f32."""
    exponent = torch.arange(quarter, dtype=torch.float32) / quarter
    return 1.0 / torch.pow(10000.0, exponent.double()).float()


def sincos_position_embedding(coords: torch.Tensor, dim: int) -> torch.Tensor:
    """[N, 2] continuous coordinates → [N, dim]: x in the first half, y in
    the second, each [sin | cos] of ``dim/4`` geometric frequencies."""
    freqs = sincos_frequencies(dim // 4).to(coords.device)

    def encode(pos: torch.Tensor) -> torch.Tensor:
        angles = pos[:, None] * freqs[None, :]
        return torch.cat([torch.sin(angles), torch.cos(angles)], dim=-1)

    return torch.cat([encode(coords[:, 0]), encode(coords[:, 1])], dim=-1)


class _LongNetBlock(nn.Module):
    def __init__(
        self,
        dim: int,
        num_heads: int,
        segment_lengths: tuple[int, ...],
        dilation_rates: tuple[int, ...],
        mlp_ratio: float = 4.0,
    ) -> None:
        super().__init__()
        self.num_heads, self.segment_lengths, self.dilation_rates = num_heads, segment_lengths, dilation_rates
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.fc2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [N, dim]
        n, dim = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(n, 3, self.num_heads, dim // self.num_heads).permute(1, 2, 0, 3)
        out = dilated_attention(
            qkv[0], qkv[1], qkv[2], segment_lengths=self.segment_lengths, dilation_rates=self.dilation_rates
        )  # [H, N, head_dim]
        x = x + self.proj(out.transpose(0, 1).reshape(n, dim))
        return x + self.fc2(F.gelu(self.fc1(self.norm2(x))))


class LongNetViT(nn.Module):
    """GigaPath slide encoder: a dilated-attention ViT over tile
    embeddings, mean-pooled."""

    def __init__(
        self,
        dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        segment_lengths: tuple[int, ...] = (128, 512, 2048, 8192),
        dilation_rates: tuple[int, ...] = (1, 2, 4, 8),
        input_dim: int = 1536,
    ) -> None:
        super().__init__()
        self.dim, self.depth = dim, depth
        self.patch_embed = nn.Linear(input_dim, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, dim))
        for i in range(depth):
            self.add_module(f"block_{i}", _LongNetBlock(dim, num_heads, segment_lengths, dilation_rates))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, feats: torch.Tensor, grid_coords: torch.Tensor) -> torch.Tensor:
        """feats [N, input_dim]; grid_coords [N, 2] in tile-grid units
        (pixel coordinates over the tile size, not truncated) → [dim]."""
        x = self.patch_embed(feats)
        x = x + sincos_position_embedding(grid_coords.float(), self.dim).to(x.dtype)
        x = torch.cat([self.cls_token, x])
        for i in range(self.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.norm(x)[1:].mean(dim=0)  # the patch tokens' mean


def gigapath_variables_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``stamp_tpu`` LongNetViT variable tree → this module's state dict."""
    return weights.state_dict_from_tree(variables)


def gigapath_variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`gigapath_variables_from_jax` (numpy leaves)."""
    return weights.tree_from_state_dict(state_dict)


def _packed_qkv(sd: Mapping[str, np.ndarray], base: str) -> dict:
    """Separate q/k/v projections packed into one qkv Dense."""
    names = ("q_proj", "k_proj", "v_proj")
    return {
        "kernel": np.concatenate([_t(sd, f"{base}.{n}.weight") for n in names], axis=0).T,
        "bias": np.concatenate([_t(sd, f"{base}.{n}.bias") for n in names]),
    }


def gigapath_state_dict(state_dict: Mapping[str, Any], depth: int = 12) -> dict[str, torch.Tensor]:
    """An upstream GigaPath slide-encoder checkpoint → this module's state
    dict: the JAX package's ``convert_gigapath_slide_state_dict``
    (``patch_embed.proj`` or ``patch_embed``, ``cls_token``,
    ``encoder.layer_norm`` or ``norm``, per layer torchscale's
    ``self_attn_layer_norm / self_attn.{q,k,v,out}_proj / final_layer_norm
    / ffn.{fc1,fc2}``), then the flax rule."""
    sd = _strip_prefixes(state_dict)
    params: dict[str, Any] = {
        "patch_embed": _linear(sd, "patch_embed.proj", "patch_embed"),
        "cls_token": _t(sd, "cls_token").reshape(1, -1),
        "norm": _ln(sd, "encoder.layer_norm", "norm"),
    }
    for i in range(depth):
        p = f"encoder.layers.{i}."
        params[f"block_{i}"] = {
            "norm1": _ln(sd, p + "self_attn_layer_norm"),
            "qkv": _packed_qkv(sd, p + "self_attn"),
            "proj": _linear(sd, p + "self_attn.out_proj"),
            "norm2": _ln(sd, p + "final_layer_norm"),
            "fc1": _linear(sd, p + "ffn.fc1"),
            "fc2": _linear(sd, p + "ffn.fc2"),
        }
    return gigapath_variables_from_jax({"params": params})
