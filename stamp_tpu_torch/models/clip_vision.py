"""CLIP vision tower (PLIP), in PyTorch.

Counterpart of ``stamp_tpu.models.clip_vision``: OpenAI CLIP's image tower
as HF ``CLIPVisionModel`` ships it (bias-free patch convolution, class
embedding, learned positions, pre-LayerNorm, blocks with separate q/k/v
projections and quick-GELU MLPs, post-LayerNorm on the CLS token, then the
``visual_projection``).  Attention is plain einsum, as in the JAX package:
no kernel of the port runs here.

Submodules carry the flax tree's names (``models.towers``);
``convert_clip_vision_state_dict`` maps an HF CLIPModel checkpoint onto
them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
from torch import nn

from stamp_tpu_torch.models.towers import (
    init_random_weights_ as _init_tower_,
    merge_heads,
    numpy_state_dict,
    patchify,
    softmax_attention,
    split_heads,
    state_dict_from_flax,
)
from stamp_tpu_torch.models.vit_image import QuantDense


@dataclass(frozen=True)
class CLIPVisionConfig:
    img_size: int = 224
    patch_size: int = 32
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    projection_dim: int = 512
    norm_eps: float = 1e-5
    mean: tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    # QuantDense mode of the block matmuls: "off" | "observe" | "int8"
    quant: str = "off"


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class _CLIPBlock(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig) -> None:
        super().__init__()
        self.num_heads = cfg.num_heads
        dim = cfg.embed_dim
        self.norm1 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.q = QuantDense(dim, dim, mode=cfg.quant)
        self.k = QuantDense(dim, dim, mode=cfg.quant)
        self.v = QuantDense(dim, dim, mode=cfg.quant)
        self.out = QuantDense(dim, dim, mode=cfg.quant)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.fc1 = QuantDense(dim, cfg.mlp_dim, mode=cfg.quant)
        self.fc2 = QuantDense(cfg.mlp_dim, dim, mode=cfg.quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        q, k, v = (split_heads(proj(h), self.num_heads) for proj in (self.q, self.k, self.v))
        x = x + self.out(merge_heads(softmax_attention(q * q.shape[-1] ** -0.5, k, v)))
        return x + self.fc2(_quick_gelu(self.fc1(self.norm2(x))))


class CLIPVisionTower(nn.Module):
    """NHWC normalized images → image features [B, projection_dim]."""

    def __init__(self, cfg: CLIPVisionConfig) -> None:
        super().__init__()
        self.cfg = cfg
        n = (cfg.img_size // cfg.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, cfg.embed_dim, cfg.patch_size, cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(n + 1, cfg.embed_dim))
        self.pre_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", _CLIPBlock(cfg))
        self.post_norm = nn.LayerNorm(cfg.embed_dim, eps=cfg.norm_eps)
        self.projection = nn.Linear(cfg.embed_dim, cfg.projection_dim, bias=False)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = patchify(self.patch_embed, images)
        cls = self.class_embedding.expand(x.shape[0], 1, -1)
        x = self.pre_norm(torch.cat([cls, x], dim=1) + self.pos_embed)
        for i in range(self.cfg.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.projection(self.post_norm(x[:, 0]))


def init_random_weights_(model: CLIPVisionTower, generator: torch.Generator) -> CLIPVisionTower:
    """Seeded random weights with the flax module's distributions (class
    and position embeddings zero)."""
    return _init_tower_(model, generator)


def clip_quant_sites(depth: int) -> list[str]:
    """QuantDense sites of the CLIP tower (the projection head stays bf16)."""
    return [f"block_{i}.{name}" for i in range(depth) for name in ("q", "k", "v", "out", "fc1", "fc2")]


def convert_clip_vision_state_dict(state_dict: dict[str, Any], cfg: CLIPVisionConfig) -> dict[str, torch.Tensor]:
    """Map an HF CLIPModel state dict (vision tower + ``visual_projection``)
    onto ``CLIPVisionTower``'s; the JAX package's converter, copied."""
    sd = numpy_state_dict(state_dict)

    def t(name: str) -> np.ndarray:
        return sd[name]

    def ln(name: str) -> dict:
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    def dense(name: str) -> dict:
        return {"kernel": t(name + ".weight").T, "bias": t(name + ".bias")}

    vm = "vision_model."
    params: dict[str, Any] = {
        "patch_embed": {"kernel": t(vm + "embeddings.patch_embedding.weight").transpose(2, 3, 1, 0)},
        "class_embedding": t(vm + "embeddings.class_embedding"),
        "pos_embed": t(vm + "embeddings.position_embedding.weight"),
        "pre_norm": ln(vm + "pre_layrnorm"),
        "post_norm": ln(vm + "post_layernorm"),
        "projection": {"kernel": t("visual_projection.weight").T},
    }
    for i in range(cfg.depth):
        p = f"{vm}encoder.layers.{i}."
        params[f"block_{i}"] = {
            "norm1": ln(p + "layer_norm1"),
            "norm2": ln(p + "layer_norm2"),
            "q": dense(p + "self_attn.q_proj"),
            "k": dense(p + "self_attn.k_proj"),
            "v": dense(p + "self_attn.v_proj"),
            "out": dense(p + "self_attn.out_proj"),
            "fc1": dense(p + "mlp.fc1"),
            "fc2": dense(p + "mlp.fc2"),
        }
    return state_dict_from_flax({"params": params})
