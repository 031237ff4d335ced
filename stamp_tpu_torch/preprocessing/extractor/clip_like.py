"""CLIP-family extractor factories, in PyTorch: PLIP (CLIP ViT-B/32) and
KEEP (the ``uni`` ViT-L/16 plus a projection head).

Counterpart of ``stamp_tpu.preprocessing.extractor.clip_like``.  PLIP's
tower (``models.clip_vision``) is plain PyTorch; KEEP's trunk is the port's
ImageViT, whose blocks run the ``fused_qkv_mha`` and ``ln_dense`` /
``ln_quant_dense`` kernels on the card, and its head (Linear → GELU →
Linear → ℓ2) runs in f32 as in the JAX package.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import clip_vision
from stamp_tpu_torch.models.vit_image import ImageViT, init_random_weights_, select_timm_state_dict, vit_quant_sites
from stamp_tpu_torch.preprocessing.extractor import (
    Extractor,
    load_or_init_,
    tower_extractor,
    vit_config,
    with_quant,
)


def make_plip_extractor(identifier: str = "plip", *, device: torch.device) -> Extractor:
    """PLIP: CLIP ViT-B/32 image features."""
    cfg = clip_vision.CLIPVisionConfig()
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: clip_vision.CLIPVisionTower(replace(cfg, quant=quant)),
        load=lambda model: load_or_init_(
            model,
            identifier=identifier,
            weight_files=["*plip*pytorch_model.bin", "*plip*.safetensors"],
            load=lambda sd, _: clip_vision.convert_clip_vision_state_dict(sd, cfg),
            init=clip_vision.init_random_weights_,
        ),
        sites=clip_vision.clip_quant_sites(cfg.depth),
        device=device,
        input_px=cfg.img_size,
        feat_dim=cfg.projection_dim,
        mean=cfg.mean,
        std=cfg.std,
    )


class KeepHead(nn.Module):
    """KEEP's ``visual_head``: Linear → GELU → Linear, then ℓ2-normalized."""

    def __init__(self, dim: int, projection_dim: int) -> None:
        super().__init__()
        self.fc0 = nn.Linear(dim, projection_dim)
        self.fc2 = nn.Linear(projection_dim, projection_dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:
        h = self.fc2(F.gelu(self.fc0(feats)))
        return h / torch.linalg.vector_norm(h, dim=-1, keepdim=True)


class KeepModel(nn.Module):
    """The ImageViT trunk (bf16 or int8) and the f32 head."""

    def __init__(self, trunk: ImageViT, projection_dim: int = 768) -> None:
        super().__init__()
        self.trunk = trunk
        self.head = KeepHead(trunk.cfg.embed_dim, projection_dim)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return self.head(self.trunk(images).float())


def keep_split_state_dict(sd: Mapping[str, Any]) -> tuple[dict, dict[str, Any]]:
    """Split a KEEP checkpoint into (timm trunk state dict, head entries
    ``w0``, ``b0``, ``w2``, ``b2`` in torch layout), as the JAX package's
    ``keep_split_state_dict``: ``visual.`` stripped and LayerScale's
    ``ls1/ls2.weight`` renamed ``.gamma`` for the trunk, the
    ``visual_head`` Sequential (Linear → GELU → Linear) for the head."""
    trunk: dict = {}
    for k, v in sd.items():
        if k.startswith("visual."):
            kk = k[len("visual.") :]
            if ".ls1.weight" in kk or ".ls2.weight" in kk:
                kk = kk.replace(".weight", ".gamma")
            trunk[kk] = v
    head = {name: sd[f"visual_head.{i}.{kind}"] for name, i, kind in
            (("w0", 0, "weight"), ("b0", 0, "bias"), ("w2", 2, "weight"), ("b2", 2, "bias"))}  # fmt: skip
    return trunk, head


def keep_head_state_dict(head: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """The head entries (torch layout) under ``KeepModel``'s names."""
    return {f"head.{fc}.{kind}": torch.as_tensor(np.asarray(head[key], np.float32))
            for fc, kind, key in (("fc0", "weight", "w0"), ("fc0", "bias", "b0"),
                                  ("fc2", "weight", "w2"), ("fc2", "bias", "b2"))}  # fmt: skip


def _load_keep(sd: dict[str, torch.Tensor], model: KeepModel) -> dict[str, torch.Tensor]:
    trunk, head = keep_split_state_dict(sd)
    trunk_sd = select_timm_state_dict(trunk, model.trunk)
    return {**{f"trunk.{k}": v for k, v in trunk_sd.items()}, **keep_head_state_dict(head)}


def _init_keep(model: KeepModel, generator: torch.Generator) -> KeepModel:
    """The trunk as ``vit_image.init_random_weights_``; the head's weights
    normal with std 0.02 and zero biases, as the JAX package draws them."""
    init_random_weights_(model.trunk, generator)
    with torch.no_grad():
        for fc in (model.head.fc0, model.head.fc2):
            fc.weight.normal_(0.0, 0.02, generator=generator)
            fc.bias.zero_()
    return model


def make_keep_extractor(identifier: str = "keep", *, device: torch.device) -> Extractor:
    """KEEP: timm ViT-L/16 backbone + (Linear → GELU → Linear → ℓ2) head."""
    cfg = vit_config("uni")  # ViT-L/16 with LayerScale, the same trunk family
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: KeepModel(ImageViT(with_quant(cfg, quant))),
        load=lambda model: load_or_init_(
            model,
            identifier=identifier,
            weight_files=["*KEEP*.safetensors", "*keep*model.safetensors"],
            load=_load_keep,
            init=_init_keep,
        ),
        sites=[f"trunk.{site}" for site in vit_quant_sites(cfg.depth)],
        device=device,
        input_px=224,
        feat_dim=768,
        mean=cfg.mean,
        std=cfg.std,
        keep_f32=("head",),
    )
