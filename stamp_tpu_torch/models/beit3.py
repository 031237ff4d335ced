"""BEiT3 vision branch for the MUSK extractor, in PyTorch.

Counterpart of ``stamp_tpu.models.beit3``: MUSK's vision path, a ViT-L/16 at
384 px with sub-LayerNorm FFNs (the multiway transformer's vision experts
only), evaluated at two scales and concatenated (``multiscale_cls``) →
2048-d tile features.  Attention is plain einsum (577 tokens), as in the
JAX package: no kernel of the port runs here.

Submodules carry the flax tree's names (``models.towers``);
``convert_beit3_state_dict`` maps a MUSK (torchscale) checkpoint onto them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
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
class Beit3Config:
    img_size: int = 384
    patch_size: int = 16
    width: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    norm_eps: float = 1e-5
    # timm IMAGENET_INCEPTION constants
    mean: tuple[float, float, float] = (0.5, 0.5, 0.5)
    std: tuple[float, float, float] = (0.5, 0.5, 0.5)
    # QuantDense mode of the block matmuls: "off" | "observe" | "int8"
    quant: str = "off"


class _Beit3Block(nn.Module):
    """Pre-LN block with BEiT3's sub-LayerNorms (after attention, inside the
    FFN); k has no bias."""

    def __init__(self, cfg: Beit3Config) -> None:
        super().__init__()
        self.num_heads = cfg.num_heads
        w, eps, hidden = cfg.width, cfg.norm_eps, int(cfg.width * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(w, eps=eps)
        self.q = QuantDense(w, w, mode=cfg.quant)
        self.k = QuantDense(w, w, bias=False, mode=cfg.quant)
        self.v = QuantDense(w, w, mode=cfg.quant)
        self.inner_attn_ln = nn.LayerNorm(w, eps=eps)
        self.proj = QuantDense(w, w, mode=cfg.quant)
        self.norm2 = nn.LayerNorm(w, eps=eps)
        self.fc1 = QuantDense(w, hidden, mode=cfg.quant)
        self.ffn_ln = nn.LayerNorm(hidden, eps=eps)
        self.fc2 = QuantDense(hidden, w, mode=cfg.quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        q, k, v = (split_heads(proj(h), self.num_heads) for proj in (self.q, self.k, self.v))
        out = merge_heads(softmax_attention(q * q.shape[-1] ** -0.5, k, v))
        x = x + self.proj(self.inner_attn_ln(out))
        return x + self.fc2(self.ffn_ln(F.gelu(self.fc1(self.norm2(x)))))


class Beit3VisionTower(nn.Module):
    """Single-scale BEiT3 vision forward of NHWC normalized images → CLS
    embedding [B, width]."""

    def __init__(self, cfg: Beit3Config) -> None:
        super().__init__()
        self.cfg = cfg
        n = (cfg.img_size // cfg.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, cfg.width, cfg.patch_size, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(n + 1, cfg.width))
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", _Beit3Block(cfg))
        self.norm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = patchify(self.patch_embed, images)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for i in range(self.cfg.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.norm(x)[:, 0]


def multiscale_cls(model: Beit3VisionTower, images: torch.Tensor) -> torch.Tensor:
    """MUSK's two-scale evaluation: CLS at the native size ⧺ the mean CLS of
    the four native-size crops of a 2× bilinear upsample → [B, 2·width]."""
    s = model.cfg.img_size
    cls1 = model(images)
    big = F.interpolate(images.permute(0, 3, 1, 2), size=(2 * s, 2 * s), mode="bilinear", align_corners=False)
    big = big.permute(0, 2, 3, 1)
    crops = [big[:, i * s : (i + 1) * s, j * s : (j + 1) * s, :] for i in range(2) for j in range(2)]
    cls2 = sum(model(crop) for crop in crops) / 4.0
    return torch.cat([cls1, cls2], dim=-1)


def init_random_weights_(model: Beit3VisionTower, generator: torch.Generator) -> Beit3VisionTower:
    """Seeded random weights with the flax module's distributions
    (``pos_embed`` normal with std 0.02, ``cls_token`` zero)."""
    return _init_tower_(model, generator, {"pos_embed": ("normal", 0.02)})


def beit3_quant_sites(depth: int) -> list[str]:
    """QuantDense sites of the BEiT3 vision tower."""
    return [f"block_{i}.{name}" for i in range(depth) for name in ("q", "k", "v", "proj", "fc1", "fc2")]


def convert_beit3_state_dict(state_dict: dict[str, Any], cfg: Beit3Config) -> dict[str, torch.Tensor]:
    """Map a MUSK/BEiT3 (torchscale) checkpoint onto ``Beit3VisionTower``'s
    state dict; the JAX package's converter, copied.  Only the multiway
    ``.A`` (vision) branch is read, looked up at every dot boundary and
    without it, with and without the ``beit3.`` prefix; the learned
    positions skip torchscale's two reserved padding rows."""
    sd = {k.removeprefix("module."): v for k, v in numpy_state_dict(state_dict).items()}

    def t(name: str, suffix: str) -> np.ndarray:
        parts = name.split(".")
        names = [".".join(parts[: j + 1] + ["A"] + parts[j + 1 :]) for j in reversed(range(len(parts)))] + [name]
        for n in names:
            for cand in (f"beit3.{n}.{suffix}", f"{n}.{suffix}"):
                if cand in sd:
                    return sd[cand]
        raise KeyError(f"{name}.{suffix} not found (with or without .A branch)")

    def ln(name: str) -> dict:
        return {"scale": t(name, "weight"), "bias": t(name, "bias")}

    def dense(name: str) -> dict:
        return {"kernel": t(name, "weight").T, "bias": t(name, "bias")}

    params: dict[str, Any] = {
        "patch_embed": {
            "kernel": t("vision_embed.proj", "weight").transpose(2, 3, 1, 0),
            "bias": t("vision_embed.proj", "bias"),
        }
    }
    for cand in ("beit3.vision_embed.cls_token", "vision_embed.cls_token"):
        if cand in sd:
            params["cls_token"] = sd[cand].reshape(1, 1, cfg.width)
            break
    else:
        raise KeyError("vision_embed.cls_token not found")
    n_tokens = (cfg.img_size // cfg.patch_size) ** 2 + 1
    params["pos_embed"] = t("encoder.embed_positions", "weight")[2 : 2 + n_tokens]
    for i in range(cfg.depth):
        p = f"encoder.layers.{i}."
        params[f"block_{i}"] = {
            "norm1": ln(p + "self_attn_layer_norm"),
            "q": dense(p + "self_attn.q_proj"),
            "k": {"kernel": t(p + "self_attn.k_proj", "weight").T},
            "v": dense(p + "self_attn.v_proj"),
            "inner_attn_ln": ln(p + "self_attn.inner_attn_ln"),
            "proj": dense(p + "self_attn.out_proj"),
            "norm2": ln(p + "final_layer_norm"),
            "fc1": dense(p + "ffn.fc1"),
            "ffn_ln": ln(p + "ffn.ffn_layernorm"),
            "fc2": dense(p + "ffn.fc2"),
        }
    params["norm"] = ln("encoder.layer_norm")
    return state_dict_from_flax({"params": params})
