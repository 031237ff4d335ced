"""CoCa vision branch for the CONCH extractors, in PyTorch.

Counterpart of ``stamp_tpu.models.coca``: CONCH's image path
``encode_image(batch, proj_contrast=False, normalize=False)``, a ViT trunk
whose blocks are the port's ImageViT block (``vit_image._Block``: the
LayerNorm-fed qkv and fc1 run ``ops.ln_dense`` or, in int8,
``ops.ln_dense.ln_quant_dense``, and attention ``ops.flash_attention.
fused_qkv_mha``), then a single-query attentional pooler and a final
LayerNorm, without the contrastive projection.  CONCH v1.5 is the same
shape at ViT-L width with a 768-d pooled output.  The pooler is one query:
plain bf16 einsum attention, as in the JAX package.

Submodules carry the flax tree's names (``models.towers``);
``convert_coca_state_dict`` maps an upstream CONCH checkpoint onto them.
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
from stamp_tpu_torch.models.vit_image import ViTConfig, _Block


@dataclass(frozen=True)
class CoCaVisionConfig:
    img_size: int = 448
    patch_size: int = 16
    width: int = 768  # trunk embedding dim
    depth: int = 12
    num_heads: int = 12
    pooled_dim: int = 512  # attentional-pooler output (= CONCH feature dim)
    pool_heads: int = 8
    norm_eps: float = 1e-5
    mean: tuple[float, float, float] = (0.48145466, 0.4578275, 0.40821073)
    std: tuple[float, float, float] = (0.26862954, 0.26130258, 0.27577711)
    # QuantDense mode of the trunk-block matmuls ("off" | "observe" | "int8");
    # the attentional pooler is a single query — it stays bf16
    quant: str = "off"


COCA_CONFIGS: dict[str, CoCaVisionConfig] = {
    # CONCH v1.0: CoCa ViT-B/16 at 448px, pooled contrastive width 512
    "conch": CoCaVisionConfig(),
    # CONCH v1.5 (TITAN's tile encoder): ViT-L/16 at 448px, pooled width 768
    "conch1_5": CoCaVisionConfig(width=1024, depth=24, num_heads=16, pooled_dim=768),
}


class _AttentionalPooler(nn.Module):
    """A learned query (LayerNormed by ``ln_q``) attends over the
    LayerNormed (``ln_k``) trunk tokens with separate q/k/v projections."""

    def __init__(self, dim: int, context_dim: int, num_heads: int, norm_eps: float) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Parameter(torch.zeros(1, dim))
        self.ln_q = nn.LayerNorm(dim, eps=norm_eps)
        self.ln_k = nn.LayerNorm(context_dim, eps=norm_eps)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(context_dim, dim)
        self.v = nn.Linear(context_dim, dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:  # [B, N, C] → [B, dim]
        b = tokens.shape[0]
        q = split_heads(self.q(self.ln_q(self.query))[None], self.num_heads)  # [1, H, 1, d]
        kv = self.ln_k(tokens)
        q = q.expand(b, -1, -1, -1) * q.shape[-1] ** -0.5
        out = softmax_attention(q, split_heads(self.k(kv), self.num_heads), split_heads(self.v(kv), self.num_heads))
        return self.proj(merge_heads(out)[:, 0])


class CoCaVisionTower(nn.Module):
    """Trunk ViT + attentional pooling → the unprojected pooled embedding
    [B, pooled_dim] of NHWC normalized images."""

    def __init__(self, cfg: CoCaVisionConfig) -> None:
        super().__init__()
        self.cfg = cfg
        n = (cfg.img_size // cfg.patch_size) ** 2
        self.patch_embed = nn.Conv2d(3, cfg.width, cfg.patch_size, cfg.patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.width))
        self.pos_embed = nn.Parameter(torch.zeros(n + 1, cfg.width))
        block_cfg = ViTConfig(
            embed_dim=cfg.width, num_heads=cfg.num_heads, mlp_ratio=4.0, norm_eps=cfg.norm_eps, quant=cfg.quant
        )
        for i in range(cfg.depth):
            self.add_module(f"block_{i}", _Block(block_cfg))
        self.norm = nn.LayerNorm(cfg.width, eps=cfg.norm_eps)
        self.attn_pool = _AttentionalPooler(cfg.pooled_dim, cfg.width, cfg.pool_heads, cfg.norm_eps)
        self.ln_contrast = nn.LayerNorm(cfg.pooled_dim, eps=cfg.norm_eps)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        x = patchify(self.patch_embed, images)
        x = torch.cat([self.cls_token.expand(x.shape[0], -1, -1), x], dim=1) + self.pos_embed
        for i in range(self.cfg.depth):
            x = getattr(self, f"block_{i}")(x)
        return self.ln_contrast(self.attn_pool(self.norm(x)))


def init_random_weights_(model: CoCaVisionTower, generator: torch.Generator) -> CoCaVisionTower:
    """Seeded random weights with the flax module's distributions
    (``pos_embed`` and the pooler's query normal with std 0.02)."""
    return _init_tower_(model, generator, {"pos_embed": ("normal", 0.02), "query": ("normal", 0.02)})


def coca_quant_sites(depth: int) -> list[str]:
    """The QuantDense sites of the trunk (the pooler stays bf16)."""
    return [f"block_{i}.{site}" for i in range(depth) for site in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")]


def convert_coca_state_dict(state_dict: dict[str, Any], cfg: CoCaVisionConfig) -> dict[str, torch.Tensor]:
    """Map a CONCH/CoCa checkpoint onto ``CoCaVisionTower``'s state dict.

    The JAX package's ``convert_coca_state_dict``, copied: ``visual.trunk.*``
    (timm ViT names), ``visual.attn_pool_contrast`` (open_clip's
    AttentionalPooler: ``query``, ``ln_q``, ``ln_k``, a MultiheadAttention
    with separate ``q_proj_weight`` / ``k_proj_weight`` / ``v_proj_weight``,
    a packed ``in_proj_bias`` and ``out_proj``) and ``visual.ln_contrast``;
    a leading ``module.`` and a missing ``visual.`` prefix are tolerated,
    ``attn_pool`` is an alias of ``attn_pool_contrast``."""
    sd = {k.removeprefix("module."): v for k, v in numpy_state_dict(state_dict).items()}

    def t(*names: str) -> np.ndarray:
        for name in names:
            for cand in (f"visual.{name}", name):
                if cand in sd:
                    return sd[cand]
        raise KeyError(f"none of {names} found in checkpoint (visual.* or bare)")

    def ln(*names: str) -> dict:
        return {"scale": t(*(f"{n}.weight" for n in names)), "bias": t(*(f"{n}.bias" for n in names))}

    def dense(name: str) -> dict:
        return {"kernel": t(name + ".weight").T, "bias": t(name + ".bias")}

    params: dict[str, Any] = {
        "patch_embed": {
            "kernel": t("trunk.patch_embed.proj.weight").transpose(2, 3, 1, 0),
            "bias": t("trunk.patch_embed.proj.bias"),
        },
        "cls_token": t("trunk.cls_token").reshape(1, 1, cfg.width),
        "pos_embed": t("trunk.pos_embed").reshape(-1, cfg.width),
    }
    for i in range(cfg.depth):
        p = f"trunk.blocks.{i}."
        params[f"block_{i}"] = {
            "norm1": ln(p + "norm1"),
            "norm2": ln(p + "norm2"),
            "attn": {"qkv": dense(p + "attn.qkv"), "proj": dense(p + "attn.proj")},
            "mlp": {"fc1": dense(p + "mlp.fc1"), "fc2": dense(p + "mlp.fc2")},
        }
    params["norm"] = ln("trunk.norm")

    pool = "attn_pool_contrast", "attn_pool"
    d = cfg.pooled_dim
    bias_qkv = t(*(f"{p}.attn.in_proj_bias" for p in pool))
    params["attn_pool"] = {
        "query": t(*(f"{p}.query" for p in pool)).reshape(1, d),
        "ln_q": ln(*(f"{p}.ln_q" for p in pool)),
        "ln_k": ln(*(f"{p}.ln_k" for p in pool)),
        "q": {"kernel": t(*(f"{p}.attn.q_proj_weight" for p in pool)).T, "bias": bias_qkv[:d]},
        "k": {"kernel": t(*(f"{p}.attn.k_proj_weight" for p in pool)).T, "bias": bias_qkv[d : 2 * d]},
        "v": {"kernel": t(*(f"{p}.attn.v_proj_weight" for p in pool)).T, "bias": bias_qkv[2 * d :]},
        "proj": {
            "kernel": t(*(f"{p}.attn.out_proj.weight" for p in pool)).T,
            "bias": t(*(f"{p}.attn.out_proj.bias" for p in pool)),
        },
    }
    params["ln_contrast"] = ln("ln_contrast")
    return state_dict_from_flax({"params": params})
