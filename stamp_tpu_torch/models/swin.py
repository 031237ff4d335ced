"""Swin Transformer backbone (CTransPath / CHIEF-CTransPath), in PyTorch.

Counterpart of ``stamp_tpu.models.swin``: Swin-T with patch size 4, window
7, embed dim 96, depths (2, 2, 6, 2), heads (3, 6, 12, 24) and the
CTransPath paper's convolutional stem (two 3×3 stride-2 conv + BatchNorm +
ReLU blocks, then a 1×1 projection); the feature is the mean of the final
stage's tokens (768-d).  It runs in f32 with TF32 off, as the JAX package
runs it at ``"highest"`` matmul precision.  Window attention is plain
einsum: no kernel of the port runs here.

The relative-position index and the shifted-window masks are numpy
constants, computed once on the host for each shape and device.
Submodules carry the flax tree's names (``models.towers``);
``convert_ctranspath_state_dict`` maps the published checkpoint onto them.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models.towers import (
    full_f32,
    init_random_weights_ as _init_tower_,
    numpy_state_dict,
    softmax_attention,
    state_dict_from_flax,
)
from stamp_tpu_torch.models.vit_image import QuantDense


def _window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] → [B·nW, window², C]."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)


def _window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    """[B·nW, window², C] → [B, H, W, C]."""
    b = x.shape[0] // (h * w // window // window)
    x = x.reshape(b, h // window, w // window, window, window, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def _relative_position_index(window: int) -> np.ndarray:
    """timm's relative position index for a window [window², window²]."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    coords_flat = coords.reshape(2, -1)
    relative = (coords_flat[:, :, None] - coords_flat[:, None, :]).transpose(1, 2, 0)
    relative[:, :, 0] += window - 1
    relative[:, :, 1] += window - 1
    relative[:, :, 0] *= 2 * window - 1
    return relative.sum(-1)


def _shift_attn_mask(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """The shifted windows' attention mask [nW, n, n] of 0 / −100."""
    img_mask = np.zeros((1, h, w, 1))
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    cnt = 0
    for hs in slices:
        for ws in slices:
            img_mask[:, hs, ws, :] = cnt
            cnt += 1
    mask = img_mask.reshape(1, h // window, window, w // window, window, 1)
    mask_windows = mask.transpose(0, 1, 3, 2, 4, 5).reshape(-1, window * window)
    attn_mask = mask_windows[:, None, :] - mask_windows[:, :, None]
    return np.where(attn_mask != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _on_device(name: str, device: torch.device, *args: int) -> torch.Tensor:
    """A host constant (``_relative_position_index`` or
    ``_shift_attn_mask``), made once per shape and device."""
    array = {"index": _relative_position_index, "mask": _shift_attn_mask}[name](*args)
    return torch.from_numpy(array.reshape(-1) if name == "index" else array).to(device)


class _WindowAttention(nn.Module):
    def __init__(self, dim: int, window: int, num_heads: int, quant: str) -> None:
        super().__init__()
        self.window, self.num_heads = window, num_heads
        self.relative_position_bias_table = nn.Parameter(torch.zeros((2 * window - 1) ** 2, num_heads))
        self.qkv = QuantDense(dim, 3 * dim, mode=quant)
        self.proj = QuantDense(dim, dim, mode=quant)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
        """x: [B·nW, n, C]; mask: [nW, n, n] or None."""
        b_, n, c = x.shape
        h = self.num_heads
        q, k, v = self.qkv(x).reshape(b_, n, 3, h, c // h).permute(2, 0, 3, 1, 4)
        index = _on_device("index", x.device, self.window)
        bias = self.relative_position_bias_table[index].reshape(n, n, h).permute(2, 0, 1)[None]
        if mask is not None:
            n_windows = mask.shape[0]
            bias = (bias.float() + mask[:, None]).repeat(b_ // n_windows, 1, 1, 1)  # [B·nW, H, n, n]
        out = softmax_attention(q * (c // h) ** -0.5, k, v, bias=bias)
        return self.proj(out.transpose(1, 2).reshape(b_, n, c))


class _SwinBlock(nn.Module):
    def __init__(self, dim: int, resolution: int, num_heads: int, window: int, shift: int, quant: str) -> None:
        super().__init__()
        self.resolution, self.window, self.shift = resolution, window, shift
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = _WindowAttention(dim, window, num_heads, quant)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp_fc1 = QuantDense(dim, 4 * dim, mode=quant)
        self.mlp_fc2 = QuantDense(4 * dim, dim, mode=quant)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res, window, shift = self.resolution, self.window, self.shift
        b, n, c = x.shape
        h = self.norm1(x).reshape(b, res, res, c)
        mask = None
        if shift > 0:
            h = torch.roll(h, shifts=(-shift, -shift), dims=(1, 2))
            mask = _on_device("mask", x.device, res, res, window, shift)
        h = _window_reverse(self.attn(_window_partition(h, window), mask), window, res, res)
        if shift > 0:
            h = torch.roll(h, shifts=(shift, shift), dims=(1, 2))
        x = x + h.reshape(b, n, c)
        return x + self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))


class _PatchMerging(nn.Module):
    def __init__(self, dim: int, resolution: int) -> None:
        super().__init__()
        self.resolution = resolution
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, _, c = x.shape
        x = x.reshape(b, self.resolution, self.resolution, c)
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x.reshape(b, -1, 4 * c)))


class ConvStem(nn.Module):
    """CTransPath's conv stem: 2× (3×3 s2 conv + BatchNorm + ReLU) → 1×1
    conv → LayerNorm; the inference BatchNorm's running statistics are
    parameters, as in the JAX package."""

    def __init__(self, embed_dim: int = 96) -> None:
        super().__init__()
        dim = embed_dim // 8
        in_dim = 3
        for i in range(2):
            self.add_module(f"conv{i}", nn.Conv2d(in_dim, dim, 3, stride=2, padding=1, bias=False))
            for stat, value in (("scale", 1.0), ("bias", 0.0), ("mean", 0.0), ("var", 1.0)):
                self.register_parameter(f"bn{i}_{stat}", nn.Parameter(torch.full((dim,), value)))
            in_dim, dim = dim, 2 * dim
        self.proj = nn.Conv2d(in_dim, embed_dim, 1)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:  # NHWC → [B, h·w, C]
        x = images.permute(0, 3, 1, 2)
        for i in range(2):
            x = getattr(self, f"conv{i}")(x)
            scale, bias, mean, var = (getattr(self, f"bn{i}_{s}")[:, None, None] for s in ("scale", "bias", "mean", "var"))
            x = F.relu((x - mean) * torch.rsqrt(var + 1e-5) * scale + bias)
        return self.norm(self.proj(x).flatten(2).transpose(1, 2))


class SwinTransformer(nn.Module):
    """Swin-T feature extractor (patch 4, window 7) with ``ConvStem``: NHWC
    normalized images → mean-pooled features [B, 8·embed_dim]."""

    def __init__(
        self,
        img_size: int = 224,
        embed_dim: int = 96,
        depths: tuple[int, ...] = (2, 2, 6, 2),
        num_heads: tuple[int, ...] = (3, 6, 12, 24),
        window: int = 7,
        quant: str = "off",
    ) -> None:
        super().__init__()
        self.depths = depths
        self.patch_embed = ConvStem(embed_dim)
        self.stages: list[str] = []
        res, dim = img_size // 4, embed_dim
        for stage, (depth, heads) in enumerate(zip(depths, num_heads)):
            # when the resolution no longer exceeds the window the stage is
            # one window, unshifted (timm clamps both)
            win = min(window, res)
            for blk in range(depth):
                shift = 0 if blk % 2 == 0 or res <= window else win // 2
                self.add_module(f"stage{stage}_block{blk}", _SwinBlock(dim, res, heads, win, shift, quant))
                self.stages.append(f"stage{stage}_block{blk}")
            if stage < len(depths) - 1:
                self.add_module(f"stage{stage}_downsample", _PatchMerging(dim, res))
                self.stages.append(f"stage{stage}_downsample")
                res, dim = res // 2, dim * 2
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        with full_f32():
            x = self.patch_embed(images)
            for name in self.stages:
                x = getattr(self, name)(x)
            return self.norm(x).mean(dim=1)


def init_random_weights_(model: SwinTransformer, generator: torch.Generator) -> SwinTransformer:
    """Seeded random weights with the flax module's distributions (the
    relative-position tables normal with std 0.02; BatchNorm scales and
    variances one, shifts and means zero)."""
    ones = {f"bn{i}_{s}": ("constant", 1.0) for i in range(2) for s in ("scale", "var")}
    return _init_tower_(model, generator, {"relative_position_bias_table": ("normal", 0.02), **ones})


def swin_quant_sites(depths: tuple[int, ...] = (2, 2, 6, 2)) -> list[str]:
    """QuantDense sites of the Swin stages (patch merging and stem stay f32)."""
    return [
        f"stage{stage}_block{blk}.{site}"
        for stage, depth in enumerate(depths)
        for blk in range(depth)
        for site in ("attn.qkv", "attn.proj", "mlp_fc1", "mlp_fc2")
    ]


def convert_ctranspath_state_dict(state_dict: dict[str, Any]) -> dict[str, torch.Tensor]:
    """Map the CTransPath torch checkpoint onto ``SwinTransformer``'s state
    dict; the JAX package's converter, copied (the stem's Sequential indices
    conv 0, 3, 6 and BatchNorm 1, 4)."""
    sd = numpy_state_dict(state_dict)

    def t(name: str) -> np.ndarray:
        return sd[name]

    def ln(name: str) -> dict:
        return {"scale": t(name + ".weight"), "bias": t(name + ".bias")}

    def dense(name: str) -> dict:
        return {"kernel": t(name + ".weight").T, "bias": t(name + ".bias")}

    stem: dict[str, Any] = {}
    for i, (conv_idx, bn_idx) in enumerate([(0, 1), (3, 4)]):
        stem[f"conv{i}"] = {"kernel": t(f"patch_embed.proj.{conv_idx}.weight").transpose(2, 3, 1, 0)}
        stem[f"bn{i}_scale"] = t(f"patch_embed.proj.{bn_idx}.weight")
        stem[f"bn{i}_bias"] = t(f"patch_embed.proj.{bn_idx}.bias")
        stem[f"bn{i}_mean"] = t(f"patch_embed.proj.{bn_idx}.running_mean")
        stem[f"bn{i}_var"] = t(f"patch_embed.proj.{bn_idx}.running_var")
    stem["proj"] = {"kernel": t("patch_embed.proj.6.weight").transpose(2, 3, 1, 0), "bias": t("patch_embed.proj.6.bias")}
    stem["norm"] = ln("patch_embed.norm")
    params: dict[str, Any] = {"patch_embed": stem}

    depths = (2, 2, 6, 2)
    for stage in range(4):
        for blk in range(depths[stage]):
            p = f"layers.{stage}.blocks.{blk}."
            params[f"stage{stage}_block{blk}"] = {
                "norm1": ln(p + "norm1"),
                "norm2": ln(p + "norm2"),
                "attn": {
                    "relative_position_bias_table": t(p + "attn.relative_position_bias_table"),
                    "qkv": dense(p + "attn.qkv"),
                    "proj": dense(p + "attn.proj"),
                },
                "mlp_fc1": dense(p + "mlp.fc1"),
                "mlp_fc2": dense(p + "mlp.fc2"),
            }
        if stage < 3:
            d = f"layers.{stage}.downsample."
            params[f"stage{stage}_downsample"] = {
                "norm": ln(d + "norm"),
                "reduction": {"kernel": t(d + "reduction.weight").T},
            }
    params["norm"] = ln("norm")
    return state_dict_from_flax({"params": params})
