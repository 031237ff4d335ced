"""The TITAN slide encoder, in PyTorch.

Counterpart of the TITAN part of ``stamp_tpu/models/slide_encoders.py``
(``alibi_slopes``, ``_BiasedAttention``, ``_TransformerBlock``, ``TitanViT``,
``convert_titan_state_dict``; lines 53-200 and 430-503 there): a ViT over
CONCH1.5 tile features on the integer tile grid, with a 2-D ALiBi distance
penalty on the attention logits and a CLS-token slide embedding (768-d).
GigaPath, PRISM, COBRA and MADELEINE are not ported.

Below ``flash_min_tiles`` tiles, or on the CPU, the bias is a dense
[1, H, N+1, N+1] tensor built as the JAX package builds it (``+1e-12`` inside
the square root, zero CLS row and column).  From ``flash_min_tiles`` tiles
on a CUDA tensor it is computed blockwise inside the flash kernel
(``ops.flash_attention.flash_alibi2d_mha``), which never materialises it and
exempts the CLS row and column itself; the JAX package takes its Pallas
kernel at the same count on a TPU.

The module tree follows the upstream checkpoint's names (``patch_embed``,
``cls_token``, ``blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``,
``norm``); ``load_titan_state_dict`` takes those names under the prefixes
the JAX package's converter strips, and ``variables_from_jax`` /
``variables_to_jax`` carry weights to and from the JAX package's flax tree.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.ops.flash_attention import flash_alibi2d_mha


def alibi_slopes(num_heads: int) -> np.ndarray:
    """Geometric ALiBi head slopes 2^(-8i/H) (Press et al. 2022)."""
    return np.asarray([2.0 ** (-8.0 * (i + 1) / num_heads) for i in range(num_heads)], dtype=np.float32)


class _BiasedAttention(nn.Module):
    """Multi-head attention with an additive logit bias: a dense
    [1, H, N, N] ``bias``, or the 2-D ALiBi bias computed inside the flash
    kernel from ``flash_coords`` [N, 2] and ``flash_slopes`` [H]."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(
        self,
        x: torch.Tensor,
        bias: torch.Tensor | None = None,
        flash_coords: torch.Tensor | None = None,
        flash_slopes: torch.Tensor | None = None,
    ) -> torch.Tensor:
        b, n, dim = x.shape
        head_dim = dim // self.num_heads
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, head_dim).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]  # [B, H, N, d]
        if flash_coords is not None:
            bh = b * self.num_heads
            coords = flash_coords.expand(bh, n, 2).contiguous()
            out = flash_alibi2d_mha(
                q.reshape(bh, n, head_dim).contiguous(),
                k.reshape(bh, n, head_dim).contiguous(),
                v.reshape(bh, n, head_dim).contiguous(),
                coords,
                flash_slopes.repeat(b),
            ).reshape(b, self.num_heads, n, head_dim)
        else:
            logits = torch.matmul(q * head_dim**-0.5, k.transpose(-1, -2))
            if bias is not None:
                logits = logits + bias
            out = torch.matmul(torch.softmax(logits, dim=-1).to(x.dtype), v)
        return self.proj(out.transpose(1, 2).reshape(b, n, dim))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class _TransformerBlock(nn.Module):
    """Pre-LN block: biased attention + exact-GELU MLP."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = _BiasedAttention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = _Mlp(dim, int(dim * mlp_ratio))

    def forward(self, x, bias=None, flash_coords=None, flash_slopes=None) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), bias, flash_coords, flash_slopes)
        return x + self.mlp(self.norm2(x))


def _use_flash_kernel(n_tiles: int, min_tiles: int, device: torch.device) -> bool:
    """The kernel gate: from ``min_tiles`` tiles on a CUDA tensor (the JAX
    package's gate is the same count on a TPU)."""
    return n_tiles >= min_tiles and device.type == "cuda"


class TitanViT(nn.Module):
    """TITAN vision encoder: ViT over patch features with 2-D ALiBi.

    The attention logits of head h get a ``−slope_h · d(i, j)`` penalty, d
    the Euclidean distance between tiles in grid units; the CLS token
    attends and is attended without penalty."""

    def __init__(
        self,
        dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        flash_min_tiles: int = 2048,
        feat_dim: int = 768,
    ) -> None:
        super().__init__()
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        # from this many tiles on the card the bias is computed blockwise
        # inside the flash kernel instead of as a dense [H, N, N] tensor
        self.flash_min_tiles = flash_min_tiles
        self.patch_embed = nn.Linear(feat_dim, dim)
        self.cls_token = nn.Parameter(torch.zeros(1, dim))
        self.blocks = nn.ModuleList(_TransformerBlock(dim, num_heads) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, feats: torch.Tensor, grid_coords: torch.Tensor) -> torch.Tensor:
        """feats: [N, feat_dim] patch features; grid_coords: [N, 2] integer
        grid.  Returns the [dim] slide embedding."""
        x = torch.cat([self.cls_token, self.patch_embed(feats)])[None]  # [1, N+1, dim]
        n = feats.shape[0]
        slopes = torch.from_numpy(alibi_slopes(self.num_heads)).to(x.device)
        bias = flash_coords = flash_slopes = None
        if _use_flash_kernel(n, self.flash_min_tiles, x.device):
            # the CLS coordinates are a placeholder: the kernel exempts position 0
            flash_coords = torch.cat([grid_coords.new_zeros(1, 2), grid_coords]).float()
            flash_slopes = slopes
        else:
            # dense 2-D ALiBi bias [1, H, N+1, N+1]; CLS row/col unpenalised
            coords = grid_coords.float()
            delta = coords[:, None, :] - coords[None, :, :]
            dist = torch.sqrt((delta**2).sum(-1) + 1e-12)  # [N, N]
            dist = F.pad(dist, (1, 0, 1, 0))
            bias = (-slopes[:, None, None] * dist[None])[None]
        for block in self.blocks:
            x = block(x, bias, flash_coords, flash_slopes)
        return self.norm(x)[0, 0]  # CLS


def init_random_weights_(model: TitanViT, generator: torch.Generator) -> TitanViT:
    """Random weights for smoke tests and benchmarking, drawn on the CPU
    from ``generator`` with the flax module's distributions (dense kernels
    normal with std fan_in^-1/2, biases and the CLS token zero, LayerNorm
    scale one); the values differ from flax's, whose generator differs."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, module.in_features**-0.5, generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        model.cls_token.zero_()
    return model


# --- weights: the JAX package's flax tree and upstream checkpoints --------------


def variables_from_jax(variables: Mapping[str, Any], depth: int) -> dict[str, torch.Tensor]:
    """A ``stamp_tpu`` TitanViT variable tree → this module's state dict
    (dense kernels [in, out] → [out, in]).  Leaves are array-likes."""
    params = variables["params"]

    def t(a: Any, transpose: bool = False) -> torch.Tensor:
        arr = np.asarray(a)
        return torch.tensor(arr.T if transpose else arr)

    sd: dict[str, torch.Tensor] = {}

    def dense(prefix: str, leaf: Mapping[str, Any]) -> None:
        sd[prefix + ".weight"] = t(leaf["kernel"], transpose=True)
        sd[prefix + ".bias"] = t(leaf["bias"])

    def norm(prefix: str, leaf: Mapping[str, Any]) -> None:
        sd[prefix + ".weight"] = t(leaf["scale"])
        sd[prefix + ".bias"] = t(leaf["bias"])

    dense("patch_embed", params["patch_embed"])
    sd["cls_token"] = t(params["cls_token"])
    for i in range(depth):
        block, p = params[f"block_{i}"], f"blocks.{i}."
        norm(p + "norm1", block["norm1"])
        norm(p + "norm2", block["norm2"])
        dense(p + "attn.qkv", block["attn"]["qkv"])
        dense(p + "attn.proj", block["attn"]["proj"])
        dense(p + "mlp.fc1", block["fc1"])
        dense(p + "mlp.fc2", block["fc2"])
    norm("norm", params["norm"])
    return sd


def variables_to_jax(state_dict: Mapping[str, torch.Tensor], depth: int) -> dict:
    """This module's state dict → the ``stamp_tpu`` TitanViT variable tree
    (numpy leaves); the inverse of ``variables_from_jax``."""

    def a(name: str, transpose: bool = False) -> np.ndarray:
        arr = state_dict[name].detach().cpu().numpy()
        return arr.T.copy() if transpose else arr

    def dense(prefix: str) -> dict:
        return {"kernel": a(prefix + ".weight", transpose=True), "bias": a(prefix + ".bias")}

    def norm(prefix: str) -> dict:
        return {"scale": a(prefix + ".weight"), "bias": a(prefix + ".bias")}

    params: dict[str, Any] = {"patch_embed": dense("patch_embed"), "cls_token": a("cls_token"), "norm": norm("norm")}
    for i in range(depth):
        p = f"blocks.{i}."
        params[f"block_{i}"] = {
            "norm1": norm(p + "norm1"),
            "norm2": norm(p + "norm2"),
            "attn": {"qkv": dense(p + "attn.qkv"), "proj": dense(p + "attn.proj")},
            "fc1": dense(p + "mlp.fc1"),
            "fc2": dense(p + "mlp.fc2"),
        }
    return {"params": params}


# the prefixes ``stamp_tpu.models.slide_encoders._strip_prefixes`` strips, in its order
_PREFIXES = ("module.", "model.", "slide_encoder.", "vision_encoder.")


def load_titan_state_dict(state_dict: Mapping[str, torch.Tensor], model: TitanViT) -> dict[str, torch.Tensor]:
    """The entries of an upstream TITAN checkpoint that ``model`` holds,
    under its own names: the prefixes above stripped as the JAX package's
    converter strips them, ``patch_embed.proj.*`` or ``patch_embed.*``, the
    CLS token as [1, dim].  Other entries are ignored; raises KeyError
    naming the parameters the checkpoint lacks."""
    sd = {}
    for key, value in state_dict.items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix) :]
        sd[key] = torch.as_tensor(value)
    selected, missing = {}, []
    for key, param in model.state_dict().items():
        aliases = [key.replace("patch_embed.", "patch_embed.proj."), key] if key.startswith("patch_embed.") else [key]
        hit = next((name for name in aliases if name in sd), None)
        if hit is None:
            missing.append(key)
        else:
            selected[key] = sd[hit].reshape(param.shape)
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} TitanViT parameters: {missing[:8]}")
    return selected
