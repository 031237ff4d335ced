"""The slide encoders TITAN, PRISM and MADELEINE, in PyTorch, and what all
the slide encoders share.

Counterpart of ``stamp_tpu/models/slide_encoders.py``.  This file holds
TITAN (``alibi_slopes``, ``_BiasedAttention``, ``_TransformerBlock``,
``TitanViT``, ``convert_titan_state_dict``; lines 53-200 and 430-503
there), PRISM's Perceiver (301-353, 531-563), MADELEINE's gated-attention
MIL (403-430, 603-616), the copied helpers of the upstream-checkpoint
converters (433-481) and the random initialisation.  GigaPath's LongNet is
in ``models/slide_encoders_longnet.py`` and COBRA's Mamba2 tower in
``models/slide_encoders_cobra.py``, to keep each file short.

TITAN is a ViT over CONCH1.5 tile features on the integer tile grid, with a
2-D ALiBi distance penalty on the attention logits and a CLS-token slide
embedding (768-d).  Below ``flash_min_tiles`` tiles, or on the CPU, the
bias is a dense [1, H, N+1, N+1] tensor built as the JAX package builds it
(``+1e-12`` inside the square root, zero CLS row and column).  From
``flash_min_tiles`` tiles on a CUDA tensor it is computed blockwise inside
the flash kernel (``ops.flash_attention.flash_alibi2d_mha``), which never
materialises it and exempts the CLS row and column itself; the JAX package
takes its Pallas kernel at the same count on a TPU.  Its module tree
follows the upstream checkpoint's names (``patch_embed``, ``cls_token``,
``blocks.N.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,mlp.fc2}``, ``norm``);
``load_titan_state_dict`` takes those names under the prefixes the JAX
package's converter strips, and ``variables_from_jax`` /
``variables_to_jax`` carry weights to and from the JAX package's flax tree.

The other encoders name their submodules after the JAX module's flax tree,
so ``models.weights``' rule carries a tree to a state dict and back
(``*_variables_from_jax`` / ``*_variables_to_jax``), and each upstream
loader (``*_state_dict``) is the JAX package's converter, copied, followed
by that rule.  PRISM's latent blocks are TITAN's ``_TransformerBlock``
without a bias, whose MLP sits under ``mlp.`` where the flax tree has it
directly in the block.  Everything computes in f32 as the JAX package does;
no encoder touches the TF32 flags (PyTorch leaves matmul TF32 off).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import towers, weights
from stamp_tpu_torch.ops.flash_attention import flash_alibi2d_mha
from stamp_tpu_torch.ops.ssd import Mamba2Block


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


# the flax initializers of the parameters that are neither a Dense nor a LayerNorm
_PARAM_INIT = {
    "latents": ("normal", 0.02),  # PRISM
    "conv1d_weight": ("normal", 0.5),  # COBRA's Mamba2 mixers: lecun_normal, fan-in d_conv = 4
    "D": ("constant", 1.0),
    "norm_weight": ("constant", 1.0),
}


def init_random_weights_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights for any slide encoder of the port, for smoke tests
    and benchmarking, drawn on the CPU from ``generator`` in module order
    with the flax modules' distributions: dense kernels normal with std
    fan_in^-1/2, biases, CLS tokens and ``dt_bias`` zero, LayerNorm scales
    and ``D`` one, PRISM's latents N(0, 0.02²), each Mamba2 ``A_log``
    log(1 … heads).  The values differ from flax's, whose generator
    differs."""
    towers.init_random_weights_(model, generator, _PARAM_INIT)
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, Mamba2Block):
                module.A_log.copy_(torch.log(torch.arange(1, module.nheads + 1, dtype=torch.float32)))
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


# --- the JAX package's upstream-checkpoint converters, copied -------------------


def _strip_prefixes(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """numpy leaves (bf16 and f16 as f32) under their names with the
    prefixes above stripped, in that order."""
    sd = {}
    for key, value in towers.numpy_state_dict(state_dict).items():
        for prefix in _PREFIXES:
            if key.startswith(prefix):
                key = key[len(prefix) :]
        sd[key] = value
    return sd


def _t(sd: Mapping[str, np.ndarray], *names: str) -> np.ndarray:
    for name in names:
        if name in sd:
            return sd[name]
    raise KeyError(f"none of {names} found in checkpoint")


def _ln(sd: Mapping[str, np.ndarray], *names: str) -> dict:
    return {"scale": _t(sd, *(f"{n}.weight" for n in names)), "bias": _t(sd, *(f"{n}.bias" for n in names))}


def _linear(sd: Mapping[str, np.ndarray], *names: str, bias: bool = True) -> dict:
    out = {"kernel": _t(sd, *(f"{n}.weight" for n in names)).T}
    if bias:
        out["bias"] = _t(sd, *(f"{n}.bias" for n in names))
    return out


def _gated_attention(sd: Mapping[str, np.ndarray]) -> dict:
    """A CLAM-style gated attention net (``attention.attention_{a,b}.0``,
    ``attention.attention_c``, or without the ``attention.``)."""
    return {
        "attn_a": _linear(sd, "attention.attention_a.0", "attention_a.0"),
        "attn_b": _linear(sd, "attention.attention_b.0", "attention_b.0"),
        "attn_c": _linear(sd, "attention.attention_c", "attention_c"),
    }


# ---------------------------------------------------------------------------
# PRISM (Perceiver resampler)
# ---------------------------------------------------------------------------


class PrismPerceiver(nn.Module):
    """PRISM slide encoder: learned latents cross-attend to the tile
    embeddings (Virchow-full, 2560-d, projected to ``dim``), each
    cross-attention followed by a latent self-attention block; the mean
    latent after the final LayerNorm is the ``image_embedding``."""

    def __init__(
        self, dim: int = 1280, input_dim: int = 2560, num_latents: int = 512, depth: int = 8, num_heads: int = 16
    ) -> None:
        super().__init__()
        self.dim, self.depth, self.num_heads = dim, depth, num_heads
        self.input_proj = nn.Linear(input_dim, dim)
        self.latents = nn.Parameter(torch.zeros(num_latents, dim))
        for i in range(depth):
            self.add_module(f"cross_norm_{i}", nn.LayerNorm(dim, eps=1e-6))
            for name in ("q", "k", "v", "proj"):
                self.add_module(f"cross_{name}_{i}", nn.Linear(dim, dim))
            self.add_module(f"block_{i}", _TransformerBlock(dim, num_heads))
        self.norm = nn.LayerNorm(dim, eps=1e-6)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:  # [N, input_dim] → [dim]
        kv = self.input_proj(feats)[None]  # [1, N, dim]
        x = self.latents[None]  # [1, L, dim]
        head_dim = self.dim // self.num_heads

        def split(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(1, -1, self.num_heads, head_dim).transpose(1, 2)

        for i in range(self.depth):
            layer = lambda name: getattr(self, f"{name}_{i}")  # noqa: E731
            h = layer("cross_norm")(x)
            # the JAX package's order: q scaled first, f32 logits, softmax,
            # the weights cast to x's dtype, then their product with v
            q = split(layer("cross_q")(h)) * head_dim**-0.5
            logits = torch.matmul(q, split(layer("cross_k")(kv)).transpose(-1, -2))
            out = torch.matmul(torch.softmax(logits, dim=-1).to(x.dtype), split(layer("cross_v")(kv)))
            x = x + layer("cross_proj")(out.transpose(1, 2).reshape(1, -1, self.dim))
            x = layer("block")(x)
        return self.norm(x)[0].mean(dim=0)


def _prism_name(name: str, to_port: bool) -> str:
    """``block_i.fc1.*`` (flax) ↔ ``block_i.mlp.fc1.*`` (the port's block)."""
    parts = name.split(".")
    if parts[0].startswith("block_"):
        if to_port and parts[1] in ("fc1", "fc2"):
            return ".".join([parts[0], "mlp", *parts[1:]])
        if not to_port and parts[1] == "mlp":
            return ".".join([parts[0], *parts[2:]])
    return name


def prism_variables_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``stamp_tpu`` PrismPerceiver variable tree → this module's state dict."""
    return {_prism_name(k, True): v for k, v in weights.state_dict_from_tree(variables).items()}


def prism_variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`prism_variables_from_jax` (numpy leaves)."""
    return weights.tree_from_state_dict({_prism_name(k, False): v for k, v in state_dict.items()})


def prism_state_dict(state_dict: Mapping[str, Any], depth: int = 8) -> dict[str, torch.Tensor]:
    """An upstream PRISM checkpoint → this module's state dict: the JAX
    package's ``convert_prism_state_dict`` (``latents``, ``media_proj`` or
    ``input_proj``, per layer ``cross_{norm,q,k,v,proj}`` and a latent block
    ``norm1 / attn.qkv / attn.proj / norm2 / mlp.fc1 / mlp.fc2``, final
    ``norm``; an ``image_resampler.`` prefix tolerated), then the flax rule."""
    sd = {k.removeprefix("image_resampler."): v for k, v in _strip_prefixes(state_dict).items()}
    params = {
        "latents": _t(sd, "latents"),
        "input_proj": _linear(sd, "media_proj", "input_proj"),
        "norm": _ln(sd, "norm"),
    }
    for i in range(depth):
        p = f"layers.{i}."
        params[f"cross_norm_{i}"] = _ln(sd, p + "cross_norm")
        for name in ("q", "k", "v", "proj"):
            params[f"cross_{name}_{i}"] = _linear(sd, p + f"cross_{name}")
        params[f"block_{i}"] = {
            "norm1": _ln(sd, p + "norm1"),
            "norm2": _ln(sd, p + "norm2"),
            "attn": {"qkv": _linear(sd, p + "attn.qkv"), "proj": _linear(sd, p + "attn.proj")},
            "fc1": _linear(sd, p + "mlp.fc1"),
            "fc2": _linear(sd, p + "mlp.fc2"),
        }
    return prism_variables_from_jax({"params": params})


# ---------------------------------------------------------------------------
# MADELEINE
# ---------------------------------------------------------------------------


class MadeleineNet(nn.Module):
    """MADELEINE's H&E slide encoder: a Linear + ReLU projection of the
    CONCH features, a gated attention net with one score per head, a
    softmax over tiles per head pooling that head's slice of the projected
    features, and a post-attention projection (512-d)."""

    def __init__(self, dim: int = 512, num_heads: int = 4, input_dim: int = 512) -> None:
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.pre_proj = nn.Linear(input_dim, dim)
        self.attn_a = nn.Linear(dim, dim)
        self.attn_b = nn.Linear(dim, dim)
        self.attn_c = nn.Linear(dim, num_heads)
        self.post_proj = nn.Linear(dim, dim)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:  # [N, input_dim] → [dim]
        h = F.relu(self.pre_proj(feats))
        gate = torch.tanh(self.attn_a(h)) * torch.sigmoid(self.attn_b(h))
        weights_ = torch.softmax(self.attn_c(gate), dim=0)  # [N, H], over tiles per head
        pooled = torch.einsum("nh,nhd->hd", weights_, h.reshape(-1, self.num_heads, self.dim // self.num_heads))
        return self.post_proj(pooled.reshape(self.dim))


def madeleine_variables_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``stamp_tpu`` MadeleineNet variable tree → this module's state dict."""
    return weights.state_dict_from_tree(variables)


def madeleine_variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`madeleine_variables_from_jax` (numpy leaves)."""
    return weights.tree_from_state_dict(state_dict)


def madeleine_state_dict(state_dict: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """An upstream MADELEINE checkpoint → this module's state dict: the JAX
    package's ``convert_madeleine_state_dict`` (``patch_embedder.0`` or
    ``pre_attn.0``, the gated attention, ``post_attention`` or
    ``post_proj``), then the flax rule."""
    sd = _strip_prefixes(state_dict)
    params = {
        "pre_proj": _linear(sd, "patch_embedder.0", "pre_attn.0"),
        **_gated_attention(sd),
        "post_proj": _linear(sd, "post_attention", "post_proj"),
    }
    return madeleine_variables_from_jax({"params": params})
