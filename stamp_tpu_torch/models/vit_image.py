"""Generic image Vision Transformer for the tile-extractor zoo, in PyTorch.

Counterpart of ``stamp_tpu.models.vit_image``.  The module tree follows
timm's state-dict layout (``patch_embed.proj``, ``blocks.N.norm1``,
``blocks.N.attn.qkv``, ``blocks.N.mlp.norm``, ``blocks.N.ls1.gamma``, …), so
published timm checkpoints load with ``load_state_dict``.  The forward takes
NHWC normalized images, the JAX package's layout, and returns [B, D_out].

Every LayerNorm that feeds a matmul is fused into it (``ops.ln_dense``:
norm1→qkv, norm2→fc1, SwiGLU's inner norm→fc2), and attention runs off the
packed qkv projection (``ops.flash_attention.fused_qkv_mha``).  On CUDA
tensors both launch their hand-written kernels; on CPU tensors their plain
PyTorch versions run.

The block matmuls are ``QuantDense`` layers with the JAX package's three
precisions (``ViTConfig.quant``): "off" (bf16), "observe" (bf16, recording
each site's activation maximum for calibration) and "int8" (W8A8: int8
weights per output channel, static per-tensor activation scales), where the
LayerNorm-fed sites run ``ops.ln_dense.ln_quant_dense``.  The int8 helpers
at the bottom (``quantize_vit_params``, ``calibrate_act_stats``) mirror
``stamp_tpu/models/vit_image.py:438-506`` on timm-named state dicts.
"""

from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass, field
from typing import Any, Iterator, Literal, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.ops.flash_attention import fused_qkv_mha, fused_qkv_mha_reference
from stamp_tpu_torch.ops.ln_dense import (
    layer_norm_f32,
    ln_dense,
    ln_dense_reference,
    ln_quant_dense,
    ln_quant_dense_reference,
    quantize_activation,
)


@dataclass(frozen=True)
class ViTConfig:
    img_size: int = 224
    patch_size: int = 16
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    ffn: Literal["mlp", "swiglu"] = "mlp"
    num_reg_tokens: int = 0
    class_token: bool = True
    pos_embed_cls: bool = True  # does pos_embed include the cls token slot?
    init_values: float | None = None  # LayerScale
    qkv_bias: bool = True
    norm_eps: float = 1e-6
    pool: Literal["token", "avg", "token_avg_concat"] = "token"
    act: Literal["gelu", "silu"] = "gelu"
    # normalization applied on device before the backbone
    mean: tuple[float, float, float] = (0.485, 0.456, 0.406)
    std: tuple[float, float, float] = (0.229, 0.224, 0.225)
    # block-Dense precision: "off" = bf16 everywhere; "observe" = bf16 +
    # record per-matmul activation maxima (calibration pass); "int8" = W8A8
    # matmuls with per-out-channel weight scales and static (calibrated)
    # per-tensor activation scales.  See `quantize_vit_params`.
    quant: Literal["off", "observe", "int8"] = "off"
    extra: dict[str, Any] = field(default_factory=dict)

    @property
    def num_patches(self) -> int:
        return (self.img_size // self.patch_size) ** 2

    @property
    def num_prefix_tokens(self) -> int:
        return (1 if self.class_token else 0) + self.num_reg_tokens


_QUANT_MODES = ("off", "observe", "int8")


class QuantDense(nn.Module):
    """``nn.Linear`` with the JAX package's int8 (W8A8) inference modes
    (``stamp_tpu.models.vit_image.QuantDense``).

    "off" and "observe" hold ``weight`` [N, K] and ``bias`` as ``nn.Linear``
    does, so timm checkpoints load unchanged; "observe" also keeps
    ``amax``, the running max |input| in f32 of the last calibration pass
    (an attribute, not state).  "int8" holds ``weight_q`` (int8 [N, K], the
    transpose of the JAX package's ``kernel_q``), ``w_scale`` (f32 [N]),
    ``amax`` (f32, the calibrated activation max) and ``bias``, all state.

    ``forward(x, norm)`` with a LayerNorm marks ``x`` as pre-normalization:
    "off" fuses it into the matmul (``ln_dense``), "int8" into the quantized
    matmul (``ln_quant_dense``, dense bias added in f32 before the cast as
    the fused JAX branch does), "observe" applies it unfused.  An int8 site
    without a LayerNorm quantizes, takes an exact integer product and adds
    the bias after the cast to the activation dtype, as the JAX package's
    unfused branch does.

    ``partial`` and ``finish`` split a site whose weight is sharded along K
    across ranks (tensor parallelism, ``parallel/tp_extractor.py``):
    ``partial`` gives this shard's sums before the epilogue (f32 in "off",
    exact i32 in "int8"), the caller all-reduces them, and ``finish``
    applies the epilogue once, in the order ``forward`` applies it."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, mode: str = "off") -> None:
        super().__init__()
        if mode not in _QUANT_MODES:
            raise ValueError(f"QuantDense mode {mode!r} is not one of {_QUANT_MODES}")
        self.mode = mode
        if mode == "int8":
            self.register_buffer("weight_q", torch.zeros(out_features, in_features, dtype=torch.int8))
            self.register_buffer("w_scale", torch.ones(out_features))
            self.register_buffer("amax", torch.ones(()))
        else:
            self.weight = nn.Parameter(torch.empty(out_features, in_features))
            self.amax: torch.Tensor | None = None
        self.bias = nn.Parameter(torch.zeros(out_features)) if bias else None

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm | None = None) -> torch.Tensor:
        if self.mode == "off":
            if norm is not None:
                return ln_dense(x, norm.weight, norm.bias, self.weight, self.bias, eps=norm.eps)
            return F.linear(x, self.weight, self.bias)
        if self.mode == "int8":
            if norm is not None:
                return ln_quant_dense(
                    x, norm.weight, norm.bias, self._s_x(), self.weight_q, self.w_scale, self.bias, eps=norm.eps
                )
            return self.finish(self.partial(x), x.dtype, fused=False)
        if norm is not None:
            x = layer_norm_f32(x, norm.weight, norm.bias, norm.eps).to(x.dtype)
        amax = x.abs().max().float()
        self.amax = amax if self.amax is None else torch.maximum(self.amax, amax)
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y

    def _s_x(self) -> torch.Tensor:
        """The int8 mode's static activation scale: 5% headroom over the
        calibration max, in f32 on the device."""
        return self.amax.clamp_min(1e-6) * 1.05

    def partial(
        self, x: torch.Tensor, norm: nn.LayerNorm | None = None, stats: torch.Tensor | None = None
    ) -> torch.Tensor:
        """The sums of ``x @ weight.T`` over this site's K (a shard of the
        whole K), before the bias and the cast: f32 in "off" (the LayerNorm
        kernel's partial-sum form after ``norm``, else an f32 product of the
        operands), exact i32 in "int8" (``ln_quant_dense``'s partial-sum
        form, else ``torch._int_mm`` of the quantized activation).  ``norm``
        is the LayerNorm over the whole K and ``stats`` ([2, M] f32, μ and
        1/σ of x's rows over the whole K) its statistics; ``norm`` holds
        this shard's slice of γ and β."""
        if self.mode == "off":
            if norm is not None:
                return ln_dense(x, norm.weight, norm.bias, self.weight, eps=norm.eps, stats=stats, partial=True)
            return torch.matmul(x.float(), self.weight.to(x.dtype).float().t())
        if self.mode == "int8":
            s_x = self._s_x()
            if norm is not None:
                return ln_quant_dense(
                    x, norm.weight, norm.bias, s_x, self.weight_q, self.w_scale, eps=norm.eps, stats=stats,
                    partial=True,
                )  # fmt: skip
            # the JAX package leaves this product to XLA, outside any Pallas
            # kernel: here cuBLASLt's int8 GEMM on the card, exact i32 sums
            acc = torch._int_mm(quantize_activation(x, s_x).reshape(-1, x.shape[-1]), self.weight_q.t())
            return acc.reshape(*x.shape[:-1], -1)
        raise ValueError("QuantDense.partial: an observe-mode site is not sharded; calibrate on one rank")

    def finish(self, acc: torch.Tensor, dtype: torch.dtype, *, fused: bool) -> torch.Tensor:
        """The epilogue of ``forward`` on all-reduced ``partial`` sums, in
        ``dtype``: "off" adds the bias in f32 and casts once; "int8"
        dequantizes (``acc · (s_x / 127) · w_scale``) and, where the site
        is LayerNorm-fed (``fused``: ``ln_quant_dense``), adds the bias in
        f32 before the cast, else after it, as ``forward`` does."""
        if self.mode == "off":
            y = acc if self.bias is None else acc + self.bias.float()
            return y.to(dtype)
        y = acc.float() * (self._s_x() / 127.0) * self.w_scale.float()
        if self.bias is None:
            return y.to(dtype)
        if fused:
            return (y + self.bias.float()).to(dtype)
        return y.to(dtype) + self.bias.to(dtype)


class _LayerScale(nn.Module):
    def __init__(self, dim: int, init_values: float) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), float(init_values)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class _PatchEmbed(nn.Module):
    def __init__(self, patch_size: int, dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(3, dim, kernel_size=patch_size, stride=patch_size)

    def forward(self, images_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.proj(images_nhwc.permute(0, 3, 1, 2))  # [B, D, h, w]
        return x.flatten(2).transpose(1, 2)  # [B, h·w, D], row-major patches


class _Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, quant: str) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = QuantDense(dim, 3 * dim, bias=qkv_bias, mode=quant)
        self.proj = QuantDense(dim, dim, mode=quant)

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        return self.proj(fused_qkv_mha(self.qkv(x, norm), self.num_heads))


class _Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, act: str, quant: str) -> None:
        super().__init__()
        self.act = act
        self.fc1 = QuantDense(dim, hidden, mode=quant)
        self.fc2 = QuantDense(hidden, dim, mode=quant)

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        h = self.fc1(x, norm)
        h = F.gelu(h) if self.act == "gelu" else F.silu(h)
        return self.fc2(h)


class _SwiGLU(nn.Module):
    """timm SwiGLUPacked: fc1 emits ``hidden`` features split into halves,
    gate = silu(x1)·x2, then an inner LayerNorm (fused into fc2)."""

    def __init__(self, dim: int, hidden: int, quant: str) -> None:
        super().__init__()
        self.fc1 = QuantDense(dim, hidden, mode=quant)
        self.norm = nn.LayerNorm(hidden // 2, eps=1e-6)
        self.fc2 = QuantDense(hidden // 2, dim, mode=quant)

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm) -> torch.Tensor:
        x1, x2 = self.fc1(x, norm).chunk(2, dim=-1)
        return self.fc2(F.silu(x1) * x2, self.norm)


class _Block(nn.Module):
    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        dim = cfg.embed_dim
        hidden = int(dim * cfg.mlp_ratio)
        self.norm1 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        self.attn = _Attention(dim, cfg.num_heads, cfg.qkv_bias, cfg.quant)
        self.norm2 = nn.LayerNorm(dim, eps=cfg.norm_eps)
        if cfg.ffn == "swiglu":
            self.mlp = _SwiGLU(dim, hidden, cfg.quant)
        else:
            self.mlp = _Mlp(dim, hidden, cfg.act, cfg.quant)
        if cfg.init_values is not None:
            self.ls1 = _LayerScale(dim, cfg.init_values)
            self.ls2 = _LayerScale(dim, cfg.init_values)
        else:
            self.ls1 = self.ls2 = nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(x, self.norm1))
        return x + self.ls2(self.mlp(x, self.norm2))


class ImageViT(nn.Module):
    """timm-compatible ViT backbone producing tile features."""

    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        if cfg.quant not in _QUANT_MODES:
            raise ValueError(f"ImageViT quant={cfg.quant!r} is not one of {_QUANT_MODES}")
        self.cfg = cfg
        dim = cfg.embed_dim
        self.patch_embed = _PatchEmbed(cfg.patch_size, dim)
        pos_len = cfg.num_patches + (1 if cfg.class_token and cfg.pos_embed_cls else 0)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_len, dim))
        if cfg.class_token:
            self.cls_token = nn.Parameter(torch.zeros(1, 1, dim))
        if cfg.num_reg_tokens:
            self.reg_token = nn.Parameter(torch.zeros(1, cfg.num_reg_tokens, dim))
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.depth))
        self.norm = nn.LayerNorm(dim, eps=cfg.norm_eps)

    def forward(self, images: torch.Tensor, part: str = "all") -> torch.Tensor:
        """images: [B, H, W, 3] float, already normalized. Returns [B, D_out].

        ``part`` splits the forward for pipeline parallelism
        (``parallel/pp_extractor.py``), as the JAX package's does:
        ``"embed"`` runs the patch embedding and token assembly and returns
        the [B, N, D] tokens; ``"head"`` takes such tokens and runs the
        final norm and the pooling; the blocks between them are the
        pipeline's.  ``"all"`` (the default) is the whole forward."""
        if part == "head":
            return self.head(images)
        if part not in ("all", "embed"):
            raise ValueError(f"ImageViT part {part!r} is not one of 'all', 'embed', 'head'")
        x = self.embed(images)
        if part == "embed":
            return x
        for block in self.blocks:
            x = block(x)
        return self.head(x)

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """The patch embedding and the token assembly: [B, N, D] tokens
        (class token, register tokens, patches)."""
        cfg = self.cfg
        b = images.shape[0]
        x = self.patch_embed(images)
        tokens = []
        if cfg.class_token:
            cls = self.cls_token.expand(b, -1, -1)
            if cfg.pos_embed_cls:  # pos_embed covers [cls; patches]
                cls = cls + self.pos_embed[:, :1]
                x = x + self.pos_embed[:, 1:]
            else:
                x = x + self.pos_embed
            tokens.append(cls)
        else:
            x = x + self.pos_embed
        if cfg.num_reg_tokens:
            tokens.append(self.reg_token.expand(b, -1, -1))
        tokens.append(x)
        return torch.cat(tokens, dim=1)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the pooling of [B, N, D] tokens: [B, D_out]."""
        return self._pool(self.norm(x))

    def _pool(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        n_prefix = cfg.num_prefix_tokens
        if cfg.pool == "token":
            return x[:, 0]
        if cfg.pool == "avg":
            return x[:, n_prefix:].mean(dim=1)
        if cfg.pool == "token_avg_concat":
            # virchow-full: CLS ⧺ mean(patch tokens)
            return torch.cat([x[:, 0], x[:, n_prefix:].mean(dim=1)], dim=-1)
        raise ValueError(cfg.pool)


@contextlib.contextmanager
def plain_kernels() -> Iterator[None]:
    """Within the block, every ImageViT block (and so CoCa's trunk, KEEP's
    and TICON's tile tower) runs the plain PyTorch versions of
    ``fused_qkv_mha``, ``ln_dense`` and ``ln_quant_dense`` in place of their
    kernels: the path a kernel path is held to on the card."""
    module = sys.modules[__name__]
    plain = {"ln_dense": ln_dense_reference, "ln_quant_dense": ln_quant_dense_reference,
             "fused_qkv_mha": fused_qkv_mha_reference}  # fmt: skip
    kernels = {name: getattr(module, name) for name in plain}
    for name, fn in plain.items():
        setattr(module, name, fn)
    try:
        yield
    finally:
        for name, fn in kernels.items():
            setattr(module, name, fn)


def init_random_weights_(model: ImageViT, generator: torch.Generator, affine_std: float = 0.0) -> ImageViT:
    """Random weights for benchmarking, drawn on the CPU from ``generator``.

    The distributions follow the flax module's initializers (dense and conv
    kernels normal with std fan_in^-1/2, biases and tokens zero, pos_embed
    normal with std 0.02, LayerNorm scale one, LayerScale ``init_values``),
    but the values differ from flax's: the two frameworks' generators give
    different numbers for the same seed.  With ``affine_std`` > 0 every
    bias and LayerNorm β is normal with that std and every LayerNorm γ one
    plus such a draw, as in a trained model, where they differ from
    channel to channel."""

    def affine_(t: torch.Tensor, base: float) -> None:
        if affine_std:
            t.normal_(base, affine_std, generator=generator)
        else:
            t.fill_(base)

    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, (nn.Linear, nn.Conv2d)) or (
                isinstance(module, QuantDense) and module.mode != "int8"
            ):
                fan_in = module.weight[0].numel()
                module.weight.normal_(0.0, fan_in**-0.5, generator=generator)
                if module.bias is not None:
                    affine_(module.bias, 0.0)
            elif isinstance(module, nn.LayerNorm):
                affine_(module.weight, 1.0)
                affine_(module.bias, 0.0)
            elif isinstance(module, _LayerScale):
                module.gamma.fill_(float(model.cfg.init_values))
        model.pos_embed.normal_(0.0, 0.02, generator=generator)
        for name in ("cls_token", "reg_token"):
            if hasattr(model, name):
                getattr(model, name).zero_()
    return model


def _timm_aliases(key: str) -> list[str]:
    """Checkpoint names a parameter may carry (timm's and older spellings)."""
    aliases = [key]
    if key == "reg_token":
        aliases.append("register_tokens")
    if key.endswith("ls1.gamma"):
        aliases.append(key.replace("ls1.gamma", "gamma_1"))
    if key.endswith("ls2.gamma"):
        aliases.append(key.replace("ls2.gamma", "gamma_2"))
    return aliases


def select_timm_state_dict(
    state_dict: Mapping[str, torch.Tensor], model: ImageViT
) -> dict[str, torch.Tensor]:
    """The entries of a timm checkpoint that ``model`` holds, under its own
    names; other entries (heads, mask tokens) are ignored.  Raises KeyError
    naming every parameter the checkpoint lacks."""
    selected: dict[str, torch.Tensor] = {}
    missing = []
    for key in model.state_dict():
        hit = next((a for a in _timm_aliases(key) if a in state_dict), None)
        if hit is None:
            missing.append(key)
        else:
            selected[key] = state_dict[hit]
    if missing:
        raise KeyError(f"checkpoint lacks {len(missing)} ImageViT parameters: {missing[:8]}")
    return selected


# ---------------------------------------------------------------------------
# flax → timm weight conversion
# ---------------------------------------------------------------------------


def state_dict_from_jax(variables: Mapping[str, Any], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Map a ``stamp_tpu`` ImageViT variable tree onto timm names.

    The exact inverse of ``stamp_tpu.models.vit_image.convert_torch_state_dict``:
    the patch kernel goes [ph, pw, 3, D] → [D, 3, ph, pw], dense kernels
    [in, out] → [out, in]; register tokens, LayerScale and the SwiGLU inner
    norm are carried over.  An int8 tree (``quantize_vit_params``) maps
    ``kernel_q`` [in, out] → ``weight_q`` [out, in] and ``w_scale`` as it
    is, and an ``act_stats`` collection each site's ``amax``.  Leaves are
    array-likes (numpy)."""
    params = variables["params"]

    def t(a: Any, *transpose: int) -> torch.Tensor:
        arr = np.asarray(a)
        if transpose:
            arr = arr.transpose(*transpose)
        return torch.tensor(arr)  # a contiguous, writable copy

    sd: dict[str, torch.Tensor] = {
        "patch_embed.proj.weight": t(params["patch_embed"]["kernel"], 3, 2, 0, 1),
        "patch_embed.proj.bias": t(params["patch_embed"]["bias"]),
        "pos_embed": t(params["pos_embed"]),
    }
    if cfg.class_token:
        sd["cls_token"] = t(params["cls_token"])
    if cfg.num_reg_tokens:
        sd["reg_token"] = t(params["reg_token"])

    act_stats = variables.get("act_stats", {})

    def dense(prefix: str, leaf: Mapping[str, Any], stats: Mapping[str, Any] | None) -> None:
        if "kernel_q" in leaf:  # an int8 site (quantize_vit_params)
            sd[prefix + ".weight_q"] = t(leaf["kernel_q"], 1, 0)
            sd[prefix + ".w_scale"] = t(leaf["w_scale"])
        else:
            sd[prefix + ".weight"] = t(leaf["kernel"], 1, 0)
        if "bias" in leaf:
            sd[prefix + ".bias"] = t(leaf["bias"])
        if stats is not None:
            sd[prefix + ".amax"] = t(stats["amax"])

    def norm(prefix: str, leaf: Mapping[str, Any]) -> None:
        sd[prefix + ".weight"] = t(leaf["scale"])
        sd[prefix + ".bias"] = t(leaf["bias"])

    for i in range(cfg.depth):
        block = params[f"block_{i}"]
        p = f"blocks.{i}."
        norm(p + "norm1", block["norm1"])
        norm(p + "norm2", block["norm2"])
        stats = act_stats.get(f"block_{i}", {})
        for branch, site in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            dense(f"{p}{branch}.{site}", block[branch][site], stats.get(branch, {}).get(site))
        if "norm" in block["mlp"]:
            norm(p + "mlp.norm", block["mlp"]["norm"])
        if "ls1_gamma" in block:
            sd[p + "ls1.gamma"] = t(block["ls1_gamma"])
            sd[p + "ls2.gamma"] = t(block["ls2_gamma"])
    norm("norm", params["norm"])
    return sd


# ---------------------------------------------------------------------------
# int8 (W8A8) post-training quantization
# ---------------------------------------------------------------------------


def _quantized_dense_site(weight: torch.Tensor, bias: torch.Tensor | None) -> dict[str, torch.Tensor]:
    """A Dense site's ``weight`` [N, K] → the int8 QuantDense state:
    ``w_scale = max(max|W[n, :]|, 1e-8) / 127`` (f32, per output channel,
    computed where the weight lies) and ``weight_q = clip(round(W /
    w_scale), −127, 127)`` (int8); the bias rides along."""
    w = weight.float()
    scale = torch.clamp_min(w.abs().amax(dim=1), 1e-8) / 127.0
    out = {"weight_q": torch.clamp(torch.round(w / scale[:, None]), -127, 127).to(torch.int8), "w_scale": scale}
    if bias is not None:
        out["bias"] = bias
    return out


def quantize_sites(state_dict: Mapping[str, torch.Tensor], sites) -> dict[str, torch.Tensor]:
    """Pre-quantize the Dense weights at explicit module paths (e.g.
    ``"blocks.0.attn.qkv"``) of a state dict; every listed site must be a
    QuantDense of the int8-mode module.  Everything else (patch embedding,
    LayerNorms, LayerScale) stays as it is."""
    sd = dict(state_dict)
    for site in sites:
        sd.update({
            f"{site}.{name}": value
            for name, value in _quantized_dense_site(sd.pop(f"{site}.weight"), sd.pop(f"{site}.bias", None)).items()
        })  # fmt: skip
    return sd


def vit_quant_sites(depth: int) -> list[str]:
    """The QuantDense sites of an ImageViT block stack."""
    return [f"blocks.{i}.{site}" for i in range(depth) for site in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")]


def quantize_vit_params(state_dict: Mapping[str, torch.Tensor], cfg: ViTConfig) -> dict[str, torch.Tensor]:
    """Pre-quantize an ``ImageViT(cfg)`` state dict for ``quant="int8"``."""
    return quantize_sites(state_dict, vit_quant_sites(cfg.depth))


def calibrate_act_stats(model: nn.Module, *inputs: torch.Tensor) -> dict[str, torch.Tensor]:
    """One observe-mode forward recording each matmul's activation maximum.

    ``model`` is an ``ImageViT`` or another extractor tower whose
    ``QuantDense`` sites are all in "observe" mode; ``inputs`` (the
    images, normalized like the real input) are what its forward takes.  Returns the ``<site>.amax`` entries
    (f32, on the model's device) to load beside the quantized weights."""
    sites = {name: m for name, m in model.named_modules() if isinstance(m, QuantDense)}
    modes = {m.mode for m in sites.values()}
    if modes != {"observe"}:
        raise ValueError(f"calibrate_act_stats needs an observe-mode model, not QuantDense modes {sorted(modes)}")
    for module in sites.values():
        module.amax = None
    with torch.inference_mode():
        model(*inputs)
    return {f"{name}.amax": module.amax for name, module in sites.items()}


# Architecture configs for the extractor zoo, field for field those of
# stamp_tpu.models.vit_image.VIT_CONFIGS.
VIT_CONFIGS: dict[str, ViTConfig] = {
    # MahmoodLab UNI — ViT-L/16, layerscale 1e-5
    "uni": ViTConfig(
        patch_size=16, embed_dim=1024, depth=24, num_heads=16, init_values=1e-5
    ),
    # MahmoodLab UNI2-h — ViT-H/14-reg8, embed 1536, depth 24, SwiGLU
    "uni2": ViTConfig(
        patch_size=14,
        embed_dim=1536,
        depth=24,
        num_heads=24,
        mlp_ratio=2.66667 * 2,
        ffn="swiglu",
        num_reg_tokens=8,
        init_values=1e-5,
        act="silu",
    ),
    # Paige Virchow / Virchow2 — ViT-H/14 with SwiGLU, 4 reg tokens on v2
    "virchow": ViTConfig(
        patch_size=14,
        embed_dim=1280,
        depth=32,
        num_heads=16,
        mlp_ratio=5.3375,
        ffn="swiglu",
        init_values=1e-5,
        mean=(0.5, 0.5, 0.5),
        std=(0.5, 0.5, 0.5),
    ),
    "virchow2": ViTConfig(
        patch_size=14,
        embed_dim=1280,
        depth=32,
        num_heads=16,
        mlp_ratio=5.3375,
        ffn="swiglu",
        num_reg_tokens=4,
        init_values=1e-5,
        mean=(0.5, 0.5, 0.5),
        std=(0.5, 0.5, 0.5),
    ),
    # Bioptimus H-Optimus-0/1 — ViT-g/14-reg4, custom norm constants
    "h_optimus": ViTConfig(
        patch_size=14,
        embed_dim=1536,
        depth=40,
        num_heads=24,
        num_reg_tokens=4,
        init_values=1e-5,
        mlp_ratio=5.33334,
        ffn="swiglu",
        mean=(0.707223, 0.578729, 0.703617),
        std=(0.211883, 0.230117, 0.177517),
    ),
    # Prov-GigaPath tile encoder — ViT-g/14
    "gigapath": ViTConfig(
        patch_size=16,
        embed_dim=1536,
        depth=40,
        num_heads=24,
        mlp_ratio=5.33334,
        ffn="swiglu",
        init_values=1e-5,
    ),
    # DinoBloom — dinov2 ViT-S/14 at 224 px, hematology
    "dino_vits14": ViTConfig(
        patch_size=14, embed_dim=384, depth=12, num_heads=6, init_values=1e-5
    ),
    # RedDino-large — dinov2 ViT-L/14 at 224 px, CLS token only
    "dino_vitl14": ViTConfig(
        patch_size=14, embed_dim=1024, depth=24, num_heads=16, init_values=1e-5
    ),
}
