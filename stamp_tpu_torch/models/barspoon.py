"""Barspoon encoder–decoder transformer for multi-target classification.

Counterpart of ``stamp_tpu/models/barspoon.py:26-189``: the tile features
projected (Linear → ReLU), plus a sinusoidal encoding of the raw µm tile
coordinates, a pre-LN transformer encoder (ReLU feed-forward), a decoder
over one learned class token per target (self-attention, then
cross-attention on the encoder's output under the key mask) and one head
per target; the output is a dict {target: logits [B, n classes]} in the
order of ``target_n_outs``.

Attention is the einsum ``ops.attention.multi_head_attention``, as in the
JAX module (``barspoon.py:23, 51``): no flash path.  A full bag of T tiles
holds [B, heads, T, T] f32 scores per encoder layer.  The encoding's
argument is ``coords / 100000**(i/d)`` in f32, computed in the JAX
module's order (the power, then the division): reordering it as a product
with the reciprocal moves the argument by an ulp of 1e5 (8e-3 rad).  The
powers are computed on the CPU on every device.
LayerNorms use flax's ε = 1e-6.  The submodules carry the JAX tree's names
(``projector``, ``encoder_{i}``, ``decoder_{i}``, ``class_token_{t}``,
``head_{t}`` with ``t = sanitize(target)``).
"""

from __future__ import annotations

import re
from collections.abc import Mapping, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import weights
from stamp_tpu_torch.ops.attention import multi_head_attention

_EPS = 1e-6  # flax LayerNorm's default epsilon


def sanitize(x: str) -> str:
    return re.sub(r"[^A-Za-z0-9_]", "_", x)


class _MHA(nn.Module):
    def __init__(self, dim: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def _to_heads(self, t: torch.Tensor) -> torch.Tensor:
        b, s, dim = t.shape
        return t.reshape(b, s, self.heads, dim // self.heads).transpose(1, 2)

    def forward(self, q_in: torch.Tensor, kv_in: torch.Tensor, *, key_mask: torch.Tensor | None = None) -> torch.Tensor:
        q, k, v = self._to_heads(self.q(q_in)), self._to_heads(self.k(kv_in)), self._to_heads(self.v(kv_in))
        out = multi_head_attention(q, k, v, key_mask=key_mask)
        b, h, s, d = out.shape
        return self.out(out.transpose(1, 2).reshape(b, s, h * d))


class _EncoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dim_feedforward: int) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.self_attn = _MHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.ff1 = nn.Linear(dim, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, dim)

    def forward(self, x: torch.Tensor, *, key_mask: torch.Tensor | None) -> torch.Tensor:
        h = self.norm1(x)
        x = x + self.self_attn(h, h, key_mask=key_mask)
        return x + self.ff2(F.relu(self.ff1(self.norm2(x))))


class _DecoderLayer(nn.Module):
    def __init__(self, dim: int, heads: int, dim_feedforward: int) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=_EPS)
        self.self_attn = _MHA(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=_EPS)
        self.cross_attn = _MHA(dim, heads)
        self.norm3 = nn.LayerNorm(dim, eps=_EPS)
        self.ff1 = nn.Linear(dim, dim_feedforward)
        self.ff2 = nn.Linear(dim_feedforward, dim)

    def forward(self, tgt: torch.Tensor, memory: torch.Tensor, *, key_mask: torch.Tensor | None) -> torch.Tensor:
        h = self.norm1(tgt)
        tgt = tgt + self.self_attn(h, h)
        tgt = tgt + self.cross_attn(self.norm2(tgt), memory, key_mask=key_mask)
        return tgt + self.ff2(F.relu(self.ff1(self.norm3(tgt))))


def encoding_frequencies(d_model: int) -> torch.Tensor:
    """The d_model/4 frequencies 100000^(i/d_model), i = 0 … d_model/4 − 1, as
    f32 on the CPU: the exponent i/d_model as an f32 quotient (as the JAX
    module forms it), the power in f64, rounded once to f32.  That is the
    correctly rounded f32 power, whatever host or library computes it; an
    f32 ``pow`` (XLA's, torch's, numpy's, a card's) may be an ulp off in a
    few of them, ~6e-3 rad at 1e5 µm."""
    exponent = torch.arange(d_model // 4, dtype=torch.float32) / d_model
    return torch.pow(100_000.0, exponent.double()).float()


def positional_encoding(coords: torch.Tensor, d_model: int) -> torch.Tensor:
    """[B, T, 2] µm → [B, T, d_model]: d_model/4 frequencies × {x, y} ×
    {sin, cos} (reference barspoon.py:173-186), at the correctly rounded
    frequencies of :func:`encoding_frequencies`."""
    freqs = encoding_frequencies(d_model).to(device=coords.device, dtype=coords.dtype)
    scaled = coords[..., None] / freqs  # [B, T, 2, d_model // 4]
    return torch.cat([torch.sin(scaled).flatten(-2), torch.cos(scaled).flatten(-2)], dim=-1)


class EncDecTransformer(nn.Module):
    """Reference barspoon.py:104-205."""

    supports_coords = True

    def __init__(
        self,
        *,
        dim_input: int,
        target_n_outs: Sequence[tuple[str, int]],  # ordered (target, n classes) pairs
        d_model: int = 512,
        num_encoder_heads: int = 8,
        num_decoder_heads: int = 8,
        num_encoder_layers: int = 2,
        num_decoder_layers: int = 2,
        dim_feedforward: int = 2048,
        positional_encoding: bool = True,
    ) -> None:
        super().__init__()
        self.target_n_outs = [(str(t), int(n)) for t, n in target_n_outs]
        self.d_model = d_model
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        self.positional_encoding = positional_encoding
        self.projector = nn.Linear(dim_input, d_model)
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_{i}", _EncoderLayer(d_model, num_encoder_heads, dim_feedforward))
        for t, n_out in self.target_n_outs:
            self.register_parameter(f"class_token_{sanitize(t)}", nn.Parameter(torch.zeros(d_model)))
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_{i}", _DecoderLayer(d_model, num_decoder_heads, dim_feedforward))
        for t, n_out in self.target_n_outs:
            self.add_module(f"head_{sanitize(t)}", nn.Linear(d_model, n_out))

    def forward(
        self,
        tile_tokens: torch.Tensor,  # [B, T, F]
        *,
        coords: torch.Tensor,  # [B, T, 2] µm
        key_mask: torch.Tensor | None = None,  # [B, T] True = valid tile
        train: bool = False,
        generator: torch.Generator | None = None,
    ) -> dict[str, torch.Tensor]:
        """``train`` and ``generator`` are the engine's uniform call (no dropout here)."""
        x = F.relu(self.projector(tile_tokens))
        if self.positional_encoding:
            x = x + positional_encoding(coords, self.d_model)
        for i in range(self.num_encoder_layers):
            x = getattr(self, f"encoder_{i}")(x, key_mask=key_mask)
        class_tokens = torch.stack([getattr(self, f"class_token_{sanitize(t)}") for t, _ in self.target_n_outs])
        tgt = class_tokens.expand(tile_tokens.shape[0], *class_tokens.shape)
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_{i}")(tgt, x, key_mask=key_mask)
        return {t: getattr(self, f"head_{sanitize(t)}")(tgt[:, i]) for i, (t, _) in enumerate(self.target_n_outs)}

    @staticmethod
    def model_params_keys() -> list[str]:
        return [
            "d_model",
            "num_encoder_heads",
            "num_decoder_heads",
            "num_encoder_layers",
            "num_decoder_layers",
            "dim_feedforward",
            "positional_encoding",
        ]


def variables_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX module's variables → a ``state_dict`` of :class:`EncDecTransformer`."""
    return weights.state_dict_from_tree(variables)


def variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The exact inverse of :func:`variables_from_jax`."""
    return weights.tree_from_state_dict(state_dict)


def init_random_weights_(model: EncDecTransformer, generator: torch.Generator) -> EncDecTransformer:
    """flax's initializers' distributions (kernels ``lecun_normal``, biases
    zero, LayerNorm scales one, class tokens U[0, 1)), drawn on the CPU from
    ``generator``; the values differ from flax's."""
    weights.init_layers_(model, generator)
    with torch.no_grad():
        for t, _ in model.target_n_outs:
            getattr(model, f"class_token_{sanitize(t)}").uniform_(0.0, 1.0, generator=generator)
    return model
