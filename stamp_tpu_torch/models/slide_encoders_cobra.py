"""COBRA's slide aggregator (Mamba2 + gated attention), in PyTorch.

Counterpart of ``CobraNet`` and ``convert_cobra_state_dict`` in
``stamp_tpu/models/slide_encoders.py`` (lines 361-398 and 566-600), split
from ``models/slide_encoders.py`` to keep that file short.  One input
projection ``embed_{d}`` per supported extractor width (CONCH 512, UNI
1024, H-Optimus-0 1536, Virchow2 2560) into a 768-d space, two pre-LN
Mamba2 mixers (``ops.ssd.Mamba2Block``: d_state 128, d_conv 4, expand 2,
head width 64, chunks of 64), a final LayerNorm and a gated attention net
384 wide whose softmax over tiles weights the *raw* input features: the
output has the input's width.

A model holds the heads of ``input_dims``; an upstream checkpoint's tree
carries every ``embed.{d}`` head it has, and ``cobra_input_dims`` reads
them off a state dict.  Submodules are named after the JAX module's flax
tree; ``cobra_state_dict`` is the JAX package's upstream converter
(mamba-ssm's ``Mamba2`` layout), copied.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import torch
from torch import nn

from stamp_tpu_torch.models import weights
from stamp_tpu_torch.models.slide_encoders import _gated_attention, _linear, _ln, _strip_prefixes, _t
from stamp_tpu_torch.ops.ssd import Mamba2Block

COBRA_INPUT_DIMS = (512, 1024, 1536, 2560)


class CobraNet(nn.Module):
    """Mamba2 mixer → gated attention → attention-weighted average of the
    raw tile features."""

    def __init__(self, d_model: int = 768, depth: int = 2, input_dims: Sequence[int] = COBRA_INPUT_DIMS) -> None:
        super().__init__()
        self.depth, self.input_dims = depth, tuple(input_dims)
        for d in self.input_dims:
            self.add_module(f"embed_{d}", nn.Linear(d, d_model))
        for i in range(depth):
            self.add_module(f"norm_{i}", nn.LayerNorm(d_model, eps=1e-6))
            self.add_module(f"mamba_{i}", Mamba2Block(d_model))
        self.norm = nn.LayerNorm(d_model, eps=1e-6)
        self.attn_a = nn.Linear(d_model, 384)
        self.attn_b = nn.Linear(d_model, 384)
        self.attn_c = nn.Linear(384, 1)

    def forward(self, feats: torch.Tensor) -> torch.Tensor:  # [N, d_in] → [d_in]
        d_in = feats.shape[-1]
        if d_in not in self.input_dims:
            raise ValueError(f"COBRA supports input dims {self.input_dims}, got {d_in}")
        x = getattr(self, f"embed_{d_in}")(feats)
        for i in range(self.depth):
            x = x + getattr(self, f"mamba_{i}")(getattr(self, f"norm_{i}")(x))
        h = self.norm(x)
        scores = self.attn_c(torch.tanh(self.attn_a(h)) * torch.sigmoid(self.attn_b(h)))[:, 0]
        return torch.softmax(scores, dim=0) @ feats


def cobra_input_dims(state_dict: Mapping[str, Any]) -> tuple[int, ...]:
    """The input widths whose ``embed_{d}`` head a state dict holds."""
    heads = (k.split(".")[0] for k in state_dict if k.startswith("embed_") and k.endswith(".weight"))
    return tuple(sorted(int(head.removeprefix("embed_")) for head in heads))


def cobra_variables_from_jax(variables: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """A ``stamp_tpu`` CobraNet variable tree (any set of ``embed_{d}``
    heads) → this module's state dict."""
    return weights.state_dict_from_tree(variables)


def cobra_variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The inverse of :func:`cobra_variables_from_jax` (numpy leaves)."""
    return weights.tree_from_state_dict(state_dict)


def cobra_state_dict(state_dict: Mapping[str, Any], depth: int = 2) -> dict[str, torch.Tensor]:
    """An upstream COBRA checkpoint → this module's state dict: the JAX
    package's ``convert_cobra_state_dict`` (every ``embed.{d}`` head,
    ``mamba.layers.{i}.norm`` and ``.mixer`` in mamba-ssm's layout with the
    conv weight [D, 1, K] taken to [K, D], the final ``norm``, the gated
    attention), then the flax rule."""
    sd = _strip_prefixes(state_dict)
    params: dict[str, Any] = {"norm": _ln(sd, "norm"), **_gated_attention(sd)}
    for key in sd:
        if key.startswith("embed.") and key.endswith(".weight"):
            d_in = key.split(".")[1]
            params[f"embed_{d_in}"] = _linear(sd, f"embed.{d_in}")
    for i in range(depth):
        p = f"mamba.layers.{i}."
        params[f"norm_{i}"] = _ln(sd, p + "norm")
        params[f"mamba_{i}"] = {
            "in_proj": _linear(sd, p + "mixer.in_proj", bias=False),
            "conv1d_weight": _t(sd, p + "mixer.conv1d.weight")[:, 0, :].T,
            "conv1d_bias": _t(sd, p + "mixer.conv1d.bias"),
            "A_log": _t(sd, p + "mixer.A_log"),
            "D": _t(sd, p + "mixer.D"),
            "dt_bias": _t(sd, p + "mixer.dt_bias"),
            "norm_weight": _t(sd, p + "mixer.norm.weight"),
            "out_proj": _linear(sd, p + "mixer.out_proj", bias=False),
        }
    return cobra_variables_from_jax({"params": params})
