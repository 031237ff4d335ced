"""How the benchmark draws a model's weights: each parameter's role."""

from __future__ import annotations

import math

import torch


def param_roles(model: torch.nn.Module) -> dict[str, str]:
    """Each parameter's role by its module: "norm_scale" and "norm_shift" of
    a LayerNorm, "layerscale" (a LayerScale's ``gamma``), "weight" (a matrix
    or kernel: std fan_in^-1/2), "bias", or "embedding" (tokens and position
    embeddings)."""
    roles = {}
    for mname, module in model.named_modules():
        for pname, param in module.named_parameters(recurse=False):
            key = f"{mname}.{pname}" if mname else pname
            if isinstance(module, torch.nn.LayerNorm):
                roles[key] = "norm_scale" if pname == "weight" else "norm_shift"
            elif pname == "gamma":
                roles[key] = "layerscale"
            elif pname == "weight" and param.dim() >= 2:
                roles[key] = "weight"
            elif pname == "bias":
                roles[key] = "bias"
            else:
                roles[key] = "embedding"
    return roles


def scale_draw(z: torch.Tensor, role: str, shape: tuple[int, ...], assumed: dict) -> torch.Tensor:
    """A standard normal draw ``z`` made into a leaf of ``role``: weights
    N(0, 1/fan_in), biases and LayerNorm shifts N(0, affine_std²), LayerNorm
    scales 1 + N(0, affine_std²), LayerScale ``layerscale`` · (1 + N(0,
    affine_std²)), embeddings N(0, embedding_std²)."""
    if role == "weight":
        return z * math.prod(shape[1:]) ** -0.5
    if role in ("bias", "norm_shift"):
        return z * assumed["affine_std"]
    if role == "norm_scale":
        return z * assumed["affine_std"] + 1.0
    if role == "layerscale":
        return (z * assumed["affine_std"] + 1.0) * assumed["layerscale"]
    return z * assumed["embedding_std"]
