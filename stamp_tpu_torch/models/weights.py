"""Weights of the MIL backbones across the two packages, and their seeded
initialisation.

The JAX package's ``model.ckpt`` holds each backbone's flax variable tree
(``{"params": ..., "alibi_stats": ...}``, nested dicts of arrays).  Every
MIL backbone of the port names its submodules after that tree, so one rule
carries a leaf to a ``state_dict`` entry and back:

* a Dense ``kernel`` [in, out] is a Linear ``weight`` [out, in];
* a LayerNorm ``scale`` is its ``weight``;
* every other leaf keeps its name and value.

Each backbone's module (``models.vision_transformer``, ``models.mlp``,
``models.trans_mil``, ``models.barspoon``) builds its
``variables_from_jax`` / ``variables_to_jax`` pair on :func:`state_dict_from_tree`
and :func:`tree_from_state_dict` (TransMIL adds its convolutions' layout),
and defines ``init_random_weights_``; :func:`load_variables_`,
:func:`variables_of` and :func:`init_weights_` find them from the module's
class.
"""

from __future__ import annotations

from collections.abc import Callable, Mapping
from types import ModuleType
from typing import Any

import numpy as np
import torch
from torch import nn


def flatten(tree: Mapping, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    """{path: leaf} of a nested dict of arrays."""
    out: dict[tuple[str, ...], np.ndarray] = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out |= flatten(value, prefix + (str(key),))
        else:
            out[prefix + (str(key),)] = np.asarray(value)
    return out


def state_dict_from_tree(variables: Mapping, collections: tuple[str, ...] = ("params",)) -> dict[str, torch.Tensor]:
    """The leaves of ``collections`` as f32 ``state_dict`` entries, Dense
    kernels transposed and LayerNorm scales renamed."""
    state: dict[str, torch.Tensor] = {}
    for collection in collections:
        for path, value in flatten(variables.get(collection, {})).items():
            *module, leaf = path
            if leaf == "kernel":
                leaf, value = "weight", value.T
            elif leaf == "scale":
                leaf = "weight"
            state[".".join([*module, leaf])] = torch.from_numpy(np.array(value, np.float32))
    return state


def tree_from_state_dict(
    state_dict: Mapping[str, torch.Tensor], collection_of: Callable[[str], str] = lambda leaf: "params"
) -> dict:
    """The exact inverse of :func:`state_dict_from_tree`: numpy leaves, each
    in the collection ``collection_of(leaf name)`` names."""
    variables: dict = {}
    for name, tensor in state_dict.items():
        *module, leaf = name.split(".")
        value = tensor.detach().cpu().numpy().astype(np.float32)
        collection = collection_of(leaf)
        if leaf == "weight":
            leaf, value = ("kernel", value.T.copy()) if value.ndim == 2 else ("scale", value)
        node = variables.setdefault(collection, {})
        for part in module:
            node = node.setdefault(part, {})
        node[leaf] = value
    return variables


def lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: a normal of variance 1 / fan_in truncated at
    two standard deviations (of the untruncated normal, rescaled)."""
    std = fan_in**-0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


def init_layers_(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers on every Linear and LayerNorm of
    ``model``, in module order: kernels ``lecun_normal``, biases zero,
    LayerNorm scales one."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                lecun_normal_(module.weight, module.in_features, generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()


def _codec(module: nn.Module) -> ModuleType:
    """The file that defines ``module``'s weight functions."""
    from stamp_tpu_torch.models import barspoon, mlp, trans_mil, vision_transformer

    codecs = {
        vision_transformer.VisionTransformer: vision_transformer,
        mlp.MLP: mlp,
        mlp.Linear: mlp,
        trans_mil.TransMIL: trans_mil,
        barspoon.EncDecTransformer: barspoon,
    }
    return codecs[type(module)]


def load_variables_(module: nn.Module, variables: Mapping[str, Any]) -> nn.Module:
    """Load a JAX variable tree into ``module`` (strict)."""
    module.load_state_dict(_codec(module).variables_from_jax(variables))
    return module


def variables_of(module: nn.Module) -> dict:
    """``module``'s weights as the JAX package's variable tree."""
    return _codec(module).variables_to_jax(module.state_dict())


def init_weights_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights with the flax module's distributions."""
    return _codec(module).init_random_weights_(module, generator)
