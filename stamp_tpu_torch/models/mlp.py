"""MLP and Linear heads for slide- and patient-level features.

Counterpart of ``stamp_tpu/models/mlp.py:17-69``: both take ``[B, F]`` or
``[B, T, F]`` (mean-pooled over the tiles).  ``MLP`` is ``num_layers − 1``
blocks of Linear → ReLU → dropout, then the output Linear; ``Linear`` is
one Linear.  The submodules carry the JAX tree's names (``fc{i}``, ``out``;
``fc``), so ``variables_from_jax`` / ``variables_to_jax`` are
``models.weights``' rule.  Dropout (``train=True``) draws from the
``generator`` the caller passes, as ``ops.attention.dropout``.  Under
sequence parallelism a tile bag's share is gathered before the mean
(``group.gather_seq``); slide and patient vectors have no sequence axis and
are the same on every rank of a sequence group.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import weights
from stamp_tpu_torch.ops.attention import dropout
from stamp_tpu_torch.ops.step_group import SINGLE, StepGroup
from stamp_tpu_torch.utils.shapecheck import Float, shapechecked


def _pool(x: torch.Tensor, group: StepGroup) -> torch.Tensor:
    return group.gather_seq(x, dim=1).mean(dim=1) if x.ndim == 3 else x


class MLP(nn.Module):
    supports_coords = False

    def __init__(
        self, *, dim_output: int, dim_input: int, dim_hidden: int = 512, num_layers: int = 2, dropout: float = 0.25
    ) -> None:
        super().__init__()
        self.num_layers = num_layers
        self.dropout = dropout
        for i in range(num_layers - 1):
            self.add_module(f"fc{i}", nn.Linear(dim_input if i == 0 else dim_hidden, dim_hidden))
        self.out = nn.Linear(dim_input if num_layers == 1 else dim_hidden, dim_output)

    @shapechecked
    def forward(
        self,
        x: Float[torch.Tensor, "batch feat"] | Float[torch.Tensor, "batch tiles feat"],
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        group: StepGroup = SINGLE,
    ) -> Float[torch.Tensor, "batch out"]:
        if train and self.dropout > 0.0 and generator is None:
            raise ValueError("training with dropout draws its masks from a generator; pass one")
        x = _pool(x, group)
        for i in range(self.num_layers - 1):
            x = dropout(F.relu(getattr(self, f"fc{i}")(x)), self.dropout, generator if train else None, group)
        return self.out(x)

    @staticmethod
    def model_params_keys() -> list[str]:
        return ["dim_hidden", "num_layers", "dropout"]


class Linear(nn.Module):
    supports_coords = False

    def __init__(self, *, dim_output: int, dim_input: int) -> None:
        super().__init__()
        self.fc = nn.Linear(dim_input, dim_output)

    @shapechecked
    def forward(
        self,
        x: Float[torch.Tensor, "batch feat"] | Float[torch.Tensor, "batch tiles feat"],
        *,
        train: bool = False,
        generator: torch.Generator | None = None,
        group: StepGroup = SINGLE,
    ) -> Float[torch.Tensor, "batch out"]:
        """``train`` and ``generator`` are the engine's uniform call (no dropout here)."""
        return self.fc(_pool(x, group))

    @staticmethod
    def model_params_keys() -> list[str]:
        return []


def variables_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX module's variables → a ``state_dict`` of :class:`MLP` or
    :class:`Linear`."""
    return weights.state_dict_from_tree(variables)


def variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The exact inverse of :func:`variables_from_jax`."""
    return weights.tree_from_state_dict(state_dict)


def init_random_weights_(model: MLP | Linear, generator: torch.Generator) -> MLP | Linear:
    """flax's initializers' distributions (kernels ``lecun_normal``, biases
    zero), drawn on the CPU from ``generator``; the values differ from
    flax's."""
    weights.init_layers_(model, generator)
    return model
