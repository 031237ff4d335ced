"""Weights of the slide encoders: random, or a pre-seeded upstream checkpoint.

Counterpart of ``stamp_tpu/encoding/encoder/_flax_params.py``, with the
same contract: ``STAMP_RANDOM_WEIGHTS=1`` gives random weights for smoke
tests and benchmarking (here from ``torch.Generator().manual_seed(0)``, so
other values than the JAX package's flax init); otherwise the first
checkpoint matching the encoder's file patterns is found in the local
caches (``STAMP_WEIGHTS_DIR``, ``~/.cache/stamp``, the HuggingFace cache),
and a missing one raises ``FileNotFoundError`` with the JAX package's
guidance.  The upstream weights are gated; a deployment without network
pre-seeds them.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Callable, Mapping

import torch
from torch import nn

from stamp_tpu_torch.models.slide_encoders import init_random_weights_
from stamp_tpu_torch.preprocessing.extractor import _find_torch_weights, _load_torch_state_dict

_logger = logging.getLogger("stamp")


def upstream_checkpoint(name: str, weight_files: list[str]) -> dict[str, Any] | None:
    """None under ``STAMP_RANDOM_WEIGHTS=1`` (with a warning), else the
    first pre-seeded checkpoint matching ``weight_files``; raises
    ``FileNotFoundError`` when there is none."""
    if os.environ.get("STAMP_RANDOM_WEIGHTS") == "1":
        _logger.warning(
            f"{name}: using RANDOM weights (STAMP_RANDOM_WEIGHTS=1) — embeddings are only useful for smoke testing"
        )
        return None
    path = _find_torch_weights(weight_files)
    if path is None:
        raise FileNotFoundError(
            f"no weights found for '{name}' (searched caches for {weight_files}). "
            "Pre-seed the checkpoint into ~/.cache/stamp or set STAMP_WEIGHTS_DIR; "
            "set STAMP_RANDOM_WEIGHTS=1 for smoke testing without weights."
        )
    _logger.info(f"{name}: loading torch weights from {path}")
    return _load_torch_state_dict(path)


def load_or_init(
    model: nn.Module,
    *,
    name: str,
    weight_files: list[str],
    load: Callable[[Mapping[str, Any]], Mapping[str, torch.Tensor]],
) -> nn.Module:
    """``model`` (on the CPU) with random weights or with the upstream
    checkpoint mapped onto its names by ``load`` (loaded strictly)."""
    checkpoint = upstream_checkpoint(name, weight_files)
    if checkpoint is None:
        return init_random_weights_(model, torch.Generator().manual_seed(0))
    model.load_state_dict(load(checkpoint))
    return model
