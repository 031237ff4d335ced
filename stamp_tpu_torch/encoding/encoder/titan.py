"""TITAN slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/titan.py:26-59``: the vision
tower ``models.slide_encoders.TitanViT`` (f32, on an explicit device, under
``torch.inference_mode``) over CONCH1.5 tile features on the integer tile
grid ``(coords_um / mpp / tile_size_px)`` truncated to int64; patients are
encoded as one x-concatenated virtual slide.

Weights: ``STAMP_RANDOM_WEIGHTS=1`` draws random weights from
``torch.Generator().manual_seed(0)`` (other values than the JAX package's
random init, whose generator differs); otherwise a pre-seeded upstream
torch checkpoint (``*TITAN*.bin``, ``*titan*.safetensors``,
``*TITAN*.pth``) is loaded from the local caches, and a missing one raises
with the JAX package's guidance.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder
from stamp_tpu_torch.encoding.encoder._virtual_slide import VirtualSlidePatientMixin
from stamp_tpu_torch.models.slide_encoders import TitanViT, init_random_weights_, load_titan_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName
from stamp_tpu_torch.preprocessing.extractor import _find_torch_weights, _load_torch_state_dict
from stamp_tpu_torch.utils.device import resolve_device

_logger = logging.getLogger("stamp")

WEIGHT_FILES = ["*TITAN*.bin", "*titan*.safetensors", "*TITAN*.pth"]


def load_titan(model: TitanViT) -> TitanViT:
    """Random (STAMP_RANDOM_WEIGHTS=1) or pre-seeded upstream weights, on
    the CPU."""
    if os.environ.get("STAMP_RANDOM_WEIGHTS") == "1":
        _logger.warning(
            "titan: using RANDOM weights (STAMP_RANDOM_WEIGHTS=1) — embeddings are only useful for smoke testing"
        )
        return init_random_weights_(model, torch.Generator().manual_seed(0))
    path = _find_torch_weights(WEIGHT_FILES)
    if path is None:
        raise FileNotFoundError(
            f"no weights found for 'titan' (searched caches for {WEIGHT_FILES}). "
            "Pre-seed the checkpoint into ~/.cache/stamp or set STAMP_WEIGHTS_DIR; "
            "set STAMP_RANDOM_WEIGHTS=1 for smoke testing without weights."
        )
    _logger.info(f"titan: loading torch weights from {path}")
    model.load_state_dict(load_titan_state_dict(_load_torch_state_dict(path), model))
    return model


class Titan(VirtualSlidePatientMixin, Encoder):
    def __init__(self) -> None:
        self.model = load_titan(TitanViT()).eval()
        super().__init__(
            identifier=EncoderName.TITAN,
            precision="torch.float32",
            required_extractors=[ExtractorName.CONCH1_5],
        )

    def _generate_slide_embedding(self, feats, device, coords=None, **kwargs) -> np.ndarray:
        if coords is None:
            raise ValueError("Coords must be provided.")
        dev = resolve_device(device)
        # µm → px → integer tile-grid units
        coords_px = np.asarray(coords.coords_um, np.float64) / coords.mpp
        grid = (coords_px / float(coords.tile_size_px)).astype(np.int64)
        self.model.to(dev)
        with torch.inference_mode():
            out = self.model(
                torch.as_tensor(np.asarray(feats, np.float32), device=dev), torch.from_numpy(grid).to(dev)
            )
        return out.float().cpu().numpy()

    def _generate_patient_embedding(self, feats_list, device, **kwargs):
        raise RuntimeError("TITAN patients are encoded via the virtual-slide path")  # encode_patients_ is overridden
