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
with the JAX package's guidance (``encoder._weights``, shared by the
slide encoders).
"""

from __future__ import annotations

import numpy as np

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder, forward_on
from stamp_tpu_torch.encoding.encoder._virtual_slide import VirtualSlidePatientMixin
from stamp_tpu_torch.encoding.encoder._weights import load_or_init
from stamp_tpu_torch.models.slide_encoders import TitanViT, load_titan_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName

WEIGHT_FILES = ["*TITAN*.bin", "*titan*.safetensors", "*TITAN*.pth"]


def load_titan(model: TitanViT) -> TitanViT:
    """Random (STAMP_RANDOM_WEIGHTS=1) or pre-seeded upstream weights, on
    the CPU."""
    return load_or_init(
        model, name="titan", weight_files=WEIGHT_FILES, load=lambda sd: load_titan_state_dict(sd, model)
    )


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
        # µm → px → integer tile-grid units
        coords_px = np.asarray(coords.coords_um, np.float64) / coords.mpp
        grid = (coords_px / float(coords.tile_size_px)).astype(np.int64)
        return forward_on(self.model, device, np.asarray(feats, np.float32), grid)

    def _generate_patient_embedding(self, feats_list, device, **kwargs):
        raise RuntimeError("TITAN patients are encoded via the virtual-slide path")  # encode_patients_ is overridden
