"""GigaPath slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/gigapath.py``: the LongNetViT
of ``models.slide_encoders_longnet`` (1536-d GigaPath tile features, 768
wide, 12 layers of 12 heads, dilated attention; f32 on
``resolve_device(device)``) over the tile-grid coordinates
``coords_um / mpp / tile_size_px`` as floats (not truncated, unlike
TITAN's); patients are encoded as one x-concatenated virtual slide.
Weights: random under ``STAMP_RANDOM_WEIGHTS=1``, else a pre-seeded
``slide_encoder.pth`` / ``*gigapath*slide*.pth`` (``encoder._weights``).
"""

from __future__ import annotations

import numpy as np

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder, forward_on
from stamp_tpu_torch.encoding.encoder._virtual_slide import VirtualSlidePatientMixin
from stamp_tpu_torch.encoding.encoder._weights import load_or_init
from stamp_tpu_torch.models.slide_encoders_longnet import LongNetViT, gigapath_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName

WEIGHT_FILES = ["slide_encoder.pth", "*gigapath*slide*.pth"]


class Gigapath(VirtualSlidePatientMixin, Encoder):
    def __init__(self) -> None:
        model = LongNetViT()
        self.model = load_or_init(
            model,
            name="gigapath-slide",
            weight_files=WEIGHT_FILES,
            load=lambda sd: gigapath_state_dict(sd, model.depth),
        ).eval()
        super().__init__(
            identifier=EncoderName.GIGAPATH,
            precision="torch.float16",
            required_extractors=[ExtractorName.GIGAPATH],
        )

    def _generate_slide_embedding(self, feats, device, coords=None, **kwargs) -> np.ndarray:
        if coords is None:
            raise ValueError("Tile coords are required for encoding")
        # µm → px → tile-grid units (a position-embedding step is one tile)
        grid = np.asarray(coords.coords_um, np.float64) / coords.mpp / float(coords.tile_size_px)
        return forward_on(self.model, device, np.asarray(feats, np.float32), grid.astype(np.float32))

    def _generate_patient_embedding(self, feats_list, device, **kwargs):
        raise RuntimeError("GigaPath patients are encoded via the virtual-slide path")  # encode_patients_ is overridden
