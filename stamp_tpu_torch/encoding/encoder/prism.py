"""PRISM slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/prism.py``: the Perceiver of
``models.slide_encoders`` (Virchow-full 2560-d tile features, 1280 wide,
512 latents, 8 layers of 16 heads; f32 on ``resolve_device(device)``),
whose mean latent is the ``image_embedding``; a patient is the
concatenation of its slides' tiles.  Weights: random under
``STAMP_RANDOM_WEIGHTS=1``, else a pre-seeded ``*prism*.bin`` /
``*Prism*.safetensors`` (``encoder._weights``).
"""

from __future__ import annotations

import numpy as np

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder, forward_on
from stamp_tpu_torch.encoding.encoder._weights import load_or_init
from stamp_tpu_torch.models.slide_encoders import PrismPerceiver, prism_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName

WEIGHT_FILES = ["*prism*.bin", "*Prism*.safetensors"]


class Prism(Encoder):
    def __init__(self) -> None:
        model = PrismPerceiver()
        self.model = load_or_init(
            model, name="prism", weight_files=WEIGHT_FILES, load=lambda sd: prism_state_dict(sd, model.depth)
        ).eval()
        super().__init__(
            identifier=EncoderName.PRISM,
            precision="torch.float16",
            required_extractors=[ExtractorName.VIRCHOW_FULL],
        )

    def _generate_slide_embedding(self, feats, device, **kwargs) -> np.ndarray:
        return forward_on(self.model, device, np.asarray(feats, np.float32))

    def _generate_patient_embedding(self, feats_list, device, **kwargs) -> np.ndarray:
        return self._generate_slide_embedding(np.concatenate(feats_list, axis=0), device)
