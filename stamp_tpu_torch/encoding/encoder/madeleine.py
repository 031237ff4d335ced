"""MADELEINE slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/madeleine.py``: the
multi-head gated-attention MIL of ``models.slide_encoders`` (CONCH 512-d
tile features, 512 wide, 4 heads; f32 on ``resolve_device(device)``); a
patient is the concatenation of its slides' tiles.  Weights: random under
``STAMP_RANDOM_WEIGHTS=1``, else a pre-seeded ``*madeleine*.pt`` /
``*MADELEINE*.safetensors`` (``encoder._weights``).
"""

from __future__ import annotations

import numpy as np

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder, forward_on
from stamp_tpu_torch.encoding.encoder._weights import load_or_init
from stamp_tpu_torch.models.slide_encoders import MadeleineNet, madeleine_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName

WEIGHT_FILES = ["*madeleine*.pt", "*MADELEINE*.safetensors"]


class Madeleine(Encoder):
    def __init__(self) -> None:
        self.model = load_or_init(
            MadeleineNet(), name="madeleine", weight_files=WEIGHT_FILES, load=madeleine_state_dict
        ).eval()
        super().__init__(
            identifier=EncoderName.MADELEINE,
            precision="torch.float32",
            required_extractors=[ExtractorName.CONCH],
        )

    def _generate_slide_embedding(self, feats, device, **kwargs) -> np.ndarray:
        return forward_on(self.model, device, np.asarray(feats, np.float32))

    def _generate_patient_embedding(self, feats_list, device, **kwargs) -> np.ndarray:
        return self._generate_slide_embedding(np.concatenate(feats_list, axis=0), device)
