"""The ``empty`` extractor: zero-dim features, used to only build tile
caches.  Counterpart of ``stamp_tpu.preprocessing.extractor.empty``."""

import numpy as np
import torch
from PIL import Image

from stamp_tpu_torch.preprocessing.extractor import Extractor


def empty() -> Extractor:
    def transform(img: Image.Image) -> np.ndarray:
        return np.asarray(img.convert("RGB"), dtype=np.uint8)

    def forward(batch: np.ndarray) -> torch.Tensor:
        return torch.zeros((batch.shape[0], 0))

    return Extractor(identifier="empty", input_px=224, feat_dim=0, transform_host=transform, forward=forward)
