"""COBRA slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/cobra.py``: the Mamba2 tower of
``models.slide_encoders_cobra`` (768 wide, depth 2, the chunked SSD of
``ops.ssd``; f32 on ``resolve_device(device)``) over CONCH, UNI, Virchow2
or H-Optimus-0 features, whose output is the attention-weighted average of
the raw features, so its width is the extractor's; a patient is the
concatenation of its slides' tiles.  An input of another width raises the
JAX package's error (naming the widths whose heads the weights hold).

Weights: random under ``STAMP_RANDOM_WEIGHTS=1`` (every ``embed_{d}``
head), else a pre-seeded ``*cobra*.pth`` / ``*COBRA*.safetensors``
(``encoder._weights``) with the heads it holds.  They are loaded when the
encoder is made; the JAX package loads them at the first slide of each
width.
"""

from __future__ import annotations

import numpy as np
import torch

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder, forward_on
from stamp_tpu_torch.encoding.encoder._weights import upstream_checkpoint
from stamp_tpu_torch.models.slide_encoders import init_random_weights_
from stamp_tpu_torch.models.slide_encoders_cobra import CobraNet, cobra_input_dims, cobra_state_dict
from stamp_tpu_torch.preprocessing.config import ExtractorName

WEIGHT_FILES = ["*cobra*.pth", "*COBRA*.safetensors"]


def load_cobra() -> CobraNet:
    """Random weights with all four heads, or the checkpoint's."""
    checkpoint = upstream_checkpoint("cobra", WEIGHT_FILES)
    if checkpoint is None:
        return init_random_weights_(CobraNet(), torch.Generator().manual_seed(0))
    state = cobra_state_dict(checkpoint)
    model = CobraNet(input_dims=cobra_input_dims(state))
    model.load_state_dict(state)
    return model


class Cobra(Encoder):
    def __init__(self) -> None:
        self.model = load_cobra().eval()
        super().__init__(
            identifier=EncoderName.COBRA,
            precision="torch.float32",
            required_extractors=[
                ExtractorName.CONCH,
                ExtractorName.UNI,
                ExtractorName.VIRCHOW2,
                ExtractorName.H_OPTIMUS_0,
            ],
        )

    def _generate_slide_embedding(self, feats, device, **kwargs) -> np.ndarray:
        return forward_on(self.model, device, np.asarray(feats, np.float32))

    def _generate_patient_embedding(self, feats_list, device, **kwargs) -> np.ndarray:
        return self._generate_slide_embedding(np.concatenate(feats_list, axis=0), device)
