"""CTransPath / CHIEF-CTransPath extractor factories (Swin backbone), in
PyTorch.

Counterpart of ``stamp_tpu.preprocessing.extractor.swin``: Swin-T with the
CTransPath conv stem (``models.swin``) in f32 with TF32 off, or W8A8 at its
block matmuls when int8 extraction is requested.  Plain PyTorch: no kernel
of the port runs here.
"""

from __future__ import annotations

import torch

from stamp_tpu_torch.models import swin
from stamp_tpu_torch.preprocessing.extractor import Extractor, load_or_init_, tower_extractor

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def make_ctranspath_extractor(*, identifier: str, weight_hint: str = "ctranspath", device: torch.device) -> Extractor:
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: swin.SwinTransformer(quant=quant),
        load=lambda model: load_or_init_(
            model,
            identifier=identifier,
            weight_files=[f"*{weight_hint}*.pth", f"*{weight_hint}*.bin", f"{weight_hint}.pth"],
            load=lambda sd, _: swin.convert_ctranspath_state_dict(sd),
            init=swin.init_random_weights_,
        ),
        sites=swin.swin_quant_sites(),
        device=device,
        input_px=224,
        feat_dim=768,
        mean=_IMAGENET_MEAN,
        std=_IMAGENET_STD,
        dtype=torch.float32,
    )
