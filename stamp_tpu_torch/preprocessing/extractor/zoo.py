"""Extractor factories for the ImageViT part of the foundation-model zoo.

Counterpart of ``stamp_tpu.preprocessing.extractor.zoo``: the same
identifiers, architectures and weight-file globs.  The other families (Swin,
CLIP, CoCa, BEiT3, TICON and ``empty``) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from stamp_tpu_torch.preprocessing.config import ExtractorName
from stamp_tpu_torch.preprocessing.extractor import Extractor, make_vit_extractor

# ExtractorName → make_vit_extractor arguments
_VIT_ZOO: dict[ExtractorName, dict] = {
    # MahmoodLab UNI
    ExtractorName.UNI: dict(
        identifier="uni",
        arch="uni",
        weight_files=["*uni*pytorch_model.bin", "uni.bin", "*UNI*.bin"],
    ),
    # MahmoodLab UNI2-h
    ExtractorName.UNI2: dict(
        identifier="uni2",
        arch="uni2",
        weight_files=["*uni2*pytorch_model.bin", "*UNI2*.bin", "*uni2*.safetensors"],
    ),
    # Paige Virchow, CLS token only
    ExtractorName.VIRCHOW: dict(
        identifier="virchow",
        arch="virchow",
        weight_files=["*virchow*.safetensors", "*Virchow*.bin"],
        pool="token",
    ),
    # Paige Virchow2, CLS token only
    ExtractorName.VIRCHOW2: dict(
        identifier="virchow2",
        arch="virchow2",
        weight_files=["*virchow2*.safetensors", "*Virchow2*.bin"],
        pool="token",
    ),
    # Virchow CLS ⧺ mean(patch tokens), 2560-d — required by PRISM
    ExtractorName.VIRCHOW_FULL: dict(
        identifier="virchow-full",
        arch="virchow",
        weight_files=["*virchow*.safetensors", "*Virchow*.bin"],
        pool="token_avg_concat",
    ),
    # Bioptimus H-Optimus-0 / -1
    ExtractorName.H_OPTIMUS_0: dict(
        identifier="h-optimus-0",
        arch="h_optimus",
        weight_files=["*h-optimus-0*.safetensors", "*h_optimus_0*.bin"],
    ),
    ExtractorName.H_OPTIMUS_1: dict(
        identifier="h-optimus-1",
        arch="h_optimus",
        weight_files=["*h-optimus-1*.safetensors", "*h_optimus_1*.bin"],
    ),
    # Prov-GigaPath tile encoder
    ExtractorName.GIGAPATH: dict(
        identifier="gigapath",
        arch="gigapath",
        weight_files=["*gigapath*.bin", "*prov-gigapath*.safetensors"],
    ),
    # DinoBloom-S (dinov2-small, hematology)
    ExtractorName.DINO_BLOOM: dict(
        identifier="dino-bloom",
        arch="dino_vits14",
        weight_files=["*dinobloom*.pth", "*DinoBloom*.pth"],
    ),
    # RedDino-large — dinov2 ViT-L/14, CLS only
    ExtractorName.RED_DINO: dict(
        identifier="red-dino",
        arch="dino_vitl14",
        weight_files=["*reddino*.pth", "*RedDino*.safetensors"],
    ),
    # mSTAR ViT-L/16, like UNI
    ExtractorName.MSTAR: dict(
        identifier="mstar",
        arch="uni",
        weight_files=["*mSTAR*.bin", "*mstar*.safetensors"],
    ),
}


def resolve_extractor(
    name: ExtractorName | str | Extractor, device: torch.device
) -> Extractor:
    """ExtractorName → Extractor on ``device``; an Extractor passes through."""
    if isinstance(name, Extractor):
        return name
    name = ExtractorName(name)
    if name not in _VIT_ZOO:
        raise NotImplementedError(
            f"extractor {name.value!r} is not ported to stamp_tpu_torch yet "
            "(ROADMAP.md Queue A, other extractor families); run "
            "`python -m stamp_tpu preprocess` for it"
        )
    return make_vit_extractor(**_VIT_ZOO[name], device=device)
