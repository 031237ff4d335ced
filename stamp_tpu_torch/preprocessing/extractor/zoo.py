"""Extractor factories for the foundation-model zoo.

Counterpart of ``stamp_tpu.preprocessing.extractor.zoo``: the same
identifiers, architectures and weight-file globs, one factory per
``ExtractorName``.  Most models are instances of the shared ``ImageViT``
(``_VIT_ZOO``); CTransPath and CHIEF use the Swin backbone
(``extractor.swin``), PLIP the CLIP tower and KEEP a ViT-L with a head
(``extractor.clip_like``), CONCH and CONCH1.5 the CoCa tower and MUSK the
BEiT3 tower (``extractor.coca_beit3``), TICON the contextualizer
(``extractor.ticon``), and ``empty`` builds tile caches only.
"""

from __future__ import annotations

from typing import Callable

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


def _families(device: torch.device) -> dict[ExtractorName, Callable[[], Extractor]]:
    """The factories of the families outside the ImageViT zoo."""
    from stamp_tpu_torch.preprocessing.extractor import clip_like, coca_beit3, swin, ticon
    from stamp_tpu_torch.preprocessing.extractor.empty import empty

    return {
        # CTransPath Swin-T with conv stem, and its CHIEF-finetuned weights
        ExtractorName.CTRANSPATH: lambda: swin.make_ctranspath_extractor(identifier="ctranspath", device=device),
        ExtractorName.CHIEF_CTRANSPATH: lambda: swin.make_ctranspath_extractor(
            identifier="chief-ctranspath", weight_hint="chief", device=device
        ),
        # CONCH CoCa vision branch, unprojected pooled embedding; v1.5 is TITAN's tile encoder
        ExtractorName.CONCH: lambda: coca_beit3.make_conch_extractor("conch", "conch", device=device),
        ExtractorName.CONCH1_5: lambda: coca_beit3.make_conch_extractor("conch1_5", "conch1_5", device=device),
        # MUSK BEiT3-L vision path, two-scale
        ExtractorName.MUSK: lambda: coca_beit3.make_musk_extractor("musk", device=device),
        # PLIP CLIP ViT-B/32 image features; KEEP ViT-L + projection head
        ExtractorName.PLIP: lambda: clip_like.make_plip_extractor("plip", device=device),
        ExtractorName.KEEP: lambda: clip_like.make_keep_extractor("keep", device=device),
        # H-Optimus-1 → TICON contextualizer
        ExtractorName.TICON: lambda: ticon.make_ticon_extractor("ticon", device=device),
        ExtractorName.EMPTY: empty,
    }


def resolve_extractor(
    name: ExtractorName | str | Extractor, device: torch.device
) -> Extractor:
    """ExtractorName → Extractor on ``device``; an Extractor passes through."""
    if isinstance(name, Extractor):
        return name
    name = ExtractorName(name)
    if name in _VIT_ZOO:
        return make_vit_extractor(**_VIT_ZOO[name], device=device)
    return _families(device)[name]()
