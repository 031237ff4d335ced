"""CONCH / CONCH1.5 (CoCa) and MUSK (BEiT3) extractor factories, in PyTorch.

Counterpart of ``stamp_tpu.preprocessing.extractor.coca_beit3``: the CoCa
image path with ``proj_contrast=False`` (``models.coca``; its trunk blocks
run the port's ``fused_qkv_mha`` and ``ln_dense`` / ``ln_quant_dense``
kernels on the card) and the BEiT3 vision path with two-scale evaluation
(``models.beit3``, plain PyTorch).  Both run in bf16, or W8A8 when int8
extraction is requested; weights come from pre-seeded checkpoints or, under
``STAMP_RANDOM_WEIGHTS=1``, from a seeded ``torch.Generator``.
"""

from __future__ import annotations

from dataclasses import replace

import torch

from stamp_tpu_torch.models import beit3, coca
from stamp_tpu_torch.preprocessing.extractor import Extractor, load_or_init_, tower_extractor

_CONCH_WEIGHTS = {
    "conch": ["*conch*.bin", "*CONCH*.safetensors"],
    "conch1_5": ["*TITAN*.bin", "*conch*1*5*.safetensors"],
}


def make_conch_extractor(identifier: str, variant: str, *, device: torch.device) -> Extractor:
    """CONCH v1.0 / v1.5 CoCa vision branch."""
    cfg = coca.COCA_CONFIGS[variant]
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: coca.CoCaVisionTower(replace(cfg, quant=quant)),
        load=lambda model: load_or_init_(
            model,
            identifier=identifier,
            weight_files=_CONCH_WEIGHTS[variant],
            load=lambda sd, _: coca.convert_coca_state_dict(sd, cfg),
            init=coca.init_random_weights_,
        ),
        sites=coca.coca_quant_sites(cfg.depth),
        device=device,
        input_px=cfg.img_size,
        feat_dim=cfg.pooled_dim,
        mean=cfg.mean,
        std=cfg.std,
    )


def make_musk_extractor(identifier: str = "musk", *, device: torch.device) -> Extractor:
    """MUSK BEiT3-L vision path, two-scale.  The int8 calibration runs the
    native scale alone: it covers the crops' activation ranges too (same
    normalization, the same content at 2× zoom)."""
    cfg = beit3.Beit3Config()
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: beit3.Beit3VisionTower(replace(cfg, quant=quant)),
        load=lambda model: load_or_init_(
            model,
            identifier=identifier,
            weight_files=["*musk*.safetensors", "*MUSK*.pth"],
            load=lambda sd, _: beit3.convert_beit3_state_dict(sd, cfg),
            init=beit3.init_random_weights_,
        ),
        sites=beit3.beit3_quant_sites(cfg.depth),
        device=device,
        input_px=cfg.img_size,
        feat_dim=2 * cfg.width,
        mean=cfg.mean,
        std=cfg.std,
        apply=beit3.multiscale_cls,
    )
