"""TICON extractor, in PyTorch: the H-Optimus-1 tile encoder, then the TICON
contextualizer on a one-tile context with zero relative coordinates.

Counterpart of ``stamp_tpu.preprocessing.extractor.ticon``.  The tile tower
is the port's ImageViT (its blocks run the ``fused_qkv_mha`` and
``ln_dense`` / ``ln_quant_dense`` kernels on the card); the encoder
(``models.ticon``) is plain PyTorch.  Both run in bf16, or W8A8 with both
towers calibrated on the first batch when int8 extraction is requested.
"""

from __future__ import annotations

import torch
from torch import nn

from stamp_tpu_torch.models import ticon
from stamp_tpu_torch.models.vit_image import ImageViT, init_random_weights_, select_timm_state_dict, vit_quant_sites
from stamp_tpu_torch.preprocessing.extractor import (
    Extractor,
    _find_torch_weights,
    _load_torch_state_dict,
    load_or_init_,
    tower_extractor,
    vit_config,
    with_quant,
)


class TiconModel(nn.Module):
    """H-Optimus-1 tile embedding [B, 1536] → the TICON encoder over a
    one-tile context at coordinates (0, 0) → [B, 1536]."""

    def __init__(self, tile: ImageViT, encoder: ticon.TiconEncoder) -> None:
        super().__init__()
        self.tile = tile
        self.encoder = encoder

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        emb = self.tile(images)[:, None, :]  # [B, 1, 1536]: a single-tile context
        coords = emb.new_zeros(emb.shape[0], 1, 2)
        return self.encoder(emb, coords)[:, 0]


_TILE_WEIGHTS = ["*h-optimus-1*.safetensors", "*h_optimus_1*.bin"]
_TICON_WEIGHTS = ["*TICON*checkpoint.pth", "*ticon*.pth"]


def _load_ticon(tile_sd: dict[str, torch.Tensor], model: TiconModel) -> dict[str, torch.Tensor]:
    ticon_path = _find_torch_weights(_TICON_WEIGHTS)
    if ticon_path is None:
        raise FileNotFoundError(
            "weights for 'ticon' not found (needs both the H-Optimus-1 and TICON "
            "checkpoints in ~/.cache/stamp or STAMP_WEIGHTS_DIR)."
        )
    sd = _load_torch_state_dict(ticon_path)
    sd = {k.removeprefix("backbone."): v for k, v in sd.items() if k.startswith("backbone.")} or sd
    return {
        **{f"tile.{k}": v for k, v in select_timm_state_dict(tile_sd, model.tile).items()},
        **{f"encoder.{k}": v for k, v in ticon.convert_ticon_state_dict(sd).items()},
    }


def _init_ticon(model: TiconModel, generator: torch.Generator) -> TiconModel:
    init_random_weights_(model.tile, generator)
    ticon.init_random_weights_(model.encoder, generator)
    return model


def make_ticon_extractor(identifier: str = "ticon", *, device: torch.device) -> Extractor:
    cfg = vit_config("h_optimus")
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: TiconModel(ImageViT(with_quant(cfg, quant)), ticon.TiconEncoder(quant=quant)),
        load=lambda model: load_or_init_(
            model, identifier=identifier, weight_files=_TILE_WEIGHTS, load=_load_ticon, init=_init_ticon
        ),
        sites=[f"tile.{s}" for s in vit_quant_sites(cfg.depth)]
        + [f"encoder.{s}" for s in ticon.ticon_quant_sites(ticon.DEPTH)],
        device=device,
        input_px=224,
        feat_dim=1536,
        mean=cfg.mean,
        std=cfg.std,
    )
