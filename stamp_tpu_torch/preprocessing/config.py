"""Preprocessing config (parity with reference preprocessing/config.py).

Copy of ``stamp_tpu/preprocessing/config.py``, kept in the port so that it
imports nothing of the JAX package.
"""

from enum import StrEnum
from pathlib import Path
from typing import Literal

from pydantic import BaseModel, ConfigDict, Field

from stamp_tpu_torch.types import ImageExtension, Microns, SlideMPP, TilePixels


class ExtractorName(StrEnum):
    CTRANSPATH = "ctranspath"
    CHIEF_CTRANSPATH = "chief-ctranspath"
    CONCH = "conch"
    CONCH1_5 = "conch1_5"
    UNI = "uni"
    UNI2 = "uni2"
    DINO_BLOOM = "dino-bloom"
    GIGAPATH = "gigapath"
    H_OPTIMUS_0 = "h-optimus-0"
    H_OPTIMUS_1 = "h-optimus-1"
    VIRCHOW = "virchow"
    VIRCHOW_FULL = "virchow-full"
    VIRCHOW2 = "virchow2"
    MUSK = "musk"
    MSTAR = "mstar"
    PLIP = "plip"
    KEEP = "keep"
    TICON = "ticon"
    EMPTY = "empty"
    RED_DINO = "red-dino"


class PreprocessingConfig(BaseModel, arbitrary_types_allowed=True):
    model_config = ConfigDict(extra="forbid")

    output_dir: Path
    wsi_dir: Path
    wsi_list: Path | None = Field(
        default=None, description="Txt, Excel or CSV to read data filename from"
    )
    cache_dir: Path | None = None
    cache_tiles_ext: ImageExtension = "jpg"
    tile_size_um: Microns = Microns(256.0)
    tile_size_px: TilePixels = TilePixels(224)
    extractor: ExtractorName
    max_workers: int = 8
    device: str = "auto"
    generate_hash: bool = True

    default_slide_mpp: SlideMPP | None = None
    """MPP of the slide to use if none can be inferred from the WSI"""

    brightness_cutoff: int | None = Field(240, gt=0, lt=255)
    """Any tile brighter than this will be discarded as probable background.
    If set to `None`, the brightness-based background rejection is disabled."""

    canny_cutoff: float | None = Field(0.02, gt=0.0, lt=1.0)
    """Any tile with a lower ratio of pixels classified as "edges" than this
    will be rejected.  If set to `None`, texture-based rejection is disabled."""

    macenko_normalization: bool = False
    """Apply Macenko stain normalization to every tile before feature
    extraction (fused on-device kernel; STAMP-v1-era capability)."""

    extractor_precision: Literal["bfloat16", "int8"] = "bfloat16"
    """`int8` runs the ViT-family extractors as W8A8 (per-channel int8
    weights, activation scales calibrated on the first tile batch) — ~1.3×
    faster on TPU at a slight feature deviation from the bf16/fp16 parity
    path.  Output h5s carry a `precision` attr for provenance."""
