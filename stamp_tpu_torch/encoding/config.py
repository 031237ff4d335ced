"""Encoding configs (parity with reference encoding/config.py).

Copy of ``stamp_tpu/encoding/config.py``, kept in the port so that it
imports nothing of the JAX package.
"""

from enum import StrEnum
from pathlib import Path

from pydantic import BaseModel, ConfigDict

from stamp_tpu_torch.types import PandasLabel


class EncoderName(StrEnum):
    COBRA = "cobra"
    EAGLE = "eagle"
    CHIEF_CTRANSPATH = "chief"
    TITAN = "titan"
    GIGAPATH = "gigapath"
    MADELEINE = "madeleine"
    PRISM = "prism"


class SlideEncodingConfig(BaseModel, arbitrary_types_allowed=True):
    model_config = ConfigDict(extra="forbid")

    encoder: EncoderName
    output_dir: Path
    feat_dir: Path
    device: str = "auto"
    agg_feat_dir: Path | None = None
    generate_hash: bool = True


class PatientEncodingConfig(BaseModel, arbitrary_types_allowed=True):
    model_config = ConfigDict(extra="forbid")

    encoder: EncoderName
    output_dir: Path
    feat_dir: Path
    slide_table: Path
    patient_label: PandasLabel = "PATIENT"
    filename_label: PandasLabel = "FILENAME"
    device: str = "auto"
    agg_feat_dir: Path | None = None
    generate_hash: bool = True
