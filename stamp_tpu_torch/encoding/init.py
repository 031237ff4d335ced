"""Encoder dispatch, in PyTorch.

Counterpart of ``stamp_tpu/encoding/init.py:12-87``: every ``EncoderName``
(CHIEF, EAGLE, TITAN, COBRA, GigaPath, PRISM, MADELEINE) resolves to its
encoder, imported when it is asked for.
"""

from __future__ import annotations

from pathlib import Path

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder
from stamp_tpu_torch.types import PandasLabel


def _resolve(encoder: EncoderName | Encoder) -> Encoder:
    if isinstance(encoder, Encoder):
        return encoder
    match EncoderName(encoder):
        case EncoderName.CHIEF_CTRANSPATH:
            from stamp_tpu_torch.encoding.encoder.chief import CHIEF

            return CHIEF()
        case EncoderName.EAGLE:
            from stamp_tpu_torch.encoding.encoder.eagle import Eagle

            return Eagle()
        case EncoderName.TITAN:
            from stamp_tpu_torch.encoding.encoder.titan import Titan

            return Titan()
        case EncoderName.COBRA:
            from stamp_tpu_torch.encoding.encoder.cobra import Cobra

            return Cobra()
        case EncoderName.GIGAPATH:
            from stamp_tpu_torch.encoding.encoder.gigapath import Gigapath

            return Gigapath()
        case EncoderName.PRISM:
            from stamp_tpu_torch.encoding.encoder.prism import Prism

            return Prism()
        case EncoderName.MADELEINE:
            from stamp_tpu_torch.encoding.encoder.madeleine import Madeleine

            return Madeleine()
    raise ValueError(f"unknown encoder: {encoder}")


def init_slide_encoder_(
    encoder: EncoderName | Encoder,
    output_dir: Path,
    feat_dir: Path,
    device: str = "auto",
    agg_feat_dir: Path | None = None,
    generate_hash: bool = True,
) -> None:
    """Encode patch-level features to a single feature per slide."""
    _resolve(encoder).encode_slides_(
        output_dir=output_dir,
        feat_dir=feat_dir,
        device=device,
        agg_feat_dir=agg_feat_dir,
        generate_hash=generate_hash,
    )


def init_patient_encoder_(
    encoder: EncoderName | Encoder,
    output_dir: Path,
    feat_dir: Path,
    slide_table_path: Path,
    patient_label: PandasLabel,
    filename_label: PandasLabel,
    device: str = "auto",
    agg_feat_dir: Path | None = None,
    generate_hash: bool = True,
) -> None:
    """Encode patch-level features to a single feature per patient."""
    _resolve(encoder).encode_patients_(
        output_dir=output_dir,
        feat_dir=feat_dir,
        slide_table_path=slide_table_path,
        patient_label=patient_label,
        filename_label=filename_label,
        device=device,
        agg_feat_dir=agg_feat_dir,
        generate_hash=generate_hash,
    )
