"""Encoder dispatch, in PyTorch.

Counterpart of ``stamp_tpu/encoding/init.py:12-87``.  Only TITAN is ported;
every other encoder raises ``NotImplementedError`` naming the JAX package's
command.
"""

from __future__ import annotations

from pathlib import Path

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder
from stamp_tpu_torch.types import PandasLabel


def _resolve(encoder: EncoderName | Encoder, command: str) -> Encoder:
    if isinstance(encoder, Encoder):
        return encoder
    name = EncoderName(encoder)
    if name == EncoderName.TITAN:
        from stamp_tpu_torch.encoding.encoder.titan import Titan

        return Titan()
    raise NotImplementedError(
        f"encoder {name.value!r} is not ported to stamp_tpu_torch yet (only 'titan' is); "
        f"run `python -m stamp_tpu {command}`"
    )


def init_slide_encoder_(
    encoder: EncoderName | Encoder,
    output_dir: Path,
    feat_dir: Path,
    device: str = "auto",
    agg_feat_dir: Path | None = None,
    generate_hash: bool = True,
) -> None:
    """Encode patch-level features to a single feature per slide."""
    _resolve(encoder, "encode_slides").encode_slides_(
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
    _resolve(encoder, "encode_patients").encode_patients_(
        output_dir=output_dir,
        feat_dir=feat_dir,
        slide_table_path=slide_table_path,
        patient_label=patient_label,
        filename_label=filename_label,
        device=device,
        agg_feat_dir=agg_feat_dir,
        generate_hash=generate_hash,
    )
