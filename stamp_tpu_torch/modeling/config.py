"""Pydantic configs for train / crossval / deploy.

Copy of ``stamp_tpu/modeling/config.py``, kept in the port so that it
imports nothing of the JAX package; ``accelerator`` is resolved by
``stamp_tpu_torch.utils.device.resolve_device``.

Field-for-field parity with reference src/stamp/modeling/config.py so existing
YAML configs validate unchanged.
"""

import os
from collections.abc import Sequence
from pathlib import Path

from pydantic import BaseModel, ConfigDict, Field

from stamp_tpu_torch.modeling.registry import ModelName
from stamp_tpu_torch.types import Category, PandasLabel, Task

_DROP_PATIENTS_WITH_MISSING_GROUND_TRUTH_DESCRIPTION = (
    "If true, only patients present in the clinical table are included. "
    "Set to false to keep patients without ground truth when the task supports it."
)


def default_accelerator() -> str:
    """``$STAMP_ACCELERATOR`` or 'auto' (the CUDA card; resolved lazily)."""
    return os.environ.get("STAMP_ACCELERATOR", "auto")


class TrainConfig(BaseModel):
    model_config = ConfigDict(extra="forbid")
    task: Task | None = Field(default="classification")

    output_dir: Path = Field(description="The directory to save the results to")

    clini_table: Path = Field(description="Excel or CSV to read clinical data from")
    slide_table: Path | None = Field(
        default=None, description="Excel or CSV to read patient-slide associations from"
    )
    feature_dir: Path = Field(description="Directory containing feature files")

    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None = Field(
        default=None,
        description="Name of categorical column in clinical table to train on",
    )
    categories: Sequence[Category] | None = None

    status_label: PandasLabel | None = Field(
        default=None,
        description="Column in the clinical table indicating patient status "
        "(e.g. alive, dead, censored).",
    )
    time_label: PandasLabel | None = Field(
        default=None,
        description="Column in the clinical table indicating follow-up or "
        "survival time (e.g. days).",
    )
    drop_patients_with_missing_ground_truth: bool = Field(
        default=True,
        description=_DROP_PATIENTS_WITH_MISSING_GROUND_TRUTH_DESCRIPTION,
    )

    patient_label: PandasLabel = "PATIENT"
    filename_label: PandasLabel = "FILENAME"

    params_path: Path | None = Field(
        default=None,
        description="Optional: Path to a YAML file with advanced training parameters.",
    )

    # Experimental features
    use_vary_precision_transform: bool = False


class CrossvalConfig(TrainConfig):
    n_splits: int = Field(5, ge=2)
    task: Task | None = Field(default="classification")


class DeploymentConfig(BaseModel):
    model_config = ConfigDict(extra="forbid")

    output_dir: Path

    checkpoint_paths: list[Path]
    clini_table: Path | None = None
    slide_table: Path
    feature_dir: Path

    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None = None
    patient_label: PandasLabel = "PATIENT"
    filename_label: PandasLabel = "FILENAME"

    # For survival prediction
    status_label: PandasLabel | None = None
    time_label: PandasLabel | None = None
    drop_patients_with_missing_ground_truth: bool = Field(
        default=True,
        description=_DROP_PATIENTS_WITH_MISSING_GROUND_TRUTH_DESCRIPTION,
    )

    num_workers: int = min(os.cpu_count() or 1, 16)
    accelerator: str = Field(default_factory=default_accelerator)


class VitModelParams(BaseModel):
    model_config = ConfigDict(extra="forbid")
    dim_model: int = 512
    dim_feedforward: int = 512
    n_heads: int = 8
    n_layers: int = 2
    dropout: float = 0.0
    use_alibi: bool = False


class MlpModelParams(BaseModel):
    model_config = ConfigDict(extra="forbid")
    dim_hidden: int = 512
    num_layers: int = 2
    dropout: float = 0.25


class TransMILModelParams(BaseModel):
    model_config = ConfigDict(extra="forbid")
    dim_hidden: int = 512


class BarspoonParams(BaseModel):
    model_config = ConfigDict(extra="forbid")
    d_model: int = 512
    num_encoder_heads: int = 8
    num_decoder_heads: int = 8
    num_encoder_layers: int = 2
    num_decoder_layers: int = 2
    dim_feedforward: int = 2048
    positional_encoding: bool = True
    learning_rate: float = 1e-4


class LinearModelParams(BaseModel):
    model_config = ConfigDict(extra="forbid")
    num_encoder_heads: int = 8
    num_decoder_heads: int = 8
    num_encoder_layers: int = 2
    num_decoder_layers: int = 2
    dim_feedforward: int = 2048
    positional_encoding: bool = True
    learning_rate: float = 1e-4


class ModelParams(BaseModel):
    model_config = ConfigDict(extra="forbid")
    vit: VitModelParams = Field(default_factory=VitModelParams)
    trans_mil: TransMILModelParams = Field(default_factory=TransMILModelParams)
    mlp: MlpModelParams = Field(default_factory=MlpModelParams)
    linear: LinearModelParams = Field(default_factory=LinearModelParams)
    barspoon: BarspoonParams = Field(default_factory=BarspoonParams)


class AdvancedConfig(BaseModel):
    model_config = ConfigDict(extra="forbid")
    bag_size: int | None = Field(
        default=512,
        description="Tiles sampled per bag during training; null = train on "
        "whole slides (batch_size forced to 1, bags bucket-padded with "
        "masked attention; requires a mask-capable tile model such as vit).",
    )
    num_workers: int = min(os.cpu_count() or 1, 16)
    batch_size: int = 64
    max_epochs: int = 32
    patience: int = 16
    accelerator: str = Field(default_factory=default_accelerator)
    max_lr: float = 1e-4
    div_factor: float = 25.0
    model_name: ModelName | None = Field(
        default=None,
        description='Optional. "vit" or "mlp" are defaults based on feature type.',
    )
    model_params: ModelParams
    seed: int | None = None
    mesh_shape: dict[str, int] | None = Field(
        default=None,
        description="Mesh of ranks for sharded training, e.g. "
        '{"dp": 4, "sp": 2} on one host or {"dcn": 2, "dp": 2, "sp": 2} '
        "across hosts: dcn and dp split the batch's rows, sp each bag's "
        "tiles. A rank is one process on one device, so the axis product "
        "must equal the number of ranks (STAMP_NUM_PROCESSES in a fleet; a "
        "single process launches that many local ranks, one per card, or "
        "CPU ranks with accelerator: cpu — see parallel/distributed.py). "
        "null = single-device training, the reference's behavior.",
    )
