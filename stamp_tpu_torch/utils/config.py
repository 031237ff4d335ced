"""Root configuration tree.

Copy of ``stamp_tpu/utils/config.py``, kept in the port so that it imports
nothing of the JAX package.

One ``StampConfig`` holds an optional section per CLI command (reference
utils/config.py:15-32); ``extra="forbid"`` everywhere means a typo'd YAML
key fails loudly with the offending name instead of being ignored.  Only
the section of the command actually being run needs to be present.
"""

import pydantic

from stamp_tpu_torch.encoding import config as encoding_cfg
from stamp_tpu_torch.heatmaps import config as heatmaps_cfg
from stamp_tpu_torch.modeling import config as modeling_cfg
from stamp_tpu_torch.preprocessing import config as preprocessing_cfg
from stamp_tpu_torch.statistics import StatsConfig


class StampConfig(pydantic.BaseModel):
    model_config = pydantic.ConfigDict(extra="forbid")

    preprocessing: preprocessing_cfg.PreprocessingConfig | None = None
    """`stamp preprocess` — tiling + tile feature extraction."""

    training: modeling_cfg.TrainConfig | None = None
    """`stamp train` — single train/val split."""

    crossval: modeling_cfg.CrossvalConfig | None = None
    """`stamp crossval` — k-fold with resumable splits.json."""

    deployment: modeling_cfg.DeploymentConfig | None = None
    """`stamp deploy` — (ensemble) inference on an external cohort."""

    statistics: StatsConfig | None = None
    """`stamp statistics` — metrics + plots over prediction CSVs."""

    heatmaps: heatmaps_cfg.HeatmapConfig | None = None
    """`stamp heatmaps` — Grad-CAM maps and ranked tile export."""

    slide_encoding: encoding_cfg.SlideEncodingConfig | None = None
    """`stamp encode_slides` — one pooled embedding per slide."""

    patient_encoding: encoding_cfg.PatientEncodingConfig | None = None
    """`stamp encode_patients` — one pooled embedding per patient."""

    advanced_config: modeling_cfg.AdvancedConfig | None = None
    """Training hyper-parameters shared by train/crossval (defaulted when
    absent)."""
