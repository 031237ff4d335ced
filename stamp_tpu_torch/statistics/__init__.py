"""The ``statistics`` section of the config schema.

Copy of ``StatsConfig`` from ``stamp_tpu/statistics/__init__.py``, field for
field, so that ``StampConfig`` validates the same YAML without importing the
JAX package.  The ``statistics`` command itself is not ported yet.
"""

from __future__ import annotations

from collections.abc import Sequence
from pathlib import Path

from pydantic import BaseModel, ConfigDict, Field

from stamp_tpu_torch.types import PandasLabel, Task

__all__ = ["StatsConfig"]


class StatsConfig(BaseModel):
    model_config = ConfigDict(extra="ignore")
    task: Task = Field(default="classification")
    output_dir: Path
    pred_csvs: list[Path]
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None = None
    true_class: str | None = None
    time_label: str | None = None
    status_label: str | None = None
