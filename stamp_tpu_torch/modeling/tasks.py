"""Task wrappers around the backbones, forward side.

Counterpart of the forward half of ``stamp_tpu.modeling.tasks``
(``stamp_tpu/modeling/tasks.py:54-190``, ``:538-554``): the wrapper owns the
hyper-parameter record a checkpoint stores, the version gate, the module it
builds from those hyper-parameters and the output width of each task.  The
tile-level classifier, regressor and survival wrappers are ported; losses,
optimizers, validation metrics and the Cox losses wait for the training
slice, and the slide/patient-level and multi-target wrappers raise.
"""

from __future__ import annotations

from collections.abc import Sequence
from typing import Any, ClassVar

import numpy as np
from packaging.version import Version
from torch import nn

import stamp_tpu_torch
from stamp_tpu_torch.modeling.checkpoint import check_version_compatibility


def _filter_model_params(model_class, metadata: dict) -> dict:
    keys = getattr(model_class, "model_params_keys", lambda: [])()
    return {k: v for k, v in metadata.items() if k in keys}


class TaskModel:
    """Base wrapper: hparams record, version gate, the module."""

    supported_features: ClassVar[list[str]] = []
    task_name: ClassVar[str] = ""

    def __init__(
        self,
        *,
        model_class,
        dim_input: int,
        total_steps: int = 512,
        max_lr: float = 1e-4,
        div_factor: float = 25.0,
        train_patients: Sequence[str] = (),
        valid_patients: Sequence[str] = (),
        stamp_version: str | Version | None = None,
        **metadata: Any,
    ) -> None:
        stamp_version = stamp_version or stamp_tpu_torch.__version__
        check_version_compatibility(stamp_version)

        self.model_class = model_class
        self.train_patients = list(train_patients)
        self.valid_patients = list(valid_patients)
        self.metadata = metadata
        # the training fields are kept so that a checkpoint the port writes
        # carries the record the JAX package writes
        self.hparams: dict[str, Any] = {
            "task": self.task_name,
            "supported_features": self.supported_features[0],
            "dim_input": int(dim_input),
            "total_steps": int(total_steps),
            "max_lr": float(max_lr),
            "div_factor": float(div_factor),
            "train_patients": self.train_patients,
            "valid_patients": self.valid_patients,
            "stamp_version": str(stamp_version),
            **metadata,
        }
        self.dim_input = int(dim_input)
        self.module: nn.Module = self._build_module()

    @property
    def dim_output(self) -> int:
        return 1

    def _build_module(self) -> nn.Module:
        params = _filter_model_params(self.model_class, self.metadata)
        return self.model_class(dim_input=self.dim_input, dim_output=self.dim_output, **params)

    def checkpoint_hparams(self) -> dict[str, Any]:
        return dict(self.hparams, model_class=None)


class LitTileClassifier(TaskModel):
    supported_features = ["tile"]
    task_name = "classification"

    def __init__(
        self,
        *,
        model_class,
        ground_truth_label,
        categories: Sequence[str],
        category_weights,
        dim_input: int,
        **kwargs: Any,
    ) -> None:
        categories = list(categories)
        category_weights = np.asarray(category_weights, dtype=np.float32)
        if len(categories) != len(category_weights):
            raise ValueError("the number of category weights has to match the number of categories!")
        self.categories = categories
        self.ground_truth_label = ground_truth_label
        self._n_outputs = len(categories)
        super().__init__(
            model_class=model_class,
            dim_input=dim_input,
            ground_truth_label=ground_truth_label,
            categories=categories,
            category_weights=category_weights,
            **kwargs,
        )

    @property
    def dim_output(self) -> int:
        return self._n_outputs


class LitTileRegressor(TaskModel):
    supported_features = ["tile"]
    task_name = "regression"

    def __init__(self, *, model_class, dim_input: int, ground_truth_label=None, **kwargs: Any) -> None:
        self.ground_truth_label = ground_truth_label
        super().__init__(
            model_class=model_class,
            dim_input=dim_input,
            ground_truth_label=ground_truth_label,
            **kwargs,
        )


class LitTileSurvival(TaskModel):
    supported_features = ["tile"]
    task_name = "survival"

    def __init__(
        self,
        *,
        model_class,
        dim_input: int,
        time_label: str,
        status_label: str,
        **kwargs: Any,
    ) -> None:
        self.time_label = time_label
        self.status_label = status_label
        self.train_pred_median: float | None = kwargs.pop("train_pred_median", None)
        super().__init__(
            model_class=model_class,
            dim_input=dim_input,
            time_label=time_label,
            status_label=status_label,
            **kwargs,
        )
        if self.train_pred_median is not None:
            self.hparams["train_pred_median"] = self.train_pred_median


def instantiate_from_hparams(hparams: dict[str, Any]) -> TaskModel:
    """Re-create a task wrapper from checkpoint hyper-parameters
    (reference deploy.py:49-58)."""
    from stamp_tpu_torch.modeling.registry import ModelName, load_model_class

    model_name = ModelName(hparams["model_name"])
    lit_class, model_class = load_model_class(hparams["task"], hparams["supported_features"], model_name)
    kwargs = {
        k: v
        for k, v in hparams.items()
        if k not in ("task", "supported_features", "model_name", "model_class")
    }
    tm = lit_class(model_class=model_class, **kwargs)
    tm.hparams["model_name"] = str(model_name)
    return tm
