"""Task wrappers around the backbones.

Counterpart of ``stamp_tpu.modeling.tasks`` (``stamp_tpu/modeling/tasks.py:
36-554``): the tile-, slide- and patient-level classifier, regressor and
survival model and the multi-target ``LitEncDecTransformer`` (barspoon):
the hyper-parameter record a checkpoint stores, the version gate, the
module built from those hyper-parameters, whether it takes coordinates
(``uses_coords``, the module's ``supports_coords``), the per-task loss,
the learning-rate schedule and optimizer, and the validation metrics.

Loss semantics are the JAX package's, which are not PyTorch's defaults:
  * classification: −mean over the batch of Σ_c w_c·t_c·log p_c
    (``weighted_cross_entropy``), not ``F.cross_entropy(weight=…)``, which
    divides by the summed weights of the targets;
  * regression: L1;
  * survival: the Efron-tied Cox negative partial log-likelihood at tile
    level, the Breslow loss at slide and patient level (``ops/cox.py``),
    validated by Harrell's C-index and the Breslow loss;
  * multi-target: the sum over targets of each target's weighted cross
    entropy (a target missing for a patient is an all-zero row: no term).
The schedule is ``optax.cosine_onecycle_schedule`` (``cosine_onecycle_schedule``
here, value for value), whose step boundaries differ from
``torch.optim.lr_scheduler.OneCycleLR``; AdamW has optax's defaults and
decays every parameter.  ``LitEncDecTransformer`` trains with ``optax.adam``
at a constant ``learning_rate`` (``torch.optim.Adam``: no weight decay, ε
outside the square root).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from collections.abc import Callable, Iterable, Mapping, Sequence
from typing import Any, ClassVar

import numpy as np
import torch
from packaging.version import Version
from torch import nn

import stamp_tpu_torch
from stamp_tpu_torch.modeling.checkpoint import check_version_compatibility
from stamp_tpu_torch.ops.cox import cox_loss_breslow, neg_partial_log_likelihood


def weighted_cross_entropy(
    logits: torch.Tensor,  # [B, C]
    targets: torch.Tensor,  # [B, C] soft / one-hot
    weights: torch.Tensor | None,  # [C]
) -> torch.Tensor:
    """Mean over the batch of −Σ_c w_c·t_c·log p_c."""
    logp = torch.log_softmax(logits, dim=-1)
    if weights is not None:
        logp = logp * weights[None, :]
    return -torch.mean(torch.sum(targets * logp, dim=-1))


@functools.cache
def _cosf() -> Callable[[float], float]:
    """The C library's single-precision cosine, which XLA's f32 cosine on
    the CPU calls: numpy's and a rounded f64 cosine differ from it in the
    last bit for some arguments."""
    fn = ctypes.CDLL(ctypes.util.find_library("m")).cosf
    fn.argtypes = [ctypes.c_float]
    fn.restype = ctypes.c_float
    return fn


def cosine_onecycle_schedule(
    transition_steps: int,
    peak_value: float,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Callable[[int], float]:
    """``optax.cosine_onecycle_schedule``, value for value: a cosine rise
    from peak/div to peak over the first ``int(pct_start·T)`` steps, a
    cosine fall to peak/(div·final_div) at step T, constant after.  The
    arithmetic follows optax's types (f64 bounds and values, an f32 cosine
    and interpolation); at T = 1 the first segment is empty and, as in optax,
    every value is NaN."""
    if transition_steps <= 0:
        raise ValueError("A linear onecycle schedule was set with a non-positive `transition_steps`")
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor, 1.0 / (div_factor * final_div_factor)])
    sizes = bounds[1:] - bounds[:-1]
    half_span = ((values[:-1] - values[1:]) / 2.0).astype(np.float32)
    ends = values[1:].astype(np.float32)

    def schedule(count: int) -> float:
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (count - bounds[:-1]) / sizes
            cos = np.array([_cosf()(float(x)) for x in (np.pi * pct).astype(np.float32)], np.float32)
            interp = ends + half_span * (cos + np.float32(1.0))
        indicator = (bounds[:-1] <= count) & (count < bounds[1:])
        return float(indicator.dot(interp) + (bounds[-1] <= count) * values[-1])

    return schedule


def _filter_model_params(model_class, metadata: dict) -> dict:
    keys = getattr(model_class, "model_params_keys", lambda: [])()
    return {k: v for k, v in metadata.items() if k in keys}


class TaskModel:
    """Base wrapper: hparams record, version gate, the module, optimizer."""

    supported_features: ClassVar[list[str]] = []
    task_name: ClassVar[str] = ""
    #: (metric, "min" | "max") for early stopping and the best checkpoint
    monitor: ClassVar[tuple[str, str]] = ("validation_loss", "min")

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
        self.total_steps = int(total_steps)
        self.max_lr = float(max_lr)
        self.div_factor = float(div_factor)
        self.train_patients = list(train_patients)
        self.valid_patients = list(valid_patients)
        self.metadata = metadata
        self.hparams: dict[str, Any] = {
            "task": self.task_name,
            "supported_features": self.supported_features[0],
            "dim_input": int(dim_input),
            "total_steps": self.total_steps,
            "max_lr": self.max_lr,
            "div_factor": self.div_factor,
            "train_patients": self.train_patients,
            "valid_patients": self.valid_patients,
            "stamp_version": str(stamp_version),
            **metadata,
        }
        self.dim_input = int(dim_input)
        self.module: nn.Module = self._build_module()
        self.uses_coords = bool(getattr(self.module, "supports_coords", False))

    @property
    def dim_output(self) -> int:
        return 1

    @property
    def pads_bags(self) -> bool:
        """Whether whole tile bags are padded to their bucket and attended
        with a key mask (a tile-level backbone that takes one); others see
        a bag at its own length."""
        return self.supported_features[0] == "tile" and self.uses_coords

    def _build_module(self) -> nn.Module:
        params = _filter_model_params(self.model_class, self.metadata)
        return self.model_class(dim_input=self.dim_input, dim_output=self.dim_output, **params)

    def loss(self, outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def validation_metrics(self, outputs: list[np.ndarray], targets: list[np.ndarray]) -> dict[str, float]:
        raise NotImplementedError

    def lr_schedule(self) -> Callable[[int], float]:
        """The learning rate after ``count`` optimizer updates; the optimizer
        and the per-epoch ``learning_rate`` log both read it."""
        return cosine_onecycle_schedule(
            transition_steps=max(self.total_steps, 1),
            peak_value=self.max_lr,
            pct_start=0.3,
            div_factor=self.div_factor,
            final_div_factor=1e4,
        )

    def make_optimizer(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.AdamW:
        """AdamW as ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8, weight
        decay 1e-2 on every parameter).  The caller sets each step's learning
        rate from ``lr_schedule`` (optax applies ``schedule(count)``, count =
        updates done so far); it starts at 0 because the schedule can be NaN
        (T = 1), which ``AdamW`` refuses at construction."""
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-2)

    def checkpoint_hparams(self) -> dict[str, Any]:
        return dict(self.hparams, model_class=None)


class LitBaseClassifier(TaskModel):
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
        self.class_weights = category_weights
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

    def loss(self, outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return weighted_cross_entropy(outputs, targets, self._class_weights_on(outputs.device))

    def _class_weights_on(self, device: torch.device) -> torch.Tensor:
        """``class_weights`` as a tensor on ``device``, copied there once (again
        only when ``class_weights`` is replaced or the device changes): a copy
        from pageable host memory waits for all the work queued on the card,
        so one a step held the host until the step's forward was done."""
        cached = getattr(self, "_device_class_weights", None)
        if cached is None or cached[0] is not self.class_weights or cached[1].device != device:
            cached = self._device_class_weights = (self.class_weights, torch.from_numpy(self.class_weights).to(device))
        return cached[1]

    def validation_metrics(self, outputs, targets) -> dict[str, float]:
        from stamp_tpu_torch.statistics.metrics import roc_auc_score

        logits = np.concatenate(outputs)
        t = np.concatenate(targets)
        # per-patient CE, averaged: the epoch mean over batch-1 steps
        logp = logits - _np_logsumexp(logits)
        losses = -np.sum(t * logp * self.class_weights[None, :], axis=-1)
        metrics = {"validation_loss": float(np.mean(losses))}
        y_true = t.argmax(axis=-1)
        probs = np.exp(logp)
        if len(np.unique(y_true)) > 1:
            try:
                if probs.shape[1] == 2:
                    auroc = roc_auc_score(y_true, probs[:, 1])
                else:
                    auroc = roc_auc_score(y_true, probs, multi_class="ovr", average="macro")
            except ValueError:  # e.g. a class of the head missing from the validation set
                pass
            else:
                metrics["validation_auroc"] = float(auroc)
        return metrics


def _np_logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


class LitTileClassifier(LitBaseClassifier):
    supported_features = ["tile"]


class LitSlideClassifier(LitBaseClassifier):
    supported_features = ["slide"]


class LitPatientClassifier(LitSlideClassifier):
    supported_features = ["patient"]


class LitBaseRegressor(TaskModel):
    task_name = "regression"

    def __init__(self, *, model_class, dim_input: int, ground_truth_label=None, **kwargs: Any) -> None:
        self.ground_truth_label = ground_truth_label
        super().__init__(
            model_class=model_class,
            dim_input=dim_input,
            ground_truth_label=ground_truth_label,
            **kwargs,
        )

    def loss(self, outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return torch.mean(torch.abs(outputs - targets))

    def validation_metrics(self, outputs, targets) -> dict[str, float]:
        p = np.concatenate(outputs).reshape(-1)
        t = np.concatenate(targets).reshape(-1)
        return {"validation_loss": float(np.mean(np.abs(p - t)))}


class LitTileRegressor(LitBaseRegressor):
    supported_features = ["tile"]


class LitSlideRegressor(LitBaseRegressor):
    supported_features = ["slide"]


class LitPatientRegressor(LitSlideRegressor):
    supported_features = ["patient"]


class LitSurvivalBase(TaskModel):
    task_name = "survival"
    monitor = ("val_cindex", "max")

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

    def validation_metrics(self, outputs, targets) -> dict[str, float]:
        from stamp_tpu_torch.statistics.survival_util import concordance_index

        scores = np.concatenate(outputs).reshape(-1)
        y = np.concatenate(targets)
        times, events = y[:, 0], y[:, 1]
        valid = ~(np.isnan(times) | np.isnan(events) | np.isnan(scores))
        metrics: dict[str, float] = {}
        if valid.sum() > 1 and events[valid].sum() > 0:
            try:
                # higher risk = shorter survival: negate (reference models/__init__.py:686-694)
                metrics["val_cindex"] = concordance_index(times[valid], -scores[valid], events[valid].astype(int))
            except ZeroDivisionError:
                pass
            # Breslow validation loss (reference models/__init__.py:707-711)
            metrics["val_cox_loss"] = float(
                cox_loss_breslow(
                    torch.from_numpy(scores[valid]), torch.from_numpy(times[valid]), torch.from_numpy(events[valid])
                )
            )
        if "val_cindex" not in metrics:
            metrics["val_cindex"] = float("nan")
        return metrics


class LitTileSurvival(LitSurvivalBase):
    supported_features = ["tile"]

    def loss(self, outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return neg_partial_log_likelihood(outputs.reshape(-1), targets[:, 0], targets[:, 1])


class LitSlideSurvival(LitSurvivalBase):
    supported_features = ["slide"]

    def loss(self, outputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return cox_loss_breslow(outputs.reshape(-1), targets[:, 0], targets[:, 1])


class LitPatientSurvival(LitSlideSurvival):
    supported_features = ["patient"]


class LitEncDecTransformer(TaskModel):
    """Multi-target classification with barspoon (reference
    models/__init__.py:857-937, barspoon.py:208-348; ``stamp_tpu/modeling/
    tasks.py:419-536``): per-target categories and class weights, plain Adam
    at a constant ``learning_rate``, the loss summed over targets."""

    supported_features = ["tile"]
    task_name = "classification"

    def __init__(
        self,
        *,
        dim_input: int,
        category_weights: Mapping[str, Any],
        model_class=None,
        ground_truth_label=None,
        categories: Mapping[str, Sequence[str]],
        d_model: int = 512,
        num_encoder_heads: int = 8,
        num_decoder_heads: int = 8,
        num_encoder_layers: int = 2,
        num_decoder_layers: int = 2,
        dim_feedforward: int = 2048,
        positional_encoding: bool = True,
        learning_rate: float = 1e-4,
        **kwargs: Any,
    ) -> None:
        from stamp_tpu_torch.models.barspoon import EncDecTransformer

        if not isinstance(categories, Mapping):
            raise ValueError("Multi-target classification requires categories as Mapping[str, Sequence[str]].")
        self.weights = {k: np.asarray(v, dtype=np.float32) for k, v in category_weights.items()}
        normalized_categories = {str(k): list(v) for k, v in categories.items()}
        for t, w in self.weights.items():
            if t not in normalized_categories:
                raise ValueError(f"Missing categories for target '{t}'")
            if len(normalized_categories[t]) != len(w):
                raise ValueError(
                    f"Category mismatch for target '{t}': {len(normalized_categories[t])} categories "
                    f"but head has {len(w)} outputs."
                )
        self.categories = normalized_categories
        self.ground_truth_label = ground_truth_label
        self.learning_rate = learning_rate
        self._barspoon_params = dict(
            d_model=d_model,
            num_encoder_heads=num_encoder_heads,
            num_decoder_heads=num_decoder_heads,
            num_encoder_layers=num_encoder_layers,
            num_decoder_layers=num_decoder_layers,
            dim_feedforward=dim_feedforward,
            positional_encoding=positional_encoding,
        )
        super().__init__(
            model_class=model_class or EncDecTransformer,
            dim_input=dim_input,
            ground_truth_label=ground_truth_label,
            categories=normalized_categories,
            category_weights=dict(self.weights),
            learning_rate=learning_rate,
            **self._barspoon_params,
            **kwargs,
        )
        self.hparams["model_name"] = self.hparams.get("model_name", "barspoon")

    def _build_module(self) -> nn.Module:
        from stamp_tpu_torch.models.barspoon import EncDecTransformer

        return EncDecTransformer(
            dim_input=self.dim_input,
            target_n_outs=[(t, len(w)) for t, w in self.weights.items()],
            **self._barspoon_params,
        )

    def lr_schedule(self) -> Callable[[int], float]:
        return lambda count: self.learning_rate

    def make_optimizer(self, params: Iterable[torch.nn.Parameter]) -> torch.optim.Adam:
        """``optax.adam`` (reference barspoon.py:346-348): b1 0.9, b2 0.999,
        eps 1e-8, no weight decay."""
        return torch.optim.Adam(params, lr=self.learning_rate, betas=(0.9, 0.999), eps=1e-8)

    def loss(self, outputs: Mapping[str, torch.Tensor], targets: Mapping[str, torch.Tensor]) -> torch.Tensor:
        total = 0.0
        for target, weight in self.weights.items():
            w = torch.from_numpy(weight).to(outputs[target].device)
            total = total + weighted_cross_entropy(outputs[target], targets[target], w)
        return total

    def validation_metrics(self, outputs, targets) -> dict[str, float]:
        """The per-target weighted cross entropies, summed (outputs and
        targets: one dict of [1, C] arrays per patient)."""
        total_loss = 0.0
        for target, w in self.weights.items():
            logits = np.concatenate([np.asarray(out[target]) for out in outputs])
            t = np.concatenate([np.asarray(tgt[target]) for tgt in targets])
            logp = logits - _np_logsumexp(logits)
            total_loss += float(np.mean(-np.sum(t * logp * w[None, :], axis=-1)))
        return {"validation_loss": total_loss}


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
