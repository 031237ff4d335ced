"""Training: the ``stamp train`` workflow and the single-device engine.

Counterpart of ``stamp_tpu/modeling/train.py:61-978`` (its single-device
path) for every backbone (``vit``, ``trans_mil``, ``mlp``, ``linear``,
``barspoon``) on tile-, slide- and patient-level features, single- and
multi-target: the stratified 75/25 split (``modeling.splits.
train_test_split``, scikit-learn's indices without scikit-learn; a
multi-target cohort stratifies on its first target), class weights with the
under-population warning (per target for multi-target), default model
selection (``vit`` for tiles, ``mlp`` otherwise), the task's optimizer
(AdamW with the one-cycle cosine schedule; barspoon's constant-rate Adam),
early stopping and save_top_k=1 on the task's monitor (``val_cindex``↑ for
survival, ``validation_loss``↓ otherwise), the ``lightning_logs/version_0/
metrics.csv`` log with the JAX package's columns, ``checkpoint-final.ckpt``
when no epoch improved, and the best checkpoint copied to ``model.ckpt``.

The engine runs on an explicit ``torch.device``.  Coordinates and key
masks go to a backbone only where it takes them (``uses_coords``: ``vit``
and ``barspoon``).  ``bag_size: null`` trains on whole slides (such
backbones only): each bag is padded to a power of two of at least 512 tiles
and attended with a key mask, so ``vit`` bags of 4,096 tiles and more reach
the flash kernels and their backward.  Validation runs whole bags under
``torch.inference_mode()``, bucket-padded the same way for those backbones
and at their own length otherwise; slide and patient batches are one vector
a patient.  Training batches reach the device through
``parallel.prefetch.prefetch_to_device`` (a producer thread, pinned memory
and a side stream), as the JAX package's single-device path feeds them
(``stamp_tpu/modeling/train.py:837``).  The random draws (split, epoch
order, bag seeds, the initial batch the JAX package reads for its
initialisation) follow the JAX package's order from ``Seed.numpy_rng()``;
initial weights come from ``Seed.torch_generator()`` and differ from
flax's.

``mesh_shape`` (``advanced_config.mesh_shape``, axes ``dcn``, ``dp`` and
``sp``) trains over a mesh of ranks, with the JAX package's semantics
(``stamp_tpu/modeling/train.py:593-884``): every rank draws the same global
batch (a fixed ``advanced.seed`` is required with several ranks), a batch
whose rows do not divide by the data-parallel axes (``dcn`` × ``dp``) is
padded by cycling its own rows (those rows count twice in that batch's
loss, as in the JAX package), whole-slide bags are bucket-padded before
they are split, each rank runs its contiguous rows and, with ``sp``, its
contiguous share of their tiles (a tile bag whose length does not divide
by ``sp`` raises, with the JAX package's message; the power-of-two
whole-slide buckets divide; slide and patient vectors are the same on the
ranks of a sequence group, as the JAX package replicates them over
``sp``), and ``parallel.mesh.make_dp_train_step`` takes the gradient of the
loss over the global batch (the ALiBi statistic, dropout masks and the
survival median are the global batch's too).  Validation runs whole on
every rank, and rank 0's monitored value decides early stopping for all,
so they stay in lockstep; only rank 0 writes ``metrics.csv`` and the
checkpoints, and the others wait at a barrier.  A single process given a
mesh of one rank joins a process group of its own.
"""

from __future__ import annotations

import csv
import logging
import math
import shutil
from collections.abc import Callable, Iterator, Mapping, Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch

from stamp_tpu_torch.modeling.checkpoint import save_checkpoint
from stamp_tpu_torch.modeling.config import AdvancedConfig, TrainConfig
from stamp_tpu_torch.modeling.data import (
    BagDataset,
    BatchIterator,
    PatientData,
    _parse_survival_status,
    create_dataset,
    load_patient_data_,
)
from stamp_tpu_torch.modeling.registry import ModelName, load_model_class
from stamp_tpu_torch.modeling.splits import train_test_split
from stamp_tpu_torch.modeling.tasks import TaskModel
from stamp_tpu_torch.modeling.transforms import VaryPrecisionTransform
from stamp_tpu_torch.models import weights
from stamp_tpu_torch.parallel import distributed
from stamp_tpu_torch.parallel._fleet_launch import free_port
from stamp_tpu_torch.parallel.distributed import Mesh
from stamp_tpu_torch.parallel.mesh import make_dp_train_step, pad_rows, shard_batch
from stamp_tpu_torch.parallel.prefetch import prefetch_to_device
from stamp_tpu_torch.types import Category, PandasLabel, PatientId, Task
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.seed import Seed

_logger = logging.getLogger("stamp")


def train_categorical_model_(*, config: TrainConfig, advanced: AdvancedConfig, device: torch.device) -> None:
    """``stamp train`` (reference train.py:45-99)."""
    if config.task is None:
        raise ValueError("task must be set to 'classification' | 'regression' | 'survival'")

    patient_to_data, feature_type = load_patient_data_(
        feature_dir=config.feature_dir,
        clini_table=config.clini_table,
        slide_table=config.slide_table,
        task=config.task,
        ground_truth_label=config.ground_truth_label,
        time_label=config.time_label,
        status_label=config.status_label,
        patient_label=config.patient_label,
        filename_label=config.filename_label,
        drop_patients_with_missing_ground_truth=config.drop_patients_with_missing_ground_truth,
    )
    _logger.info(f"Detected feature type: {feature_type}")

    model, train_dl, valid_dl = setup_model_for_training(
        patient_to_data=patient_to_data,
        categories=config.categories,
        task=config.task,
        advanced=advanced,
        ground_truth_label=config.ground_truth_label,
        time_label=config.time_label,
        status_label=config.status_label,
        clini_table=config.clini_table,
        slide_table=config.slide_table,
        feature_dir=config.feature_dir,
        train_transform=(
            VaryPrecisionTransform(min_fraction_bits=1) if config.use_vary_precision_transform else None
        ),
        feature_type=feature_type,
    )
    train_model_(
        output_dir=config.output_dir,
        model=model,
        train_dl=train_dl,
        valid_dl=valid_dl,
        max_epochs=advanced.max_epochs,
        patience=advanced.patience,
        device=device,
        pad_train_buckets=advanced.bag_size is None,
        mesh_shape=advanced.mesh_shape,
    )


# ---------------------------------------------------------------------------
# Setup (reference train.py:102-501)
# ---------------------------------------------------------------------------


def _stratification(task: Task, ground_truths: list) -> list | None:
    """What the split stratifies on: the class (a multi-target cohort's
    first target), the survival status, or nothing (regression)."""
    if task == "classification":
        if ground_truths and isinstance(ground_truths[0], dict):
            first = next(iter(ground_truths[0]))
            return [gt[first] for gt in ground_truths]
        return ground_truths
    if task != "survival":
        return None
    statuses: list[int] = []
    for gt in ground_truths:
        if isinstance(gt, (tuple, list)) and len(gt) == 2:
            if gt[1] is None:
                raise ValueError("Missing survival status for a patient; cannot stratify")
            statuses.append(int(gt[1]))
        else:
            parts = str(gt).split()
            statuses.append(int(_parse_survival_status(parts[1] if len(parts) >= 2 else parts[0])))
    return statuses


def setup_dataloaders_for_training(
    *,
    patient_to_data: Mapping[PatientId, PatientData],
    task: Task,
    categories: Sequence[Category] | None,
    bag_size: int | None,
    batch_size: int,
    num_workers: int,
    train_transform: Callable | None,
    feature_type: str,
) -> tuple[BatchIterator, BatchIterator, Sequence[Category], int, Sequence[PatientId], Sequence[PatientId]]:
    """Stratified split + train/valid iterators (reference train.py:354-501)."""
    ground_truths = [p.ground_truth for p in patient_to_data.values() if p.ground_truth is not None]
    _logger.info(f"Task: {feature_type} {task}")
    if len(ground_truths) != len(patient_to_data):
        raise ValueError("patient_to_data must have a ground truth defined for all targets!")
    if task != "classification" and any(isinstance(gt, dict) for gt in ground_truths):
        raise ValueError("Multi-target ground truths are only supported for classification tasks")

    train_patients, valid_patients = train_test_split(
        list(patient_to_data), stratify=_stratification(task, ground_truths), shuffle=True, random_state=0
    )
    train_ds, train_categories = create_dataset(
        feature_type=feature_type,
        task=task,
        patient_data=[patient_to_data[pid] for pid in train_patients],
        bag_size=bag_size,
        shuffle=True,
        transform=train_transform,
        categories=categories,
    )
    valid_ds, _ = create_dataset(
        feature_type=feature_type,
        task=task,
        patient_data=[patient_to_data[pid] for pid in valid_patients],
        bag_size=None,
        shuffle=False,
        categories=train_categories,
    )
    if bag_size is None:
        # whole-slide training: bags are ragged, so one slide per step; the
        # engine bucket-pads and masks
        if batch_size != 1:
            _logger.info("bag_size is null (whole-slide training): forcing batch_size=1")
        batch_size = 1
    train_dl = BatchIterator(train_ds, batch_size=batch_size, shuffle=True, num_workers=num_workers)
    valid_dl = BatchIterator(valid_ds, batch_size=1, shuffle=False, num_workers=num_workers)
    dim_feats = int(train_ds[0][0].shape[-1])
    return train_dl, valid_dl, train_categories, dim_feats, train_patients, valid_patients


def _compute_class_weights_and_check_categories(
    *, train_dl: BatchIterator, train_categories: Sequence[str] | Mapping[str, Sequence[str]]
) -> np.ndarray | dict[str, np.ndarray]:
    """Inverse-frequency class weights, normalised to sum to 1 (reference
    train.py:567-621); per target for multi-target bags."""
    ground_truths = train_dl.dataset.ground_truths
    if isinstance(train_dl.dataset, BagDataset) and isinstance(ground_truths, list):
        weights_per_target: dict[str, np.ndarray] = {}
        for key in ground_truths[0]:
            counts = np.stack([gt[key] for gt in ground_truths]).sum(axis=0)
            w = counts.sum() / np.maximum(counts, 1e-12)
            weights_per_target[key] = (w / w.sum()).astype(np.float32)
        return weights_per_target
    category_counts = np.asarray(ground_truths).sum(axis=0)
    cat_ratio_reciprocal = category_counts.sum() / category_counts
    category_weights = cat_ratio_reciprocal / cat_ratio_reciprocal.sum()
    if len(train_categories) <= 1:
        raise ValueError(f"not enough categories to train on: {train_categories}")
    elif (category_counts < 16).any():
        underpopulated = {
            category: int(count)
            for category, count in zip(train_categories, category_counts.tolist(), strict=True)
            if count < 16
        }
        _logger.warning(
            "Some categories do not have enough samples to meaningfully train "
            f"a model: {underpopulated}. You may want to consider removing these "
            "categories; the model will likely overfit on the few samples available."
        )
    return category_weights.astype(np.float32)


def _resolve_model_and_params(
    *, task: Task, feature_type: str, advanced: AdvancedConfig, ground_truth_label
) -> tuple[type, Any, dict]:
    """Model defaulting and validation (reference train.py:153-194): ``vit``
    for tiles, ``mlp`` otherwise; barspoon needs several targets; slide and
    patient features take ``mlp`` or ``linear``."""
    if advanced.model_name is None:
        advanced.model_name = ModelName.VIT if feature_type == "tile" else ModelName.MLP
        _logger.info(
            f"No model specified, defaulting to '{advanced.model_name.value}' for feature type '{feature_type}'"
        )
    if task == "classification" and isinstance(ground_truth_label, str) and advanced.model_name == ModelName.BARSPOON:
        raise ValueError(
            "Model 'barspoon' requires multi-target classification. For single-target classification "
            "set model_name to 'vit', 'trans_mil', or 'mlp'."
        )
    lit_class, model_class = load_model_class(task, feature_type, advanced.model_name)
    if feature_type not in lit_class.supported_features:
        raise ValueError(
            f"Model '{advanced.model_name.value}' does not support feature type '{feature_type}'. "
            f"Supported types are: {lit_class.supported_features}"
        )
    if feature_type in ("slide", "patient") and advanced.model_name.value.lower() not in {"mlp", "linear"}:
        raise ValueError(
            f"Feature type '{feature_type}' only supports MLP or Linear. "
            f"Got '{advanced.model_name.value}'. Please set model_name='mlp' or 'linear'."
        )
    model_specific_params = advanced.model_params.model_dump().get(advanced.model_name.value) or {}
    return lit_class, model_class, model_specific_params


def setup_model_from_dataloaders(
    *,
    train_dl: BatchIterator,
    task: Task,
    train_categories: Sequence[Category] | Mapping[str, Sequence[Category]],
    dim_feats: int,
    train_patients: Sequence[PatientId],
    valid_patients: Sequence[PatientId],
    feature_type: str,
    advanced: AdvancedConfig,
    ground_truth_label,
    time_label: PandasLabel | None,
    status_label: PandasLabel | None,
    clini_table: Path,
    slide_table: Path | None,
    feature_dir: Path,
) -> TaskModel:
    """The task wrapper with the JAX package's hyper-parameter record
    (reference train.py:236-351)."""
    category_weights: Any = []
    if task == "classification":
        category_weights = _compute_class_weights_and_check_categories(
            train_dl=train_dl, train_categories=train_categories
        )
    lit_class, model_class, model_specific_params = _resolve_model_and_params(
        task=task, feature_type=feature_type, advanced=advanced, ground_truth_label=ground_truth_label
    )
    assert advanced.model_name is not None  # set by _resolve_model_and_params
    common_params = {
        "categories": train_categories,
        "category_weights": category_weights,
        "dim_input": dim_feats,
        "total_steps": len(train_dl) * advanced.max_epochs,
        "max_lr": advanced.max_lr,
        "div_factor": advanced.div_factor,
        "model_name": advanced.model_name.value,
        "ground_truth_label": ground_truth_label,
        "time_label": time_label,
        "status_label": status_label,
        "train_patients": list(train_patients),
        "valid_patients": list(valid_patients),
        "clini_table": str(clini_table),
        "slide_table": str(slide_table) if slide_table is not None else None,
        "feature_dir": str(feature_dir),
    }
    if task != "classification":
        common_params.pop("categories")
        common_params.pop("category_weights")
    if task != "survival":
        common_params.pop("time_label")
        common_params.pop("status_label")
    _logger.info(
        f"Instantiating model '{advanced.model_name.value}' with parameters: {model_specific_params}"
    )
    return lit_class(model_class=model_class, **common_params, **model_specific_params)


def setup_model_for_training(
    *,
    patient_to_data: Mapping[PatientId, PatientData],
    task: Task,
    categories: Sequence[Category] | None,
    train_transform: Callable | None,
    feature_type: str,
    advanced: AdvancedConfig,
    ground_truth_label,
    time_label: PandasLabel | None,
    status_label: PandasLabel | None,
    clini_table: Path,
    slide_table: Path | None,
    feature_dir: Path,
) -> tuple[TaskModel, BatchIterator, BatchIterator]:
    """Reference train.py:102-233."""
    train_dl, valid_dl, train_categories, dim_feats, train_patients, valid_patients = (
        setup_dataloaders_for_training(
            patient_to_data=patient_to_data,
            task=task,
            categories=categories,
            bag_size=advanced.bag_size,
            batch_size=advanced.batch_size,
            num_workers=advanced.num_workers,
            train_transform=train_transform,
            feature_type=feature_type,
        )
    )
    model = setup_model_from_dataloaders(
        train_dl=train_dl,
        task=task,
        train_categories=train_categories,
        dim_feats=dim_feats,
        train_patients=train_patients,
        valid_patients=valid_patients,
        feature_type=feature_type,
        advanced=advanced,
        ground_truth_label=ground_truth_label,
        time_label=time_label,
        status_label=status_label,
        clini_table=clini_table,
        slide_table=slide_table,
        feature_dir=feature_dir,
    )
    return model, train_dl, valid_dl


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _bucket_size(n: int, *, minimum: int = 512) -> int:
    """Next power of two ≥ n (≥ minimum): the JAX package's bucket, kept so
    that the same bags reach the flash kernels at the same lengths."""
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


def _pad_tile_batch(batch, bucket: int):
    """Pad a tile batch's tile dimension to ``bucket``: (batch, key_mask)."""
    bags, coords, sizes, targets = batch
    b, t, f = bags.shape
    if t < bucket:
        bags = np.concatenate([bags, np.zeros((b, bucket - t, f), dtype=bags.dtype)], axis=1)
        coords = np.concatenate([coords, np.zeros((b, bucket - t, 2), dtype=coords.dtype)], axis=1)
    key_mask = np.arange(bucket)[None, :] < np.asarray(sizes)[:, None]
    return (bags, coords, sizes, targets), key_mask


class _EpochLogger:
    """CSV metrics log in Lightning's CSVLogger layout
    (``lightning_logs/version_0/metrics.csv``), rewritten every epoch."""

    def __init__(self, output_dir: Path) -> None:
        self.log_dir = output_dir / "lightning_logs" / "version_0"
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.path = self.log_dir / "metrics.csv"
        self.rows: list[dict] = []
        self.keys: list[str] = []

    def log(self, row: dict) -> None:
        self.rows.append(row)
        for k in row:
            if k not in self.keys:
                self.keys.append(k)
        with open(self.path, "w", newline="") as fp:
            writer = csv.DictWriter(fp, fieldnames=self.keys)
            writer.writeheader()
            for r in self.rows:
                writer.writerow(r)


def _to_device(array: np.ndarray | torch.Tensor, device: torch.device) -> torch.Tensor:
    """A host batch array on ``device``, through pinned memory for a card
    (a tensor, e.g. from the prefetching feed, is moved as it is)."""
    if isinstance(array, torch.Tensor):
        return array.to(device)
    tensor = torch.from_numpy(np.ascontiguousarray(array))
    if device.type == "cuda":
        return tensor.pin_memory().to(device, non_blocking=True)
    return tensor.to(device)


def forward_batch(model: TaskModel, batch: tuple, key_mask: np.ndarray | None, device: torch.device, **kwargs):
    """The backbone on one host batch: a tile batch's bags, with its
    coordinates and ``key_mask`` where the backbone takes them
    (``uses_coords``), or a slide/patient batch's vectors.  ``kwargs`` go
    to the module (``train``, ``generator``).  A training tile batch
    counts ``train/tiles`` (its valid tiles, from ``sizes`` where it lies
    in host memory: no count reads the device) and ``train/rows`` (the
    B·T rows handed to the backbone, padding included)."""
    if len(batch) == 4:
        bags, coords, sizes, _targets = batch
        if kwargs.get("train") and profiling.recording():
            if not (isinstance(sizes, torch.Tensor) and sizes.device.type != "cpu"):
                profiling.count("train/tiles", int(np.sum(np.asarray(sizes))))
            profiling.count("train/rows", bags.shape[0] * bags.shape[1])
        if model.uses_coords:
            kwargs.update(
                coords=_to_device(coords, device),
                key_mask=None if key_mask is None else _to_device(key_mask, device),
            )
        return model.module(_to_device(bags, device), **kwargs)
    return model.module(_to_device(batch[0], device), **kwargs)


def host_outputs(out) -> np.ndarray | dict[str, np.ndarray]:
    """f32 numpy copies of a forward's output (per target for multi-target)."""
    if isinstance(out, dict):
        return {k: v.float().cpu().numpy() for k, v in out.items()}
    return out.float().cpu().numpy()


def _init_module(model: TaskModel) -> None:
    """Initial weights from the global seed (flax's initializers'
    distributions; the values differ from the JAX package's)."""
    weights.init_weights_(model.module, Seed.torch_generator())


def _bucketed(batches) -> Iterator:
    """Whole-slide bags padded to power-of-two buckets, with key masks."""
    for batch in batches:
        yield _pad_tile_batch(batch, _bucket_size(batch[0].shape[1]))


def train_model_(
    *,
    output_dir: Path,
    model: TaskModel,
    train_dl: BatchIterator,
    valid_dl: BatchIterator,
    max_epochs: int,
    patience: int,
    device: torch.device,
    pad_train_buckets: bool = False,
    mesh_shape: Mapping[str, int] | None = None,
) -> tuple[TaskModel, Any]:
    """Train ``model`` on ``device``; the best checkpoint goes to
    ``output_dir/model.ckpt``.  Returns (task model, best variable tree).

    ``pad_train_buckets`` is whole-slide training (``bag_size: null``):
    each ragged bag is padded to a power-of-two bucket and attended with a
    key mask.  ``mesh_shape`` trains data-parallel over a mesh of ranks
    (``{"dp": …}``, ``{"dcn": …, "dp": …}``, ``{"dp": …, "sp": …}``; the
    product must equal the fleet's rank count), ``device`` being this
    rank's."""
    mesh = None
    own_group = bool(mesh_shape) and not torch.distributed.is_initialized() and math.prod(mesh_shape.values()) == 1
    if own_group:  # one rank: a process group of its own
        distributed.init_distributed(
            coordinator_address=f"localhost:{free_port()}", num_processes=1, process_id=0,
            use_cuda=device.type == "cuda",
        )  # fmt: skip
    try:
        if mesh_shape:
            if distributed.process_count() > 1 and Seed.seed is None:
                raise ValueError(
                    "multi-process sharded training needs a fixed advanced.seed so every rank draws identical batches"
                )
            mesh = distributed.make_global_mesh(mesh_shape)
            _logger.info(
                f"sharded training on mesh {mesh.shape} ({distributed.process_count()} rank(s), "
                f"backend {distributed.backend()})"
            )
        return _train_model_impl(
            output_dir=Path(output_dir), model=model, train_dl=train_dl, valid_dl=valid_dl, max_epochs=max_epochs,
            patience=patience, device=device, pad_train_buckets=pad_train_buckets, mesh=mesh,
        )  # fmt: skip
    finally:
        if own_group:
            distributed.shutdown_distributed()


def _sp_axis(mesh: Mesh | None) -> str | None:
    return "sp" if mesh is not None and "sp" in mesh.axis_names else None


def _mesh_feed(batches: Iterator, mesh: Mesh) -> Iterator:
    """This rank's part of each global (batch, key_mask), its targets
    whole: a ragged batch first padded to a multiple of the data-parallel
    axes by cycling its rows; a tile bag whose length does not divide by
    ``sp`` raises."""
    sp_axis = _sp_axis(mesh)
    dp_total = len(mesh.ranks_along(mesh.data_axes(sp_axis)))
    sp_total = mesh.size // dp_total
    for batch, key_mask in batches:
        n_rows = batch[0].shape[0]
        if n_rows % dp_total:
            batch, key_mask = pad_rows((batch, key_mask), n_rows, dp_total)
            _logger.debug(f"padding ragged batch {n_rows} → {batch[0].shape[0]} rows (dp={dp_total}) by cycling rows")
        if len(batch) == 4:  # a tile batch: bags, coordinates and the key mask also by tiles
            if sp_axis and batch[0].shape[1] % sp_total != 0:
                raise ValueError(
                    f"bag size {batch[0].shape[1]} not divisible by sp={sp_total}; pick a divisible bag_size"
                )
            bags, coords, key_mask = shard_batch((batch[0], batch[1], key_mask), mesh, sp_axis=sp_axis)
            inputs = (bags, coords, shard_batch(batch[2], mesh, sp_axis=sp_axis, tiles=False))
        else:
            inputs = shard_batch(batch[:-1], mesh, sp_axis=sp_axis, tiles=False)
        yield (*inputs, batch[-1]), key_mask


def _train_model_impl(
    *,
    output_dir: Path,
    model: TaskModel,
    train_dl: BatchIterator,
    valid_dl: BatchIterator,
    max_epochs: int,
    patience: int,
    device: torch.device,
    pad_train_buckets: bool,
    mesh: Mesh | None,
) -> tuple[TaskModel, Any]:
    output_dir.mkdir(parents=True, exist_ok=True)
    if pad_train_buckets and not model.pads_bags:
        raise ValueError(
            "bag_size: null (whole-slide training) requires a mask-capable tile model (e.g. vit); "
            f"use a fixed bag_size with {type(model.module).__name__}."
        )
    monitor_metric, mode = model.monitor
    sign = 1.0 if mode == "min" else -1.0
    is_survival = model.task_name == "survival"

    # the JAX package reads one training batch for its initialisation: the
    # same draws from the shared generator keep the two packages' bags equal
    first_pass = iter(train_dl)
    next(first_pass)
    first_pass.close()
    _init_module(model)
    module = model.module.to(device)
    if mesh is not None:
        distributed.replicate_global(module)
    optimizer = model.make_optimizer(module.parameters())
    schedule = model.lr_schedule()
    generator = Seed.torch_generator(device)
    step = make_dp_train_step(
        model, optimizer, mesh, schedule=schedule, sp_axis=_sp_axis(mesh),
        forward=lambda batch, key_mask, group: forward_batch(
            model, batch, key_mask, device, train=True, generator=generator, group=group
        ),
    )  # fmt: skip

    # under a mesh every rank computes the same metrics; one writes them
    is_main = mesh is None or distributed.process_index() == 0
    logger = _EpochLogger(output_dir) if is_main else None
    best_value = math.inf
    best_variables = None
    best_ckpt_path: Path | None = None
    wait = 0
    global_step = 0

    for epoch in range(max_epochs):
        train_losses: list[torch.Tensor] = []
        train_outputs: list[np.ndarray] = []
        feed = _bucketed(train_dl) if pad_train_buckets else ((b, None) for b in train_dl)
        if mesh is not None:
            feed = _mesh_feed(feed, mesh)
        batches = prefetch_to_device(feed, size=2, device=device)
        while True:
            with profiling.stage("train/feed_wait"):  # the time the step waits for its batch
                fed = next(batches, None)
            if fed is None:
                break
            batch, key_mask = fed
            loss, outputs = step(batch, key_mask, global_step)
            train_losses.append(loss)
            if is_survival:
                train_outputs.append(outputs.float().cpu().numpy().reshape(-1))
            global_step += 1

        if not train_losses:
            raise ValueError(
                "training epoch produced zero steps — the dataloader yielded "
                "no usable batches (empty cohort or every batch filtered); "
                "a silent nan-loss epoch would leave the model untrained."
            )
        train_loss = float(np.mean([loss.float().cpu().numpy() for loss in train_losses]))
        if is_survival and train_outputs:
            model.train_pred_median = float(np.median(np.concatenate(train_outputs)))
            model.hparams["train_pred_median"] = model.train_pred_median

        val_outputs: list = []
        val_targets: list = []
        with profiling.stage("train/eval"), torch.inference_mode():
            for batch in valid_dl:
                key_mask = None
                if model.pads_bags:
                    batch, key_mask = _pad_tile_batch(batch, _bucket_size(batch[0].shape[1]))
                val_outputs.append(host_outputs(forward_batch(model, batch, key_mask, device)))
                val_targets.append(batch[-1])

        metrics = model.validation_metrics(val_outputs, val_targets)
        metrics["training_loss"] = train_loss
        metrics["epoch"] = epoch
        metrics["step"] = global_step
        metrics["learning_rate"] = schedule(max(global_step - 1, 0))
        if is_survival and model.train_pred_median is not None:
            metrics["train_pred_median"] = model.train_pred_median
        if logger is not None:
            logger.log(metrics)

        current = metrics.get(monitor_metric, math.nan)
        if mesh is not None:  # rank 0's value decides, so every rank stops together
            current = float(distributed.broadcast_(torch.tensor(current, dtype=torch.float64, device=device)))
        _logger.info(
            f"epoch {epoch}: "
            + " ".join(f"{k}={v:.4f}" for k, v in metrics.items() if k not in ("epoch", "step") and isinstance(v, float))
        )
        if not math.isnan(current) and sign * current < best_value:
            best_value = sign * current
            wait = 0
            best_variables = weights.variables_of(module)
            ckpt_dir = output_dir / "checkpoints"
            new_ckpt_path = ckpt_dir / f"checkpoint-epoch={epoch:02d}-{monitor_metric}={current:0.3f}.ckpt"
            if is_main:
                ckpt_dir.mkdir(exist_ok=True, parents=True)
                if best_ckpt_path is not None and best_ckpt_path.exists():
                    best_ckpt_path.unlink()  # save_top_k=1
                save_checkpoint(new_ckpt_path, hyper_parameters=model.checkpoint_hparams(), variables=best_variables)
            best_ckpt_path = new_ckpt_path
        else:
            wait += 1
            if wait >= patience:
                _logger.info(f"early stopping at epoch {epoch}")
                break

    if best_ckpt_path is None:
        # no epoch improved (e.g. an all-nan monitor): save the final state
        best_variables = weights.variables_of(module)
        best_ckpt_path = output_dir / "checkpoints" / "checkpoint-final.ckpt"
        if is_main:
            save_checkpoint(best_ckpt_path, hyper_parameters=model.checkpoint_hparams(), variables=best_variables)
    if is_main:
        shutil.copy(best_ckpt_path, output_dir / "model.ckpt")
    if mesh is not None:
        distributed.barrier()  # the others wait for rank 0's files
    return model, best_variables
