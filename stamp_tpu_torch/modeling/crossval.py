"""K-fold cross-validation with ``splits.json`` resumability.

Counterpart of ``stamp_tpu/modeling/crossval.py:48-449`` for every
backbone and feature level, single- and multi-target: the same
``splits.json`` schema (files interchange with the JAX package and the
reference), the same folds (``modeling.splits.KFold`` for regression and
multi-target cohorts, ``StratifiedKFold`` on the class or the survival
status otherwise, ``shuffle=True, random_state=0``: scikit-learn's indices
without scikit-learn), an atomic write of the splits file, one category
inventory for every fold (per target for multi-target, which also labels
the exported columns), folds skipped when their ``patient-preds.csv``
exists and re-exported from ``model.ckpt`` when only that exists, and each
fold trained on the other folds with the held-out fold as its early-stop
validation set.  The held-out predictions go through the port's deploy
path.

Across a fleet of ranks (``parallel.distributed``) the folds are split
round-robin (``fold_is_mine``, the JAX package's shares and log line,
``stamp_tpu/modeling/crossval.py:390-407``); with a ``mesh_shape`` every
rank trains every fold together and rank 0 alone writes.  The port's mesh
always spans the fleet's ranks (a rank is one device), so any
``mesh_shape`` keeps the partition off — the part the JAX package's rule
gives only a ``dcn`` axis, since its ``dp``-only mesh may stay inside each
host.  Rank 0 writes ``splits.json`` before the others read it, and the
per-fold skip-if-exists keeps restarts and crashed ranks safe.  The folds of
one process share the host generator in turn, as in the JAX package, so a
fold's bags depend on the folds that process trained before it: a fleet's
fold equals a single-process run that reaches it with the earlier folds
already done (their ``patient-preds.csv`` present).
"""

from __future__ import annotations

import logging
from collections import Counter
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any

import numpy as np
import torch
from pydantic import BaseModel

from stamp_tpu_torch.modeling.config import AdvancedConfig, CrossvalConfig
from stamp_tpu_torch.modeling.data import (
    BatchIterator,
    PatientData,
    create_dataset,
    load_patient_data_,
    log_patient_class_summary,
)
from stamp_tpu_torch.modeling.deploy import (
    _predict_impl,
    _to_prediction_df,
    _to_regression_prediction_df,
    _to_survival_prediction_df,
    load_model_from_ckpt,
)
from stamp_tpu_torch.modeling.splits import KFold, StratifiedKFold
from stamp_tpu_torch.modeling.train import setup_model_from_dataloaders, train_model_
from stamp_tpu_torch.modeling.transforms import VaryPrecisionTransform
from stamp_tpu_torch.parallel import distributed
from stamp_tpu_torch.types import GroundTruth, PatientId

_logger = logging.getLogger("stamp")


class _Split(BaseModel):
    train_patients: set[PatientId]
    test_patients: set[PatientId]


class _Splits(BaseModel):
    splits: Sequence[_Split]


def _first_target(gt):
    return next(iter(gt.values())) if isinstance(gt, dict) else gt


def _stratification_labels(task: str | None, patients: Sequence[PatientData]) -> np.ndarray | None:
    """What StratifiedKFold stratifies on: the class for classification, the
    event status for survival, nothing for regression (or multi-target,
    which takes KFold)."""
    if task == "classification":
        return np.array([_first_target(p.ground_truth) for p in patients])
    if task == "survival":
        statuses = []
        for p in patients:
            gt = _first_target(p.ground_truth)
            status = gt[1] if isinstance(gt, (tuple, list)) and len(gt) == 2 else gt
            statuses.append(int(status) if status is not None else 0)
        return np.array(statuses)
    return None


def _generate_splits(patient_to_data: Mapping[PatientId, PatientData], *, n_splits: int, task: str | None) -> _Splits:
    """The reference's folds (crossval.py:373-426): the same splitter,
    shuffle=True, random_state=0."""
    multitarget = any(isinstance(p.ground_truth, dict) for p in patient_to_data.values())
    splitter_cls = KFold if (task == "regression" or multitarget) else StratifiedKFold
    _logger.info(f"Using {splitter_cls.__name__} for cross-validation splits")
    ids = np.array(list(patient_to_data.keys()))
    strat = _stratification_labels(task, list(patient_to_data.values()))
    splitter = splitter_cls(n_splits=n_splits, shuffle=True, random_state=0)
    fold_iter = splitter.split(ids) if strat is None else splitter.split(ids, strat)
    return _Splits(
        splits=[_Split(train_patients=set(ids[tr]), test_patients=set(ids[te])) for tr, te in fold_iter]
    )


def _load_or_create_splits(
    splits_file: Path, patient_to_data: Mapping[PatientId, PatientData], *, n_splits: int, task: str | None
) -> _Splits:
    if splits_file.exists():
        _logger.debug(f"reading splits from {splits_file}")
        splits = _Splits.model_validate_json(splits_file.read_text())
    else:
        splits = _generate_splits(patient_to_data, n_splits=n_splits, task=task)
        # atomic write: a reader never sees a half-written file
        tmp = splits_file.with_suffix(".json.tmp")
        tmp.write_text(splits.model_dump_json(indent=4))
        tmp.rename(splits_file)

    covered = {pid for split in splits.splits for pid in (*split.train_patients, *split.test_patients)}
    if unknown := covered - patient_to_data.keys():
        raise RuntimeError(
            "The splits file contains some patients we don't have information "
            f"for in the clini / slide table: {unknown}"
        )
    if uncovered := patient_to_data.keys() - covered:
        _logger.warning(f"Some of the entries in the clini / slide table are not in the crossval split: {uncovered}")
    return splits


def _single_target_categories(patient_to_data: Mapping[PatientId, PatientData]) -> list[GroundTruth]:
    return sorted(
        {
            p.ground_truth
            for p in patient_to_data.values()
            if p.ground_truth is not None and not isinstance(p.ground_truth, dict)
        }
    )


def _multitarget_categories(patient_to_data: Mapping[PatientId, PatientData]) -> dict[str, list]:
    """Per-target sorted class lists, with a class-balance log line each."""
    by_target: dict[str, set] = {}
    for p in patient_to_data.values():
        if isinstance(p.ground_truth, dict):
            for target, value in p.ground_truth.items():
                if value is not None:
                    by_target.setdefault(target, set()).add(value)
    inventory = {target: sorted(values) for target, values in by_target.items()}
    for target, classes in inventory.items():
        values = [
            p.ground_truth.get(target)
            for p in patient_to_data.values()
            if isinstance(p.ground_truth, dict) and p.ground_truth.get(target) is not None
        ]
        tally = Counter(values)
        _logger.info(
            f"{target} | Total patients: {len(values)} | "
            + " | ".join(f"Class {c}: {tally.get(c, 0)}" for c in classes)
        )
    return inventory


def _fit_fold(
    *,
    split: _Split,
    split_dir: Path,
    patient_to_data: Mapping[PatientId, PatientData],
    feature_type: str,
    categories: Sequence[GroundTruth] | None,
    config: CrossvalConfig,
    advanced: AdvancedConfig,
    device: torch.device,
) -> tuple[Any, Any]:
    """Train this fold's model (the held-out fold is the early-stop
    validation set)."""
    train_ids = [pid for pid in split.train_patients if pid in patient_to_data]
    test_ids = [pid for pid in split.test_patients if pid in patient_to_data]
    if advanced.mesh_shape:
        # a set's order follows the process's string hashing: the ranks
        # of a mesh draw their batches in rank 0's order
        train_ids, test_ids = distributed.broadcast_object((train_ids, test_ids))
    transform = VaryPrecisionTransform(min_fraction_bits=1) if config.use_vary_precision_transform else None
    train_ds, train_categories = create_dataset(
        feature_type=feature_type,
        task=config.task,
        patient_data=[patient_to_data[pid] for pid in train_ids],
        bag_size=advanced.bag_size,
        shuffle=True,
        transform=transform,
        categories=categories,
    )
    test_ds, _ = create_dataset(
        feature_type=feature_type,
        task=config.task,
        patient_data=[patient_to_data[pid] for pid in test_ids],
        bag_size=None,
        shuffle=False,
        categories=train_categories,
    )
    train_dl = BatchIterator(train_ds, batch_size=advanced.batch_size, shuffle=True)
    test_dl = BatchIterator(test_ds, batch_size=1, shuffle=False)
    model = setup_model_from_dataloaders(
        train_dl=train_dl,
        task=config.task,
        train_categories=train_categories,
        dim_feats=int(train_ds[0][0].shape[-1]),
        train_patients=train_ids,
        valid_patients=test_ids,
        feature_type=feature_type,
        advanced=advanced,
        ground_truth_label=config.ground_truth_label,
        time_label=config.time_label,
        status_label=config.status_label,
        clini_table=config.clini_table,
        slide_table=config.slide_table,
        feature_dir=config.feature_dir,
    )
    return train_model_(
        output_dir=split_dir,
        model=model,
        train_dl=train_dl,
        valid_dl=test_dl,
        max_epochs=advanced.max_epochs,
        patience=advanced.patience,
        device=device,
        pad_train_buckets=advanced.bag_size is None,
        mesh_shape=advanced.mesh_shape,
    )


def _export_fold_predictions(
    *,
    split: _Split,
    split_dir: Path,
    model: Any,
    variables: Any,
    patient_to_data: Mapping[PatientId, PatientData],
    feature_type: str,
    categories: Sequence[GroundTruth] | None,
    categories_for_export: Any,
    config: CrossvalConfig,
    device: torch.device,
    write: bool = True,
) -> None:
    """Held-out-fold predictions → ``split-i/patient-preds.csv`` (computed
    without ``write`` too: the feed's draws keep a mesh's ranks in step)."""
    test_ids = [pid for pid in split.test_patients if pid in patient_to_data]
    test_ds, _ = create_dataset(
        feature_type=feature_type,
        task=config.task,
        patient_data=[patient_to_data[pid] for pid in test_ids],
        bag_size=None,
        shuffle=False,
        categories=categories,
    )
    predictions = _predict_impl(
        model=model,
        variables=variables,
        test_dl=BatchIterator(test_ds, batch_size=1, shuffle=False),
        patient_ids=test_ids,
        device=device,
    )
    if not write:
        return
    ground_truths = {pid: p.ground_truth for pid, p in patient_to_data.items()}
    if config.task in ("survival", "regression") and any(isinstance(gt, dict) for gt in ground_truths.values()):
        _logger.warning(f"Multi-target {config.task} prediction export not yet supported; skipping CSV save")
        return
    if config.task in ("regression", "classification") and config.ground_truth_label is None:
        raise RuntimeError(f"Ground truth label is required for {config.task}")
    builder = {
        "classification": _to_prediction_df,
        "regression": _to_regression_prediction_df,
        "survival": _to_survival_prediction_df,
    }[config.task]
    builder(
        categories=categories_for_export,
        patient_to_ground_truth=ground_truths,
        predictions=predictions,
        patient_label=config.patient_label,
        ground_truth_label=config.ground_truth_label,
        cut_off=model.hparams.get("train_pred_median", None),
    ).to_csv(split_dir / "patient-preds.csv", index=False)


def categorical_crossval_(config: CrossvalConfig, advanced: AdvancedConfig, device: torch.device) -> None:
    """``stamp crossval`` (reference crossval.py:338-449)."""
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
    if feature_type not in ("tile", "slide", "patient"):
        raise ValueError(f"Unknown feature type: {feature_type}")

    config.output_dir.mkdir(parents=True, exist_ok=True)
    distributed.init_distributed(use_cuda=device.type == "cuda")
    rank, n_ranks = distributed.process_index(), distributed.process_count()

    def splits_of_run() -> _Splits:
        return _load_or_create_splits(
            config.output_dir / "splits.json", patient_to_data, n_splits=config.n_splits, task=config.task
        )

    # rank 0 writes splits.json before the others read it
    if rank == 0:
        splits = splits_of_run()
    distributed.barrier()
    if rank != 0:
        splits = splits_of_run()

    # one category inventory for every fold, so heads and CSVs line up
    categories: Sequence[GroundTruth] | None
    categories_for_export: Any
    if config.task != "classification":
        categories, categories_for_export = [], []
    elif isinstance(config.ground_truth_label, str):
        categories = config.categories or _single_target_categories(patient_to_data)
        log_patient_class_summary(patient_to_data=patient_to_data)
        categories_for_export = list(categories)
    else:  # multi-target
        categories_for_export = _multitarget_categories(patient_to_data)
        categories = config.categories or None

    # a fleet without a mesh trains its folds round-robin, one share a rank
    partition_folds = n_ranks > 1 and not advanced.mesh_shape
    for split_i, split in enumerate(splits.splits):
        split_dir = config.output_dir / f"split-{split_i}"
        if partition_folds and not distributed.fold_is_mine(split_i):
            _logger.info(f"skipping split {split_i}: assigned to process {split_i % n_ranks} of the fleet")
            continue
        if (split_dir / "patient-preds.csv").exists():
            _logger.info(f"skipping training for split {split_i}, as a model checkpoint is already present")
            continue
        if (split_dir / "model.ckpt").exists():
            model, variables = load_model_from_ckpt(split_dir / "model.ckpt")
        else:
            fold_categories = categories
            if fold_categories is None and isinstance(config.ground_truth_label, str):
                fold_categories = _single_target_categories(patient_to_data)
            model, variables = _fit_fold(
                split=split,
                split_dir=split_dir,
                patient_to_data=patient_to_data,
                feature_type=feature_type,
                categories=fold_categories,
                config=config,
                advanced=advanced,
                device=device,
            )
        _export_fold_predictions(
            split=split,
            split_dir=split_dir,
            model=model,
            variables=variables,
            patient_to_data=patient_to_data,
            feature_type=feature_type,
            categories=categories,
            categories_for_export=categories_for_export,
            config=config,
            device=device,
            write=not advanced.mesh_shape or rank == 0,  # under a mesh rank 0 alone writes
        )
