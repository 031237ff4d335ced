"""Deployment: checkpoints → whole-slide predictions → per-task CSVs.

Counterpart of ``stamp_tpu.modeling.deploy`` (``stamp_tpu/modeling/deploy.py:
51-665``) for tile-level ViT checkpoints: model re-instantiation from the
checkpoint's hyper-parameters, the ensemble consistency checks, the
data-leakage CRITICAL log, softmax / risk post-processing and the same
prediction-CSV columns (``{gt_label}_{category}``, ``pred``, per-patient
``loss``; survival ``pred_score`` and the ``cut_off=…`` marker column).

Every bag is padded to a power of two of at least 512 tiles and attended
with a key mask, as the JAX package does, so the same patients reach the
flash kernels at the same sequence lengths (on the TPU the buckets bound
recompiles; the port keeps them for parity).  The forward runs on an
explicit ``torch.device`` under ``torch.inference_mode()``.

Not ported yet (each raises ``NotImplementedError`` naming
``python -m stamp_tpu deploy``): the reference's Lightning ``.ckpt`` files,
backbones other than ``vit``, slide- and patient-level features and
multi-target models.
"""

from __future__ import annotations

import logging
import math
import zipfile
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Any, TypeAlias, cast

import numpy as np
import pandas as pd
import torch

from stamp_tpu_torch.io.h5 import detect_feature_type
from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.modeling.data import (
    BatchIterator,
    _clini_ground_truths,
    create_dataset,
    filter_complete_patient_data_,
    slide_to_patient_from_slide_table_,
)
from stamp_tpu_torch.modeling.tasks import TaskModel, instantiate_from_hparams
from stamp_tpu_torch.models.vision_transformer import variables_from_jax
from stamp_tpu_torch.types import GroundTruth, PandasLabel, PatientId, SurvivalGroundTruth
from stamp_tpu_torch.utils import profiling

__all__ = ["deploy_categorical_model_", "load_model_from_ckpt"]

_logger = logging.getLogger("stamp")

PredictionsType: TypeAlias = Mapping[PatientId, np.ndarray]


def _is_lightning_checkpoint(path: Path) -> bool:
    """A torch-zip Lightning checkpoint (the reference's format)."""
    if not zipfile.is_zipfile(path):
        return False
    with zipfile.ZipFile(path) as zf:
        return any(name.endswith("data.pkl") for name in zf.namelist())


def load_model_from_ckpt(path: str | Path) -> tuple[TaskModel, Any]:
    """(task wrapper, variable tree) of an npz checkpoint (reference
    deploy.py:49-58)."""
    path = Path(path)
    if _is_lightning_checkpoint(path):
        raise NotImplementedError(
            f"{path.name} is a Lightning .ckpt, which the port does not read yet; "
            "run `python -m stamp_tpu deploy` (or convert it with "
            "`python -m stamp_tpu export_ckpt`)"
        )
    payload = load_checkpoint(path)
    return instantiate_from_hparams(payload["hyper_parameters"]), payload["variables"]


def _bucket_size(n: int, *, minimum: int = 512) -> int:
    if n <= minimum:
        return minimum
    return 1 << math.ceil(math.log2(n))


def _predict_impl(
    *,
    model: TaskModel,
    variables: Any,
    test_dl: BatchIterator,
    patient_ids: Sequence[PatientId],
    device: torch.device,
) -> PredictionsType:
    """Whole-slide inference over ``test_dl`` on ``device`` (reference
    deploy.py:390-456)."""
    module = model.module
    module.load_state_dict(variables_from_jax(variables))
    module.to(device).eval()

    outs: list[np.ndarray] = []
    with torch.inference_mode():
        for bags, coords, sizes, _targets in test_dl:
            b, t, f = bags.shape
            bucket = _bucket_size(t)
            if t < bucket:
                bags = np.concatenate([bags, np.zeros((b, bucket - t, f), bags.dtype)], axis=1)
                coords = np.concatenate([coords, np.zeros((b, bucket - t, 2), coords.dtype)], axis=1)
            key_mask = np.arange(bucket)[None, :] < np.asarray(sizes)[:, None]
            with profiling.stage("deploy/forward"):
                out = module(
                    torch.from_numpy(bags).to(device),
                    coords=torch.from_numpy(coords).to(device),
                    key_mask=torch.from_numpy(key_mask).to(device),
                )
                outs.append(out.float().cpu().numpy())
    module.to("cpu")

    if not outs:
        return {}
    raw_preds = np.concatenate(outs, axis=0)
    if model.hparams.get("task") == "classification":
        raw_preds = _np_softmax(raw_preds)
    elif model.hparams.get("task") == "survival":
        raw_preds = raw_preds.squeeze(-1)
    return {pid: raw_preds[i] for i, pid in enumerate(patient_ids)}


def _np_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = np.exp(x - m)
    return e / e.sum(axis=-1, keepdims=True)


def _agreed(models: Sequence[tuple[TaskModel, Any]], what: str, getter):
    """Every ensemble member must agree on ``what``; returns the shared value."""
    values = [getter(model) for model, _variables in models]
    if len({repr(v) for v in values}) != 1:
        raise RuntimeError(f"{what} differ between ensemble models: {values}")
    return values[0]


def _resolve_label(requested, trained, description: str):
    """Deployment labels default to what the model was trained with; an
    explicit different value is honored but warned about."""
    if requested and requested != trained:
        _logger.warning(f"deployment {description} differs from training: {requested} vs {trained}")
    return requested or trained


def _deployment_cohort(
    *,
    task: str,
    clini_table: Path | None,
    slide_table: Path | None,
    feature_dir: Path,
    patient_label: PandasLabel,
    filename_label: PandasLabel,
    ground_truth_label,
    time_label,
    status_label,
    drop_patients_with_missing_ground_truth: bool,
) -> tuple[Mapping[PatientId, Any], Mapping[PatientId, Any]]:
    """(patient → data, patient → ground truth) of a tile-level cohort.
    Without a clini table every patient deploys with a ground truth of None
    (pure inference, no loss column)."""
    if slide_table is None:
        raise ValueError(
            "Deploying on tile- or slide-level features requires a slide "
            "table mapping feature files to patients."
        )
    slide_to_patient = slide_to_patient_from_slide_table_(
        slide_table_path=slide_table,
        patient_label=patient_label,
        filename_label=filename_label,
        feature_dir=feature_dir,
    )
    if clini_table is None:
        ground_truths = dict.fromkeys(slide_to_patient.values())
    else:
        ground_truths = dict(
            _clini_ground_truths(
                task=cast(Any, task),
                clini_table=clini_table,
                patient_label=patient_label,
                ground_truth_label=ground_truth_label,
                time_label=time_label,
                status_label=status_label,
            )
        )
    patient_to_data = filter_complete_patient_data_(
        patient_to_ground_truth=ground_truths,
        slide_to_patient=slide_to_patient,
        drop_patients_with_missing_ground_truth=drop_patients_with_missing_ground_truth,
    )
    return patient_to_data, ground_truths


def deploy_categorical_model_(
    *,
    checkpoint_paths: Sequence[Path],
    output_dir: Path,
    feature_dir: Path,
    clini_table: Path | None,
    slide_table: Path | None,
    patient_label: PandasLabel,
    filename_label: PandasLabel,
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None,
    time_label: PandasLabel | None,
    status_label: PandasLabel | None,
    device: torch.device,
    drop_patients_with_missing_ground_truth: bool = True,
) -> None:
    """Deploy an ensemble of checkpoints on a cohort (reference
    deploy.py:61-387): one prediction CSV per model plus, for
    classification, the ensemble mean; a CRITICAL log if a deploy patient
    was seen during training."""
    feature_type = detect_feature_type(feature_dir)
    _logger.info(f"Detected feature type: {feature_type}")

    models = [load_model_from_ckpt(p) for p in checkpoint_paths]

    task = _agreed(models, "Tasks", lambda m: m.hparams["task"])
    trained_level = _agreed(models, "Feature levels", lambda m: m.hparams["supported_features"])
    if feature_type != trained_level:
        raise RuntimeError(
            f"Model trained on {trained_level}-level features cannot be "
            f"deployed on {feature_type}-level features."
        )

    if task == "survival":
        time_label = _resolve_label(
            time_label,
            _agreed(models, "Time labels", lambda m: getattr(m, "time_label", None)),
            "time label",
        )
        status_label = _resolve_label(
            status_label,
            _agreed(models, "Status labels", lambda m: getattr(m, "status_label", None)),
            "status label",
        )
    else:
        ground_truth_label = _resolve_label(
            ground_truth_label,
            _agreed(models, "Ground truth labels", lambda m: m.ground_truth_label),
            "ground truth label",
        )

    trained_cats = None
    if task == "classification":
        trained_cats = list(_agreed(models, "Categories", lambda m: m.categories))

    output_dir.mkdir(exist_ok=True, parents=True)

    patient_to_data, patient_to_ground_truth = _deployment_cohort(
        task=task,
        clini_table=clini_table,
        slide_table=slide_table,
        feature_dir=feature_dir,
        patient_label=patient_label,
        filename_label=filename_label,
        ground_truth_label=ground_truth_label,
        time_label=time_label,
        status_label=status_label,
        drop_patients_with_missing_ground_truth=drop_patients_with_missing_ground_truth,
    )
    patient_ids = list(patient_to_data.keys())

    test_ds, _ = create_dataset(
        feature_type=feature_type,
        task=task,
        patient_data=list(patient_to_data.values()),
        categories=trained_cats,
    )
    test_dl = BatchIterator(test_ds, batch_size=1)

    df_builder = {
        "classification": _to_prediction_df,
        "regression": _to_regression_prediction_df,
        "survival": _to_survival_prediction_df,
    }[task]

    def export_csv(predictions: PredictionsType, filename: str, **extra) -> None:
        df_builder(
            categories=trained_cats if task == "classification" else [],
            patient_to_ground_truth=patient_to_ground_truth,
            predictions=predictions,
            patient_label=patient_label,
            ground_truth_label=ground_truth_label,
            time_label=time_label,
            status_label=status_label,
            **extra,
        ).to_csv(output_dir / filename, index=False)

    deploy_set = set(patient_ids)
    all_predictions: list[PredictionsType] = []
    for index, (model, variables) in enumerate(models):
        seen_in_training = set(model.train_patients).union(model.valid_patients)
        if leaked := sorted(seen_in_training & deploy_set):
            _logger.critical(
                "DATA LEAKAGE DETECTED: %d patient(s) in deployment set were used "
                "during training/validation. Overlapping IDs: %s",
                len(leaked),
                leaked,
            )
        predictions = _predict_impl(
            model=model,
            variables=variables,
            test_dl=test_dl,
            patient_ids=patient_ids,
            device=device,
        )
        all_predictions.append(predictions)
        export_csv(
            predictions,
            f"patient-preds-{index}.csv" if len(models) > 1 else "patient-preds.csv",
            cut_off=model.hparams.get("train_pred_median", None),
        )

    if task == "classification":
        ensembled = {
            pid: np.mean([preds[pid] for preds in all_predictions], axis=0) for pid in patient_ids
        }
        export_csv(ensembled, "patient-preds_95_confidence_interval.csv")


# ---------------------------------------------------------------------------
# CSV builders (reference deploy.py:459-692)
# ---------------------------------------------------------------------------


def _cross_entropy_row(probs: np.ndarray, target_index: int) -> float:
    """torch F.cross_entropy on a single row of *probabilities* — the
    reference feeds softmaxed scores back through cross_entropy, so they
    are softmaxed again."""
    logp = probs - _np_logsumexp_1d(probs)
    return float(-logp[target_index])


def _np_logsumexp_1d(x: np.ndarray) -> float:
    m = x.max()
    return m + np.log(np.exp(x - m).sum())


def _to_prediction_df(
    *,
    categories,
    patient_to_ground_truth,
    predictions,
    patient_label: PandasLabel,
    ground_truth_label,
    **kwargs,
) -> pd.DataFrame:
    """Classification CSV: patient, ground truth, argmax ``pred``, one
    ``{gt_label}_{category}`` probability column per category and the
    per-patient cross-entropy ``loss`` (rows sorted by it)."""
    cats = list(cast(Sequence[GroundTruth], categories))
    pids = list(predictions)
    probs = np.stack([np.asarray(predictions[pid]) for pid in pids])
    gts = [patient_to_ground_truth.get(pid) for pid in pids]

    table = pd.DataFrame({patient_label: pids, ground_truth_label: gts})
    table["pred"] = [cats[i] for i in probs.argmax(axis=1)]
    for j, category in enumerate(cats):
        table[f"{ground_truth_label}_{category}"] = probs[:, j].astype(float)
    table["loss"] = [
        _cross_entropy_row(probs[i], cats.index(gt)) if gt is not None else None
        for i, gt in enumerate(gts)
    ]
    return table.sort_values(by="loss")


def _to_regression_prediction_df(
    *,
    patient_to_ground_truth,
    predictions,
    patient_label: PandasLabel,
    ground_truth_label: PandasLabel,
    **kwargs,
) -> pd.DataFrame:
    """Regression CSV: patient, ground truth, ``pred``, absolute error
    ``loss`` (None when the ground truth is missing), sorted by loss."""
    rows = []
    for pid, pred in predictions.items():
        pred = np.asarray(pred).ravel()
        gt = patient_to_ground_truth.get(pid)
        scalar = pred.size == 1
        has_gt = gt is not None and str(gt).lower() != "nan"
        rows.append({
            patient_label: pid,
            ground_truth_label: gt,
            "pred": float(pred[0]) if scalar else pred.tolist(),
            "loss": abs(float(pred[0]) - float(gt)) if scalar and has_gt else None,
        })  # fmt: skip
    return pd.DataFrame(rows).sort_values(by="loss", na_position="last")


def _to_survival_prediction_df(
    *,
    patient_to_ground_truth: Mapping[PatientId, GroundTruth | SurvivalGroundTruth | None],
    predictions,
    patient_label: PandasLabel,
    time_label: PandasLabel = "time",
    status_label: PandasLabel = "event",
    cut_off: float | None = None,
    **kwargs,
) -> pd.DataFrame:
    """Survival CSV: patient, ``pred_score`` risk, the (time, event) ground
    truth and, when the model stored a training-median cut-off, an empty
    ``cut_off=<value>`` column whose header carries the threshold."""
    rows = []
    for pid, pred in predictions.items():
        pred = np.asarray(pred).ravel()
        gt = patient_to_ground_truth.get(pid)
        known = isinstance(gt, (tuple, list)) and len(gt) == 2
        time, status = gt if known else (None, None)
        rows.append({
            patient_label: pid,
            "pred_score": float(pred[0]) if pred.size == 1 else pred.tolist(),
            time_label: time,
            status_label: status,
        })  # fmt: skip

    table = pd.DataFrame(rows)
    if cut_off is not None:
        table[f"cut_off={cut_off}"] = None
    return table
