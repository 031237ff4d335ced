"""Deployment: checkpoints → whole-slide predictions → per-task CSVs.

Counterpart of ``stamp_tpu.modeling.deploy`` (``stamp_tpu/modeling/deploy.py:
51-665``) for every backbone: model re-instantiation from the checkpoint's
hyper-parameters (the npz ``model.ckpt`` or the reference's Lightning
``.ckpt``, ``modeling.interop``), the ensemble consistency checks, which
feature levels a model may be deployed on (a slide- or patient-level model
on either), the data-leakage CRITICAL log, softmax / risk post-processing
and the same prediction-CSV columns (``{gt_label}_{category}``, ``pred``,
per-patient ``loss``; survival ``pred_score`` and the ``cut_off=…`` marker
column; multi-target one ground-truth column per target, then per target
``pred_{t}`` and ``{t}_{category}``, and the summed ``loss``).

A tile bag of a backbone that takes a key mask (``vit``, ``barspoon``) is
padded to a power of two of at least 512 tiles and attended with the mask,
as the JAX package does, so the same patients reach the flash kernels at
the same sequence lengths (on the TPU the buckets bound recompiles; the
port keeps them for parity); other backbones see the bag at its own
length.  The forward runs on an explicit ``torch.device`` under
``torch.inference_mode()``.  A multi-target model's head outputs are
softmaxed by its predict step and, for classification, once more by
deploy (the reference re-softmaxes, ``deploy.py:428-430``).
"""

from __future__ import annotations

import logging
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
    load_patient_level_data,
    slide_to_patient_from_slide_table_,
)
from stamp_tpu_torch.modeling.tasks import TaskModel, instantiate_from_hparams
from stamp_tpu_torch.modeling.train import _bucket_size, _pad_tile_batch, forward_batch, host_outputs
from stamp_tpu_torch.models import weights
from stamp_tpu_torch.types import GroundTruth, PandasLabel, PatientId, SurvivalGroundTruth
from stamp_tpu_torch.utils import profiling

__all__ = ["deploy_categorical_model_", "load_model_from_ckpt"]

_logger = logging.getLogger("stamp")

PredictionsType: TypeAlias = Mapping[PatientId, np.ndarray | dict[str, np.ndarray]]


def load_model_from_ckpt(path: str | Path) -> tuple[TaskModel, Any]:
    """(task wrapper, JAX variable tree) of an npz checkpoint or of the
    reference's Lightning ``.ckpt`` (reference deploy.py:49-58)."""
    from stamp_tpu_torch.modeling.interop import is_reference_checkpoint, load_reference_checkpoint

    path = Path(path)
    if is_reference_checkpoint(path):
        return load_reference_checkpoint(path)
    payload = load_checkpoint(path)
    return instantiate_from_hparams(payload["hyper_parameters"]), payload["variables"]


def _predict_impl(
    *,
    model: TaskModel,
    variables: Any,
    test_dl: BatchIterator,
    patient_ids: Sequence[PatientId],
    device: torch.device,
) -> PredictionsType:
    """Inference over ``test_dl`` (whole bags or one vector a patient) on
    ``device`` (reference deploy.py:390-456)."""
    weights.load_variables_(model.module, variables)
    model.module.to(device).eval()

    outs: list = []
    with torch.inference_mode():
        for batch in test_dl:
            key_mask = None
            if model.pads_bags:
                batch, key_mask = _pad_tile_batch(batch, _bucket_size(batch[0].shape[1]))
            with profiling.stage("deploy/forward"):
                out = forward_batch(model, batch, key_mask, device)
                if isinstance(out, dict):  # the multi-target predict step softmaxes each head
                    out = {k: torch.softmax(v, dim=-1) for k, v in out.items()}
                outs.append(host_outputs(out))
    model.module.to("cpu")

    if not outs:
        return {}
    task = model.hparams.get("task")
    if isinstance(outs[0], dict):
        per_target = {k: np.concatenate([out[k] for out in outs], axis=0) for k in outs[0]}
        if task == "classification":
            # the reference softmaxes the predict step's probabilities again
            per_target = {k: _np_softmax(v) for k, v in per_target.items()}
        num_preds = next(iter(per_target.values())).shape[0]
        return {pid: {k: v[i] for k, v in per_target.items()} for i, pid in enumerate(patient_ids[:num_preds])}
    raw_preds = np.concatenate(outs, axis=0)
    if task == "classification":
        raw_preds = _np_softmax(raw_preds)
    elif task == "survival":
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


# which feature levels a model trained on level X can consume
_DEPLOYABLE_ON = {
    "tile": {"tile"},
    "slide": {"slide", "patient"},
    "patient": {"slide", "patient"},
}


def _deployment_cohort(
    *,
    feature_type: str,
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
    """(patient → data, patient → ground truth) of the cohort.  Patient-level
    features need the clini table (it names the patients); for tile and
    slide features, without a clini table every patient deploys with a
    ground truth of None (pure inference, no loss column)."""
    if feature_type == "patient":
        if slide_table is not None:
            _logger.warning("slide_table is ignored for patient-level features during deployment.")
        if clini_table is None:
            raise ValueError("clini_table is required for patient-level feature deployment.")
        patient_to_data = load_patient_level_data(
            task=cast(Any, task),
            clini_table=clini_table,
            feature_dir=feature_dir,
            patient_label=patient_label,
            ground_truth_label=ground_truth_label,
            time_label=time_label,
            status_label=status_label,
        )
        return patient_to_data, {pid: p.ground_truth for pid, p in patient_to_data.items()}
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
    if feature_type not in _DEPLOYABLE_ON.get(trained_level, set()):
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

    model_categories = None
    trained_cats: Any = None
    if task == "classification":
        trained_cats = _agreed(models, "Categories", lambda m: m.categories)
        if not isinstance(trained_cats, dict):  # multi-target keeps per-target vocabularies
            model_categories = list(cast(Sequence[GroundTruth], trained_cats))

    output_dir.mkdir(exist_ok=True, parents=True)

    patient_to_data, patient_to_ground_truth = _deployment_cohort(
        feature_type=feature_type,
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
        categories=model_categories,
    )
    test_dl = BatchIterator(test_ds, batch_size=1)

    df_builder = {
        "classification": _to_prediction_df,
        "regression": _to_regression_prediction_df,
        "survival": _to_survival_prediction_df,
    }[task]

    def export_csv(predictions: PredictionsType, filename: str, **extra) -> None:
        if predictions and isinstance(next(iter(predictions.values())), dict):
            # the vectors are ordered by the training vocabularies: label the
            # columns with those (from the ground truths only if there are none)
            targets = list(next(iter(predictions.values())))
            export_cats: Any = _target_vocabularies(
                trained_cats if isinstance(trained_cats, dict) else None, targets, patient_to_ground_truth
            )
        elif task == "classification":
            export_cats = trained_cats
        else:
            export_cats = []
        df_builder(
            categories=export_cats,
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
        # the ensemble mean over models, per patient (and per target)
        def mean_of(per_model: list) -> Any:
            if isinstance(per_model[0], dict):
                return {t: np.mean([p[t] for p in per_model], axis=0) for t in per_model[0]}
            return np.mean(per_model, axis=0)

        ensembled = {pid: mean_of([preds[pid] for preds in all_predictions]) for pid in patient_ids}
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


def _target_vocabularies(categories, targets: Sequence[str], patient_to_ground_truth) -> dict[str, list]:
    """Per-target category lists: the models' when they have them, otherwise
    the observed deployment ground truths'."""
    if isinstance(categories, dict):
        vocab = {t: list(v) for t, v in categories.items()}
    elif isinstance(categories, Sequence) and len(categories) >= len(targets):
        vocab = {t: list(cats) for t, cats in zip(targets, categories) if isinstance(cats, (list, tuple))}
    else:
        vocab = {}
    if unknown := [t for t in targets if t not in vocab]:
        dict_gts = [gt for gt in patient_to_ground_truth.values() if isinstance(gt, dict)]
        vocab.update({t: sorted({gt[t] for gt in dict_gts if gt.get(t) is not None}) for t in unknown})
    return vocab


def _multitarget_prediction_df(*, categories, patient_to_ground_truth, predictions, patient_label) -> pd.DataFrame:
    """Multi-target CSV: patient, one ground-truth column per target, then
    per target ``pred_{t}`` and one probability column per category, then
    the cross entropy summed over the targets with a known ground truth."""
    targets = list(next(iter(predictions.values())))
    vocab = _target_vocabularies(categories, targets, patient_to_ground_truth)
    rows = []
    for pid, pred in predictions.items():
        raw_gt = patient_to_ground_truth.get(pid)
        gt: dict = raw_gt if isinstance(raw_gt, dict) else {}
        row: dict = {patient_label: pid, **{t: (gt.get(t) if isinstance(raw_gt, dict) else raw_gt) for t in targets}}
        loss: float | None = None
        for t in targets:
            probs = np.asarray(pred[t])
            cats = vocab.get(t, [])
            if probs.size == 1:
                row[f"pred_{t}"] = float(probs.item())
            else:
                winner = int(probs.argmax())
                row[f"pred_{t}"] = cats[winner] if winner < len(cats) else winner
            row.update({f"{t}_{c}": float(probs[j]) if j < probs.shape[0] else None for j, c in enumerate(cats)})
            if (value := gt.get(t)) is not None and value in cats:
                loss = (loss or 0.0) + _cross_entropy_row(probs, cats.index(value))
        row["loss"] = loss
        rows.append(row)
    return pd.DataFrame(rows)


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
    per-patient cross-entropy ``loss`` (rows sorted by it); a multi-target
    model's in ``_multitarget_prediction_df``'s layout."""
    if isinstance(next(iter(predictions.values())), dict):
        return _multitarget_prediction_df(
            categories=categories,
            patient_to_ground_truth=patient_to_ground_truth,
            predictions=predictions,
            patient_label=patient_label,
        )
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
