"""Data layer of the deploy path: tables, patient assembly, whole-slide bags.

Counterpart of the parts of ``stamp_tpu.modeling.data`` that ``stamp
deploy`` reaches on tile-level features (``stamp_tpu/modeling/data.py:77-1025``):
clini/slide-table parsing with the same column, missing-value and
survival-status rules, the patient ↔ feature-file assembly, the tile-level
``BagDataset`` with ``bag_size=None`` (the whole slide, every tile of every
slide of a patient), ``create_dataset`` and an in-order ``BatchIterator``.
Batches are numpy: ``(bags [B, T, F], coords [B, T, 2], bag_sizes [B],
targets)``.

Feature files are read by ``stamp_tpu_torch.io.h5.read_feats`` (the port's
own layout without h5py, any other through h5py).  Not ported yet: bag
sampling and shuffling (training), file-like tables, slide/patient-level
features and multi-target ground truths; the last two raise
``NotImplementedError``.
"""

from __future__ import annotations

import logging
from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence
from dataclasses import KW_ONLY, dataclass
from pathlib import Path
from typing import Any, Generic, cast

import numpy as np
import pandas as pd

from stamp_tpu_torch.io.h5 import read_feats
from stamp_tpu_torch.types import (
    Category,
    FeaturePath,
    GroundTruthType,
    PandasLabel,
    PatientId,
    Task,
)

__all__ = [
    "PatientData",
    "BagDataset",
    "BatchIterator",
    "create_dataset",
    "read_table",
    "filter_complete_patient_data_",
    "slide_to_patient_from_slide_table_",
]

_logger = logging.getLogger("stamp")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet; run `python -m stamp_tpu deploy`")


@dataclass
class PatientData(Generic[GroundTruthType]):
    """All raw (i.e. non-generated) information we have on the patient."""

    _ = KW_ONLY
    ground_truth: GroundTruthType
    feature_files: Iterable[FeaturePath]


# ---------------------------------------------------------------------------
# Table parsing (reference data.py:865-1061)
# ---------------------------------------------------------------------------


_TABLE_LOADERS: dict[str, Callable[..., pd.DataFrame]] = {
    ".csv": pd.read_csv,
    ".xlsx": pd.read_excel,
}


def read_table(path: Path, **kwargs) -> pd.DataFrame:
    """Load a clini/slide table (``.csv`` or ``.xlsx``)."""
    loader = _TABLE_LOADERS.get(path.suffix)
    if loader is None:
        raise ValueError(
            "table to load has to either be an excel (`*.xlsx`) or csv "
            "(`*.csv`) file."
        )
    return loader(path, **kwargs)


def _read_table_columns(path: Path, columns: list[PandasLabel]) -> pd.DataFrame:
    """Read exactly ``columns`` as strings, naming any missing column."""
    try:
        return read_table(path, usecols=columns, dtype=str)
    except ValueError as e:
        raise ValueError(f"table is missing one of the columns {columns}: {e}") from e


# tokens that mean "no value" in hand-curated survival-time columns
# (reference data.py:957-983)
_MISSING_TOKENS = [
    "NA", "NaN", "nan", "None", "none", "N/A", "n/a", "NULL", "null",
    "", " ", "?", "-", "--", "#N/A", "#NA", "=#VALUE!",
]  # fmt: skip

# free-form survival-status vocabularies (reference data.py:1164-1201);
# comparison happens on the stripped, lowercased token
_EVENT_TOKENS = {"1", "event", "dead", "deceased", "yes", "y", "true"}
_CENSORED_TOKENS = {"0", "alive", "censored", "no", "false"}


def _parse_survival_status(value) -> int:
    """Map a free-form status cell to 1 (event occurred) / 0 (censored);
    strings outside both vocabularies fall through to numeric parsing."""
    token = str(value).strip().lower()
    if token in _EVENT_TOKENS:
        return 1
    if token in _CENSORED_TOKENS:
        return 0
    try:
        return int(float(token) > 0)
    except ValueError:
        raise ValueError(
            f"Unrecognized survival status: {value!r}. Expected one of "
            f"{sorted(_EVENT_TOKENS | _CENSORED_TOKENS)} or a numeric value."
        ) from None


def patient_to_ground_truth_from_clini_table_(
    *,
    clini_table_path: Path,
    patient_label: PandasLabel,
    ground_truth_label: PandasLabel,
) -> dict[PatientId, Any]:
    """Load patient → ground truth from one clini-table column."""
    if not isinstance(ground_truth_label, str):
        raise _not_ported("multi-target deployment")
    table = _read_table_columns(clini_table_path, [patient_label, ground_truth_label]).dropna(
        subset=[ground_truth_label]
    )
    series = table.set_index(patient_label)[ground_truth_label]
    if not series.index.is_unique:
        dupes = sorted(set(series.index[series.index.duplicated()]))
        raise ValueError(f"duplicate patients in clini table: {dupes}")
    return cast(dict[PatientId, Any], series.to_dict())


def patient_to_survival_from_clini_table_(
    *,
    clini_table_path: Path,
    patient_label: PandasLabel,
    time_label: PandasLabel,
    status_label: PandasLabel,
) -> dict[PatientId, tuple[float | None, int | None]]:
    """Load patient → (follow-up time, event indicator): missing-value tokens
    in the time column become NaN, the status column is normalized, and
    patients without a usable time are dropped (reference data.py:936-1002)."""
    table = _read_table_columns(clini_table_path, [patient_label, time_label, status_label])
    time = pd.to_numeric(table[time_label].replace(_MISSING_TOKENS, np.nan), errors="raise")
    status = table[status_label].str.strip().str.lower()

    usable = time.notna()  # a status without a time is unusable either way
    return {
        PatientId(str(pid)): (float(t), _parse_survival_status(s))
        for pid, t, s in zip(table.loc[usable, patient_label], time[usable], status[usable])
    }


def slide_to_patient_from_slide_table_(
    *,
    slide_table_path: Path,
    feature_dir: Path,
    patient_label: PandasLabel,
    filename_label: PandasLabel,
) -> dict[FeaturePath, PatientId]:
    """Slide table → {feature-file path: patient id}; every filename must
    carry the ``.h5`` extension and be unique (reference data.py:1005-1041)."""
    table = _read_table_columns(slide_table_path, [patient_label, filename_label])
    filenames = table[filename_label].astype(str)
    if not (is_h5 := filenames.str.endswith(".h5")).all():
        raise ValueError(
            "One or more files are missing the .h5 extension in the "
            "filename_label column. The first file missing the .h5 "
            f"extension is: {filenames[~is_h5].iloc[0]}."
        )
    if (dup := filenames.duplicated()).any():
        raise ValueError(f"duplicate slide filenames in slide table: {sorted(set(filenames[dup]))}")
    return {
        FeaturePath(feature_dir / fname): PatientId(str(pid))
        for fname, pid in zip(filenames, table[patient_label])
    }


def _warn_on_incomplete_cohort(
    *,
    patient_to_ground_truth: Mapping[PatientId, Any],
    slide_to_patient: Mapping[FeaturePath, PatientId],
) -> None:
    """Surface clini/slide-table/feature-dir disagreements before they
    silently shrink the cohort (reference data.py:1115-1147)."""
    clini_patients = set(patient_to_ground_truth)
    slide_patients = set(slide_to_patient.values())
    for missing, message in (
        (clini_patients - slide_patients, "some patients have no associated slides"),
        (slide_patients - clini_patients, "some patients have no clinical information"),
    ):
        if missing:
            _logger.warning(f"{message}: {missing}")
    if absent := sorted(p.name for p in slide_to_patient if not p.exists()):
        _logger.warning("some feature files could not be found: %s", ", ".join(absent))


def filter_complete_patient_data_(
    *,
    patient_to_ground_truth: Mapping[PatientId, Any],
    slide_to_patient: Mapping[FeaturePath, PatientId],
    drop_patients_with_missing_ground_truth: bool,
) -> Mapping[PatientId, PatientData]:
    """PatientData for every patient with a ground truth (or, when missing
    ones are kept, any slide-table patient) and at least one existing
    feature file (reference data.py:1057-1112)."""
    _warn_on_incomplete_cohort(
        patient_to_ground_truth=patient_to_ground_truth,
        slide_to_patient=slide_to_patient,
    )

    patient_to_slides: dict[PatientId, set[FeaturePath]] = {}
    for feature_path, patient_id in slide_to_patient.items():
        patient_to_slides.setdefault(patient_id, set()).add(feature_path)

    eligible: Mapping[PatientId, Any]
    if drop_patients_with_missing_ground_truth:
        eligible = patient_to_ground_truth
    else:
        eligible = {**dict.fromkeys(patient_to_slides), **patient_to_ground_truth}

    patients: dict[PatientId, PatientData] = {}
    for patient_id, ground_truth in eligible.items():
        on_disk = {path for path in patient_to_slides.get(patient_id, ()) if path.exists()}
        if on_disk:
            patients[patient_id] = PatientData(ground_truth=ground_truth, feature_files=on_disk)

    _logger.info(
        f"Total patients in clinical table: {len(eligible)}\n"
        f"Patients appearing in slide table: {len(patient_to_slides)}\n"
        f"Final usable patients (complete data): {len(patients)}\n"
    )
    return patients


def _clini_ground_truths(
    *,
    task: Task | None,
    clini_table: Path,
    patient_label: PandasLabel,
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None,
    time_label: PandasLabel | None,
    status_label: PandasLabel | None,
) -> Mapping[PatientId, Any]:
    """Validate the task/label combination and parse the clini table:
    survival needs ``time_label`` and ``status_label``, everything else
    ``ground_truth_label``."""
    if task == "survival":
        if time_label is None or status_label is None:
            raise ValueError("Both time_label and status_label are required for survival modeling")
        return patient_to_survival_from_clini_table_(
            clini_table_path=clini_table,
            patient_label=patient_label,
            time_label=time_label,
            status_label=status_label,
        )
    if ground_truth_label is None:
        raise ValueError("Ground truth label is required for classification or regression modeling")
    return patient_to_ground_truth_from_clini_table_(
        clini_table_path=clini_table,
        patient_label=patient_label,
        ground_truth_label=cast(PandasLabel, ground_truth_label),
    )


# ---------------------------------------------------------------------------
# Target encoding (reference data.py:146-252)
# ---------------------------------------------------------------------------


def _parse_targets(
    *,
    patient_data: Sequence[PatientData],
    task: Task,
    categories: Sequence[Category] | None = None,
) -> tuple[np.ndarray, Sequence[Category]]:
    """Raw ground truths → model-ready arrays (one-hot, scalar or
    (time, event)) and the category list."""
    gts = [p.ground_truth for p in patient_data]

    if task == "classification":
        if any(isinstance(gt, dict) for gt in gts):
            raise _not_ported("multi-target deployment")
        unique = {gt for gt in gts if gt is not None}
        if len(unique) < 2 and categories is None:
            raise ValueError(
                "Only one unique class found in classification task. "
                "This is usually a data or configuration error."
            )
        cats = list(categories) if categories is not None else sorted(unique)
        raw = np.array(gts)
        return (raw.reshape(-1, 1) == np.array(cats)).astype(np.float32), cats

    if task == "regression":
        scalars = [np.nan if gt is None else float(gt) for gt in gts]
        return np.asarray(scalars, np.float32).reshape(-1, 1), []

    if task == "survival":
        pairs: list[tuple[float, float]] = []
        for gt in gts:
            if gt is None:
                pairs.append((np.nan, np.nan))
                continue
            if not (isinstance(gt, (tuple, list)) and len(gt) == 2):
                raise ValueError("survival ground truth must be a (time, event) tuple/list")
            time, event = gt
            time_missing = time is None or str(time).lower() == "nan"
            pairs.append((
                np.nan if time_missing else float(time),
                np.nan if event is None else float(event),
            ))  # fmt: skip
        return np.asarray(pairs, np.float32), []

    raise ValueError(f"Unsupported task: {task}")


# ---------------------------------------------------------------------------
# Datasets and batches
# ---------------------------------------------------------------------------


@dataclass
class BagDataset:
    """Whole-slide bags from ``.h5`` feature files: every tile of every
    slide of a patient, in file order (reference data.py:532-655 with
    ``bag_size=None``)."""

    _: KW_ONLY
    bags: Sequence[Iterable[FeaturePath]]
    ground_truths: np.ndarray

    def __post_init__(self) -> None:
        if len(self.bags) != len(self.ground_truths):
            raise ValueError("the number of ground truths has to match the number of bags")

    def __len__(self) -> int:
        return len(self.bags)

    def __getitem__(self, index: int) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
        bag = [read_feats(bag_file) for bag_file in self.bags[index]]
        feats = np.concatenate([feats for feats, _ in bag])
        coords_um = np.concatenate([info.coords_um for _, info in bag])
        return feats, coords_um, len(feats), self.ground_truths[index]


def _stack_targets(targets: list[np.ndarray]) -> np.ndarray:
    fixed = []
    for et in targets:
        et = np.asarray(et)
        if et.ndim == 0:
            et = et.reshape(1)
        elif et.ndim > 1:
            et = et.reshape(-1)
        fixed.append(et)
    return np.stack(fixed)


class BatchIterator:
    """Yields ``(bags [B, T, F], coords [B, T, 2], bag_sizes [B], targets)``
    numpy batches of a :class:`BagDataset` in order; the last batch may be
    short.  Bags of one batch must have the same tile count (the deploy
    path uses batches of one)."""

    def __init__(self, dataset: BagDataset, *, batch_size: int) -> None:
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        for start in range(0, len(self.dataset), self.batch_size):
            items = [self.dataset[i] for i in range(start, min(start + self.batch_size, len(self.dataset)))]
            yield (
                np.stack([it[0] for it in items]),
                np.stack([it[1] for it in items]),
                np.array([it[2] for it in items], dtype=np.int32),
                _stack_targets([it[3] for it in items]),
            )


def create_dataset(
    *,
    feature_type: str,
    task: Task,
    patient_data: Sequence[PatientData],
    categories: Sequence[Category] | None = None,
) -> tuple[BagDataset, Sequence[Category]]:
    """The tile-level whole-slide dataset and its categories (reference
    data.py:321-421 for ``feature_type="tile"``, ``bag_size=None``)."""
    if feature_type != "tile":
        raise _not_ported(f"deployment on {feature_type}-level features")
    targets, cats = _parse_targets(patient_data=patient_data, task=task, categories=categories)
    ds = BagDataset(bags=[list(p.feature_files) for p in patient_data], ground_truths=targets)
    return ds, cats
