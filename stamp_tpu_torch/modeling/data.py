"""Data layer of the train, crossval and deploy paths.

Counterpart of ``stamp_tpu.modeling.data`` (``stamp_tpu/modeling/data.py:
77-1025``): clini/slide-table parsing with the same column, missing-value
and survival-status rules, single- and multi-target ground truths (a list
of labels: {target: value or None} per patient, one-hot per target with the
vocabulary of the observed values), the patient ↔ feature-file assembly
for tile-, slide- and patient-level features (``load_patient_data_``; a
patient-level cohort maps each clini-table patient to
``<feature_dir>/<patient>.h5`` without a slide table), the tile-level
``BagDataset`` (every tile of every slide of a patient, or a bag of
``bag_size`` tiles sampled with ``rng.permutation``, equidistant when
deterministic, zero-padded when short), the one-vector
``PatientFeatureDataset`` of slide and patient features, ``create_dataset``
and ``BatchIterator`` (epoch shuffling, per-item bag seeds drawn up front
for bags, a thread pool for ``num_workers > 1``).  Batches are numpy: tile
level ``(bags [B, T, F], coords [B, T, 2], bag_sizes [B], targets)``,
slide and patient level ``(feats [B, F], targets)``; multi-target targets
are {target: [B, C_t]}.

The random draws are the JAX package's, in its order, from the same
``Seed.numpy_rng()``: an iterator draws the epoch permutation (when it
shuffles), then one seed per item, and each item samples its bag from
``np.random.default_rng(seed)``; a dataset item fetched directly draws from
the shared generator.  So both packages sample the same bags from one seed.

Feature files are read by ``stamp_tpu_torch.io.h5`` (the port's own layout
without h5py, any other through h5py).  Not ported: file-like tables.
"""

from __future__ import annotations

import logging
from collections import deque
from collections.abc import Callable, Iterable, Iterator, Mapping, Sequence
from concurrent.futures import ThreadPoolExecutor
from dataclasses import KW_ONLY, dataclass
from pathlib import Path
from typing import Any, Generic, cast

import numpy as np
import pandas as pd

from stamp_tpu_torch.io.h5 import _read_feature_file, detect_feature_type, read_feats
from stamp_tpu_torch.types import (
    Category,
    FeaturePath,
    GroundTruthType,
    PandasLabel,
    PatientId,
    Task,
)
from stamp_tpu_torch.utils.seed import Seed

__all__ = [
    "PatientData",
    "BagDataset",
    "PatientFeatureDataset",
    "BatchIterator",
    "create_dataset",
    "load_patient_data_",
    "read_table",
    "filter_complete_patient_data_",
    "slide_to_patient_from_slide_table_",
]

_logger = logging.getLogger("stamp")


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
    ground_truth_label: PandasLabel | Sequence[PandasLabel],
) -> dict[PatientId, Any]:
    """Load patient → ground truth from a clini table: one column gives
    {patient: value}; a list of columns gives {patient: {column: value or
    None}} (multi-target), keeping patients with at least one target."""
    if isinstance(ground_truth_label, str):
        table = _read_table_columns(clini_table_path, [patient_label, ground_truth_label]).dropna(
            subset=[ground_truth_label]
        )
        series = table.set_index(patient_label)[ground_truth_label]
        if not series.index.is_unique:
            dupes = sorted(set(series.index[series.index.duplicated()]))
            raise ValueError(f"duplicate patients in clini table: {dupes}")
        return cast(dict[PatientId, Any], series.to_dict())

    targets = list(ground_truth_label)
    table = _read_table_columns(clini_table_path, [patient_label, *targets]).dropna(subset=targets, how="all")
    # NaN → None per cell; later rows win on a duplicated patient
    per_patient = table.set_index(patient_label)[targets]
    return {
        PatientId(str(pid)): {t: (None if pd.isna(v) else str(v)) for t, v in row.items()}
        for pid, row in per_patient.iterrows()
    }


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
    ``ground_truth_label``; a list of labels is classification only."""
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
    if not isinstance(ground_truth_label, str) and task != "classification":
        raise ValueError("Multi-target ground_truth_label is only supported for classification tasks")
    return patient_to_ground_truth_from_clini_table_(
        clini_table_path=clini_table,
        patient_label=patient_label,
        ground_truth_label=ground_truth_label,
    )


def load_patient_level_data(
    *,
    clini_table: Path,
    feature_dir: Path,
    task: Task | None,
    patient_label: PandasLabel,
    feature_ext: str = ".h5",
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None = None,
    status_label: PandasLabel | None = None,
    time_label: PandasLabel | None = None,
) -> dict[PatientId, PatientData]:
    """Patient-level features have no slide table: each clini-table patient
    maps to ``<feature_dir>/<patient>.h5`` (reference data.py:460-529)."""
    ground_truths = _clini_ground_truths(
        task=task,
        clini_table=clini_table,
        patient_label=patient_label,
        ground_truth_label=ground_truth_label,
        time_label=time_label,
        status_label=status_label,
    )
    located = {pid: feature_dir / f"{pid}{feature_ext}" for pid in ground_truths}
    if skipped := [pid for pid, path in located.items() if not path.exists()]:
        _logger.warning(f"Some patients have no feature file in {feature_dir}: {skipped}")
    return {
        pid: PatientData(ground_truth=ground_truths[pid], feature_files=[FeaturePath(path)])
        for pid, path in located.items()
        if path.exists()
    }


def load_patient_data_(
    *,
    clini_table: Path,
    slide_table: Path | None,
    feature_dir: Path,
    patient_label: PandasLabel,
    filename_label: PandasLabel,
    task: Task,
    ground_truth_label: PandasLabel | Sequence[PandasLabel] | None,
    time_label: PandasLabel | None,
    status_label: PandasLabel | None,
    drop_patients_with_missing_ground_truth: bool = True,
) -> tuple[Mapping[PatientId, PatientData], str]:
    """The training cohort: {patient: (ground truth, feature files)} and the
    feature level, detected from the h5 attributes (reference
    data.py:1204-1294)."""
    feature_type = detect_feature_type(feature_dir)
    if feature_type == "patient":
        patient_to_data = load_patient_level_data(
            task=task,
            clini_table=clini_table,
            feature_dir=feature_dir,
            patient_label=patient_label,
            ground_truth_label=ground_truth_label,
            time_label=time_label,
            status_label=status_label,
        )
        return patient_to_data, feature_type
    if feature_type not in ("tile", "slide"):
        raise RuntimeError(f"Unknown feature type: {feature_type}")
    if slide_table is None:
        raise ValueError("A slide table is required for tile/slide-level features")
    patient_to_data = filter_complete_patient_data_(
        patient_to_ground_truth=_clini_ground_truths(
            task=task,
            clini_table=clini_table,
            patient_label=patient_label,
            ground_truth_label=ground_truth_label,
            time_label=time_label,
            status_label=status_label,
        ),
        slide_to_patient=slide_to_patient_from_slide_table_(
            slide_table_path=slide_table,
            feature_dir=feature_dir,
            patient_label=patient_label,
            filename_label=filename_label,
        ),
        drop_patients_with_missing_ground_truth=drop_patients_with_missing_ground_truth,
    )
    return patient_to_data, feature_type


def log_patient_class_summary(*, patient_to_data: Mapping[PatientId, PatientData]) -> None:
    """Log the cohort's class distribution (reference data.py:1297-1339)."""
    from collections import Counter

    ground_truths = [gt for p in patient_to_data.values() if (gt := p.ground_truth) is not None]
    if not ground_truths:
        _logger.warning("No ground truths available for summary.")
        return
    if isinstance(ground_truths[0], dict):
        for name in sorted({name for gt in ground_truths for name in gt}):
            tally = Counter(gt.get(name) for gt in ground_truths)
            _logger.info(f"[Multi-target] Target '{name}' distribution: {dict(tally)}")
    else:
        _logger.info(f"Class distribution: {dict(Counter(ground_truths))}")


# ---------------------------------------------------------------------------
# Target encoding (reference data.py:146-252)
# ---------------------------------------------------------------------------


def _parse_targets(
    *,
    patient_data: Sequence[PatientData],
    task: Task,
    categories: Sequence[Category] | None = None,
) -> tuple[np.ndarray | list[dict[str, np.ndarray]], Sequence[Category] | Mapping[str, Sequence[Category]]]:
    """Raw ground truths → model-ready arrays (one-hot, scalar or
    (time, event); per target for multi-target) and the categories."""
    gts = [p.ground_truth for p in patient_data]

    if task == "classification":
        if any(isinstance(gt, dict) for gt in gts):
            return _encode_multi_target(gts)
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


def _encode_multi_target(gts: Sequence[dict | None]) -> tuple[list[dict[str, np.ndarray]], dict[str, list[str]]]:
    """Multi-target classification: per-target vocabularies of the observed
    values (sorted), a missing target an all-zero one-hot (no loss term)."""
    target_names = next(list(gt) for gt in gts if isinstance(gt, dict))
    vocab = {
        name: sorted({gt[name] for gt in gts if isinstance(gt, dict) and gt.get(name) is not None})
        for name in target_names
    }

    def one_hot(gt, name: str) -> np.ndarray:
        value = gt.get(name) if isinstance(gt, dict) else None
        return np.asarray([value == c for c in vocab[name]], dtype=np.float32)

    return [{name: one_hot(gt, name) for name in target_names} for gt in gts], vocab


# ---------------------------------------------------------------------------
# Datasets and batches
# ---------------------------------------------------------------------------


def _to_fixed_size_bag(
    bag: np.ndarray,
    coords: np.ndarray,
    bag_size: int,
    *,
    deterministic: bool,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray, int]:
    """A bag of ``bag_size`` tiles (reference data.py:811-862): a random
    subset (``rng.permutation``), equidistant indices when deterministic,
    and zero rows after the tiles of a smaller bag."""
    n_tiles = bag.shape[0]
    if n_tiles <= bag_size:
        bag_idxs = np.arange(n_tiles)
    elif deterministic:
        bag_idxs = np.round(np.linspace(0, n_tiles - 1, num=bag_size)).astype(np.int64)
    else:
        bag_idxs = rng.permutation(n_tiles)[:bag_size]

    bag_samples = bag[bag_idxs]
    coord_samples = coords[bag_idxs]
    if (pad := bag_size - bag_samples.shape[0]) > 0:
        bag_samples = np.concatenate([bag_samples, np.zeros((pad, bag_samples.shape[1]), dtype=bag.dtype)])
        coord_samples = np.concatenate([coord_samples, np.zeros((pad, coord_samples.shape[1]), dtype=coords.dtype)])
    return bag_samples, coord_samples, min(bag_size, n_tiles)


@dataclass
class BagDataset:
    """Bags from ``.h5`` feature files: every tile of every slide of a
    patient, in file order, or with ``bag_size`` a fixed-size sample of them
    (reference data.py:532-655)."""

    _: KW_ONLY
    bags: Sequence[Iterable[FeaturePath]]
    ground_truths: np.ndarray | list[dict[str, np.ndarray]]
    bag_size: int | None = None
    transform: Callable[[np.ndarray], np.ndarray] | None = None
    deterministic: bool = False

    def __post_init__(self) -> None:
        if len(self.bags) != len(self.ground_truths):
            raise ValueError("the number of ground truths has to match the number of bags")

    def __len__(self) -> int:
        return len(self.bags)

    def __getitem__(
        self, index: int, rng: np.random.Generator | None = None
    ) -> tuple[np.ndarray, np.ndarray, int, np.ndarray]:
        """``rng`` overrides the shared ``Seed.numpy_rng()`` for the bag
        draw (the iterator passes a per-item generator)."""
        bag = [read_feats(bag_file) for bag_file in self.bags[index]]
        feats = np.concatenate([feats for feats, _ in bag])
        coords_um = np.concatenate([info.coords_um for _, info in bag])
        if self.transform is not None:
            feats = self.transform(feats)
        if self.bag_size is None:
            return feats, coords_um, len(feats), self.ground_truths[index]
        bag_feats, bag_coords, size = _to_fixed_size_bag(
            feats,
            coords_um,
            self.bag_size,
            deterministic=self.deterministic,
            rng=rng if rng is not None else Seed.numpy_rng(),
        )
        return bag_feats, bag_coords, size, self.ground_truths[index]


class PatientFeatureDataset:
    """One feature vector per sample, from slide- or patient-level feature
    files (reference data.py:658-723)."""

    def __init__(
        self,
        feature_files: Sequence[FeaturePath],
        ground_truths: np.ndarray,
        transform: Callable[[np.ndarray], np.ndarray] | None = None,
    ) -> None:
        if len(feature_files) != len(ground_truths):
            raise ValueError("Number of feature files and ground truths must match.")
        self.feature_files = feature_files
        self.ground_truths = ground_truths
        self.transform = transform

    def __len__(self) -> int:
        return len(self.feature_files)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        feature_file = self.feature_files[idx]
        feats = _read_feature_file(Path(feature_file))[0]["feats"]
        if feats.ndim == 2 and feats.shape[0] == 1:
            feats = feats[0]
        elif feats.ndim != 1:
            raise RuntimeError(
                f"Expected single feature vector (shape [F] or [1, F]), got {feats.shape} in {feature_file}."
                "Check that the features are patient-level."
            )
        feats = feats.astype(np.float32)
        if self.transform is not None:
            feats = self.transform(feats)
        return feats, self.ground_truths[idx]


def _stack_targets(targets: list) -> np.ndarray | dict[str, np.ndarray]:
    if isinstance(targets[0], dict):
        return {k: np.stack([t[k] for t in targets]) for k in targets[0]}
    fixed = []
    for et in targets:
        et = np.asarray(et)
        if et.ndim == 0:
            et = et.reshape(1)
        elif et.ndim > 1:
            et = et.reshape(-1)
        fixed.append(et)
    return np.stack(fixed)


def _sliding_window_map(pool, fn, n: int, depth: int) -> Iterator:
    """``map(fn, range(n))`` over a thread pool with at most ``depth`` items
    in flight: ordered results, bounded memory."""
    pending: deque = deque(pool.submit(fn, j) for j in range(min(depth, n)))
    for j in range(n):
        result = pending.popleft().result()
        if (ahead := j + depth) < n:
            pending.append(pool.submit(fn, ahead))
        yield result


class BatchIterator:
    """Yields ``(bags [B, T, F], coords [B, T, 2], bag_sizes [B], targets)``
    numpy batches of a :class:`BagDataset` or ``(feats [B, F], targets)`` of
    a :class:`PatientFeatureDataset`; the last batch may be short unless
    ``drop_last``.  Bags of one batch must have the same tile count (fixed
    ``bag_size``, or batches of one).

    Each pass draws, from ``rng`` (``Seed.numpy_rng()`` by default), the
    epoch order when ``shuffle`` and then, for bags, one bag seed per item,
    before any item is read, so the sampled bags do not depend on
    ``num_workers``.
    ``num_workers > 1`` reads items on a thread pool (h5 reads and numpy
    release the GIL) with a bounded look-ahead."""

    def __init__(
        self,
        dataset: BagDataset | PatientFeatureDataset,
        *,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        rng: np.random.Generator | None = None,
        num_workers: int = 1,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = rng
        self.num_workers = max(1, num_workers)

    @property
    def rng(self) -> np.random.Generator:
        if self._rng is None:
            self._rng = Seed.numpy_rng()
        return self._rng

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            order = self.rng.permutation(order)
        dataset = self.dataset
        if isinstance(dataset, BagDataset):
            seeds = self.rng.integers(0, 2**63, size=len(order))

            def fetch(j: int):
                return dataset.__getitem__(int(order[j]), rng=np.random.default_rng(seeds[j]))
        else:

            def fetch(j: int):
                return dataset[int(order[j])]

        if self.num_workers > 1:
            with ThreadPoolExecutor(self.num_workers) as pool:
                yield from self._batched(_sliding_window_map(pool, fetch, len(order), self.num_workers * 4), len(order))
        else:
            yield from self._batched(map(fetch, range(len(order))), len(order))

    def _batched(self, items: Iterator, n_items: int) -> Iterator:
        for start in range(0, n_items, self.batch_size):
            count = min(self.batch_size, n_items - start)
            if self.drop_last and count < self.batch_size:
                return
            batch = [next(items) for _ in range(count)]
            if isinstance(self.dataset, BagDataset):
                yield (
                    np.stack([it[0] for it in batch]),
                    np.stack([it[1] for it in batch]),
                    np.array([it[2] for it in batch], dtype=np.int32),
                    _stack_targets([it[3] for it in batch]),
                )
            else:
                yield np.stack([it[0] for it in batch]), _stack_targets([it[1] for it in batch])


def create_dataset(
    *,
    feature_type: str,
    task: Task,
    patient_data: Sequence[PatientData],
    bag_size: int | None = None,
    shuffle: bool = False,
    transform: Callable[[np.ndarray], np.ndarray] | None = None,
    categories: Sequence[Category] | Mapping[str, Sequence[Category]] | None = None,
) -> tuple[BagDataset | PatientFeatureDataset, Sequence[Category] | Mapping[str, Sequence[Category]]]:
    """The dataset of ``feature_type`` and its categories (reference
    data.py:321-421): tile bags sampled at random when ``shuffle``,
    equidistantly otherwise; one vector per slide or patient.  A
    multi-target cohort's vocabularies come from its own ground truths
    (``categories`` as a mapping is ignored, as in the JAX package)."""
    if feature_type == "tile":
        targets, cats = _parse_targets(
            patient_data=patient_data, task=task, categories=None if isinstance(categories, Mapping) else categories
        )
        ds = BagDataset(
            bags=[list(p.feature_files) for p in patient_data],
            ground_truths=targets,
            bag_size=bag_size,
            transform=transform,
            deterministic=not shuffle,
        )
        return ds, cats
    if feature_type not in ("slide", "patient"):
        raise ValueError(f"Unknown feature type: {feature_type}")
    feature_files = [next(iter(p.feature_files)) for p in patient_data]
    gts = [p.ground_truth for p in patient_data]
    if task != "classification" and any(isinstance(gt, dict) for gt in gts):
        raise ValueError(f"Multi-target {task} is not supported; provide a single target per patient")
    if task == "classification":
        raw = np.array(gts)
        categories = categories or list(np.unique(raw))
        labels = (raw.reshape(-1, 1) == np.array(list(categories))).astype(np.float32)
    elif task == "regression":
        # NaN keeps the rows aligned with the feature files for missing targets
        labels = np.asarray([np.nan if gt is None else float(gt) for gt in gts], np.float32).reshape(-1, 1)
    elif task == "survival":
        labels = np.asarray([_lenient_survival_pair(gt) for gt in gts], np.float32)
    else:
        raise ValueError(f"Unsupported task: {task}")
    return PatientFeatureDataset(feature_files, labels, transform), categories or []


def _lenient_survival_pair(gt) -> tuple[float, float]:
    """A stored ground truth as (time, event) floats, NaN where a part is
    missing or unparseable: deploy cohorts may carry bare strings or no
    ground truth, so nothing raises here."""
    if isinstance(gt, (tuple, list)) and len(gt) == 2:
        time_raw, event_raw = gt
    elif gt is None:
        time_raw, event_raw = None, None
    else:  # a bare value is a time with unknown status
        time_raw, event_raw = str(gt), None
    try:
        time = float(time_raw) if time_raw is not None else np.nan
    except (TypeError, ValueError):
        time = np.nan
    try:
        event = float(_parse_survival_status(event_raw)) if event_raw is not None else np.nan
    except ValueError:
        event = np.nan
    return time, event
