"""Slide/patient encoder abstraction, in PyTorch.

Copy of ``stamp_tpu/encoding/encoder/__init__.py:42-270``: skip-if-exists
idempotency, hash-named output directories, validation of the required tile
extractor (with hash-suffix stripping), and atomic h5 writes carrying
{encoder, precision, feat_type} attrs.  Slide- and patient-mode encoding are
one worklist of ``_EncodeJob``s drained by ``_run_jobs``; subclasses provide
the embedding functions, and may pass ``_run_jobs`` a reader of their own
(EAGLE's paired feature directories).  ``forward_on`` runs a model on the
requested device under ``torch.inference_mode`` and returns f32 numpy.

What differs: the tile-feature files are read with the port's reader
(``io.h5``: its own layout without h5py, any other through h5py imported
inside the reader) and written with the port's writer, and the output
directory's code hash is that of the port's encoder sources, so its
``<encoder>-slide-<hash8>`` names differ from the JAX package's.  With
``--profile`` the stages ``encode/read``, ``encode/forward`` and
``encode/h5_write`` are timed.
"""

from __future__ import annotations

import logging
import os
import re
from abc import ABC, abstractmethod
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterable

import numpy as np
import torch
from torch import nn
from tqdm import tqdm

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.io.h5 import CoordsInfo, _read_feature_file, get_coords, write_pooled_feats_atomic
from stamp_tpu_torch.modeling.data import read_table
from stamp_tpu_torch.preprocessing.config import ExtractorName
from stamp_tpu_torch.types import PandasLabel
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.cache import get_processing_code_hash
from stamp_tpu_torch.utils.device import resolve_device

_logger = logging.getLogger("stamp")

_HASH_SUFFIX = re.compile(r"^[0-9a-fA-F]{6,}$")


def _resolve_extractor_name(name: str) -> str:
    """Strip a trailing code-hash suffix from an extractor id."""
    if not name:
        raise ValueError("Empty extractor name")
    name = str(name).strip()
    base, dash, suffix = name.rpartition("-")
    if dash and _HASH_SUFFIX.match(suffix):
        return base
    return name


def forward_on(model: nn.Module, device, *inputs: np.ndarray) -> np.ndarray:
    """``model(*inputs)`` on ``resolve_device(device)`` (the model moved
    there), under ``torch.inference_mode``, as f32 numpy."""
    dev = resolve_device(device)
    model.to(dev)
    with torch.inference_mode():
        out = model(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in inputs))
    return out.float().cpu().numpy()


@dataclass(frozen=True)
class _EncodeJob:
    """One unit of encoding work: n input h5 files → one output h5."""

    description: str  # progress-bar label (slide stem / patient id)
    output_path: Path
    input_h5s: tuple[Path, ...]


class Encoder(ABC):
    def __init__(
        self,
        *,
        identifier: EncoderName,
        precision: str,
        required_extractors: list[ExtractorName],
    ):
        self.identifier = identifier
        self.precision = precision
        self.required_extractors = required_extractors
        # precision attrs observed on the input tile h5s (int8 provenance)
        self._source_precisions: set[str] = set()

    # -- public entry points -------------------------------------------------

    def encode_slides_(
        self,
        *,
        output_dir: Path,
        feat_dir: Path,
        device: str = "auto",
        generate_hash: bool = True,
        **kwargs,
    ) -> None:
        """Encode every tile-feature h5 under ``feat_dir`` into one
        slide-level feature file."""
        encode_dir = self._make_output_dir(output_dir, "slide", generate_hash)

        def jobs() -> Iterable[_EncodeJob]:
            for h5_path in sorted(feat_dir.rglob("*.h5")):
                out = (encode_dir / h5_path.relative_to(feat_dir)).with_suffix(".h5")
                yield _EncodeJob(h5_path.stem, out, (h5_path,))

        def embed(feats_list: list[np.ndarray], coords_list: list[CoordsInfo]) -> np.ndarray:
            return self._generate_slide_embedding(feats_list[0], device, coords=coords_list[0])

        self._run_jobs(list(jobs()), embed, feat_type="slide")

    def encode_patients_(
        self,
        *,
        output_dir: Path,
        feat_dir: Path,
        slide_table_path: Path,
        patient_label: PandasLabel,
        filename_label: PandasLabel,
        device: str = "auto",
        generate_hash: bool = True,
        **kwargs,
    ) -> None:
        """Encode all of a patient's slides into one patient-level feature."""
        encode_dir = self._make_output_dir(output_dir, "pat", generate_hash)

        slide_table = read_table(slide_table_path)
        jobs = [
            _EncodeJob(
                str(patient_id),
                (encode_dir / str(patient_id)).with_suffix(".h5"),
                tuple(Path(feat_dir) / filename for filename in group[filename_label]),
            )
            for patient_id, group in slide_table.groupby(patient_label)
        ]

        def embed(feats_list: list[np.ndarray], coords_list: list[CoordsInfo]) -> np.ndarray:
            return self._generate_patient_embedding(feats_list, device, **kwargs)

        self._run_jobs(jobs, embed, feat_type="patient")

    # -- the shared worklist loop --------------------------------------------

    def _run_jobs(
        self,
        jobs: list[_EncodeJob],
        embed: Callable[[list, list[CoordsInfo]], np.ndarray],
        *,
        feat_type: str,
        read: Callable[[Path], tuple] | None = None,
    ) -> None:
        """Drain the worklist: read each job's input files, embed them,
        write the result.  ``read`` maps one input h5 path to a (features,
        coords) pair; the default reads and validates a single tile-feature
        file, and an encoder with richer inputs (EAGLE's paired feature
        directories) passes its own."""
        if read is None:
            read = lambda p: self._validate_and_read_features(str(p))  # noqa: E731
        progress = tqdm(jobs)
        for job in progress:
            progress.set_description(job.description)
            self._source_precisions.clear()  # provenance is per output file
            if job.output_path.exists():
                _logger.info(f"skipping {job.description} because {job.output_path} already exists")
                continue

            feats_list: list = []
            coords_list: list[CoordsInfo] = []
            for h5_path in job.input_h5s:
                try:
                    with profiling.stage("encode/read"):
                        feats, coords = read(h5_path)
                except (FileNotFoundError, ValueError, OSError) as e:
                    tqdm.write(f"Skipping {h5_path.name}: {e}")
                    continue
                feats_list.append(feats)
                coords_list.append(coords)

            if not feats_list:
                tqdm.write(f"No usable features for {job.description}, skipping.")
                continue

            with profiling.stage("encode/forward"):  # ends in a copy to the host
                feats = embed(feats_list, coords_list)
            self._save_features_(output_path=job.output_path, feats=feats, feat_type=feat_type)

    # -- subclass contract ---------------------------------------------------

    @abstractmethod
    def _generate_slide_embedding(self, feats: np.ndarray, device, **kwargs) -> np.ndarray: ...

    @abstractmethod
    def _generate_patient_embedding(self, feats_list: list, device, **kwargs) -> np.ndarray: ...

    # -- shared building blocks ----------------------------------------------

    def _make_output_dir(self, output_dir: Path, kind: str, generate_hash: bool) -> Path:
        """``<output_dir>/<encoder>-<kind>[-<codehash8>]``, created."""
        name = f"{self.identifier}-{kind}"
        if generate_hash:
            name += f"-{get_processing_code_hash(Path(__file__))[:8]}"
        encode_dir = output_dir / name
        os.makedirs(encode_dir, exist_ok=True)
        return encode_dir

    def _validate_and_read_features(self, h5_path: str) -> tuple[np.ndarray, CoordsInfo]:
        feats, coords, extractor = self._read_h5(h5_path)
        accepted = {str(e) for e in self.required_extractors}
        if extractor not in accepted:
            raise ValueError(
                f"Features must be extracted with one of "
                f"{self.required_extractors}. Features located in {h5_path} "
                f"are extracted with {extractor}"
            )
        return feats, coords

    def _read_h5(self, h5_path: str) -> tuple[np.ndarray, CoordsInfo, str]:
        path = Path(h5_path)
        if not path.exists():
            raise FileNotFoundError(f"File does not exist: {h5_path}")
        if path.suffix != ".h5":
            raise ValueError(f"File is not of type .h5: {path.name}")
        datasets, attrs = _read_feature_file(path)
        extractor = str(attrs.get("extractor", ""))
        if not extractor:
            raise ValueError(f"Feature file does not have extractor's name in the metadata: {path.name}")
        # non-default numeric modes of the *extraction* stage (int8) must
        # survive into the encoded output's provenance attrs
        if source_precision := attrs.get("precision"):
            self._source_precisions.add(str(source_precision))
        return (
            np.asarray(datasets["feats"]).astype(np.float32),
            get_coords(datasets, attrs, path),
            _resolve_extractor_name(extractor),
        )

    def _save_features_(self, *, output_path: Path, feats: np.ndarray, feat_type: str) -> None:
        with profiling.stage("encode/h5_write"):
            write_pooled_feats_atomic(
                output_path=output_path,
                feats=feats,
                encoder_id=str(self.identifier),
                precision=self.precision,
                feat_type=feat_type,
                code_hash=get_processing_code_hash(Path(__file__))[:8],
                source_precision=(",".join(sorted(self._source_precisions)) if self._source_precisions else None),
            )
        _logger.debug(f"saved features to {output_path}")
