"""Virtual-slide patient encoding for coordinate-aware slide encoders.

Copy of ``stamp_tpu/encoding/encoder/_virtual_slide.py:29-126``: TITAN
consumes tile coordinates, so a patient's slides are laid side by side along
the x axis, each slide's coordinates offset by the cumulative width of its
predecessors, and encoded as one slide.  All slides of a patient must share
one mpp.
"""

from __future__ import annotations

import logging
import math
import os
from pathlib import Path

import numpy as np
from tqdm import tqdm

from stamp_tpu_torch.io.h5 import CoordsInfo
from stamp_tpu_torch.modeling.data import read_table
from stamp_tpu_torch.types import PandasLabel
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.cache import get_processing_code_hash

_logger = logging.getLogger("stamp")


class VirtualSlidePatientMixin:
    """Patient encoding = slide encoding of one x-concatenated virtual slide."""

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
        if generate_hash:
            encode_dir_name = f"{self.identifier}-pat-{get_processing_code_hash(Path(__file__))[:8]}"
        else:
            encode_dir_name = f"{self.identifier}-pat"
        encode_dir = output_dir / encode_dir_name
        os.makedirs(encode_dir, exist_ok=True)

        slide_table = read_table(slide_table_path)
        for patient_id, group in (progress := tqdm(slide_table.groupby(patient_label))):
            progress.set_description(str(patient_id))

            output_path = (encode_dir / str(patient_id)).with_suffix(".h5")
            self._source_precisions.clear()  # provenance is per output file
            if output_path.exists():
                _logger.info(f"skipping {patient_id} because {output_path} already exists")
                continue

            with profiling.stage("encode/read"):
                virtual = self._assemble_virtual_slide(feat_dir, group[filename_label], patient_id=str(patient_id))
            if virtual is None:
                continue
            feats, coords = virtual

            with profiling.stage("encode/forward"):
                patient_embedding = self._generate_slide_embedding(feats, device, coords=coords)
            self._save_features_(output_path=output_path, feats=patient_embedding, feat_type="patient")

    def _assemble_virtual_slide(
        self, feat_dir: Path, filenames, *, patient_id: str
    ) -> tuple[np.ndarray, CoordsInfo] | None:
        """Concatenate a patient's slides along x with cumulative offsets."""
        feats_parts: list[np.ndarray] = []
        coords_parts: list[np.ndarray] = []
        x_offset = 0.0
        mpp: float | None = None
        tile_size_um = None
        tile_size_px = None

        for slide_filename in filenames:
            h5_path = os.path.join(feat_dir, str(slide_filename))
            if not h5_path.endswith(".h5"):
                tqdm.write(f"Skipping {slide_filename} (not an .h5 file)")
                continue
            try:
                feats, coords = self._validate_and_read_features(h5_path)
            except (FileNotFoundError, ValueError, OSError) as e:
                tqdm.write(f"Skipping {slide_filename}: {e}")
                continue

            if mpp is None:
                mpp = coords.mpp
                tile_size_um = coords.tile_size_um
                tile_size_px = coords.tile_size_px
            elif not math.isclose(mpp, coords.mpp, rel_tol=1e-5):
                raise ValueError(
                    "All patient slides must have the same mpp value. "
                    "Try reprocessing the slides using the same tile_size_um "
                    "and tile_size_px values for all of them."
                )

            shifted = coords.coords_um.copy()
            shifted[:, 0] += x_offset
            x_offset = float(shifted[:, 0].max()) + float(coords.tile_size_um)

            feats_parts.append(feats)
            coords_parts.append(shifted)

        if not feats_parts:
            tqdm.write(f"No features found for patient {patient_id}, skipping.")
            return None

        virtual_coords = CoordsInfo(np.concatenate(coords_parts, axis=0), tile_size_um, tile_size_px)
        return np.concatenate(feats_parts, axis=0), virtual_coords
