"""EAGLE slide encoder, in PyTorch.

Counterpart of ``stamp_tpu/encoding/encoder/eagle.py:1-212``: CHIEF's gated
attention (``encoding.encoder.chief``, on ``resolve_device(device)``)
scores a slide's CTransPath tiles, the 25 highest-scoring tiles are taken
by ``np.argpartition`` on the host, and the Virchow2 features of those
tiles (from ``agg_feat_dir``, the same relative path) are averaged into the
slide embedding.  The two feature sets come from separate extraction runs,
so their tile order may differ: the Virchow2 rows are re-paired by µm
coordinate (``_repair_row_order``), and a different tile set raises.  Both
encoding modes run through the base class's ``_run_jobs`` with a paired
reader.

Near-ties: the card's scores differ from the CPU's by rounding, so where
the 25th and 26th scores lie closer than that, the two can keep different
tiles.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from stamp_tpu_torch.encoding.config import EncoderName
from stamp_tpu_torch.encoding.encoder import Encoder, _EncodeJob
from stamp_tpu_torch.encoding.encoder.chief import load_chief_attention_net
from stamp_tpu_torch.io.h5 import CoordsInfo
from stamp_tpu_torch.modeling.data import read_table
from stamp_tpu_torch.preprocessing.config import ExtractorName
from stamp_tpu_torch.types import PandasLabel

_TOP_K = 25  # tiles kept a slide


def _repair_row_order(ref_um: np.ndarray, other_um: np.ndarray, other_feats: np.ndarray, context: str) -> np.ndarray:
    """``other_feats`` reordered so that row i lies at the µm coordinate of
    row i of the reference set.  Coordinates are rounded to 5 decimals and
    matched exactly; the two multisets must be equal, and duplicated
    coordinates pair up in order within their group."""
    ref = np.round(np.asarray(ref_um, np.float64), 5)
    oth = np.round(np.asarray(other_um, np.float64), 5)
    if ref.shape == oth.shape and np.array_equal(ref, oth):
        return other_feats
    by_ref = np.lexsort(ref.T)
    by_oth = np.lexsort(oth.T)
    if ref.shape != oth.shape or not np.array_equal(ref[by_ref], oth[by_oth]):
        raise ValueError(
            f"Coordinates mismatch between ctranspath and virchow2 features "
            f"for slide {context}: the tile sets differ, not just their order."
        )
    # by_oth[j] is the partner of by_ref[j]; invert to the reference row order
    perm = np.empty(len(ref), dtype=np.int64)
    perm[by_ref] = by_oth
    return other_feats[perm]


class Eagle(Encoder):
    def __init__(self) -> None:
        self.net = load_chief_attention_net()
        self.required_agg_extractor = ExtractorName.VIRCHOW2
        super().__init__(
            identifier=EncoderName.EAGLE,
            precision="torch.float32",
            required_extractors=[ExtractorName.CTRANSPATH, ExtractorName.CHIEF_CTRANSPATH],
        )

    def top_tiles(self, ctp_feats: np.ndarray, device) -> np.ndarray:
        """The indices of the (at most) 25 tiles of highest CHIEF score."""
        scores, _ = self.net.scores_and_feature(ctp_feats, device)
        k = min(_TOP_K, scores.shape[0])
        return np.argpartition(scores, -k)[-k:]

    def _eagle_embedding(self, ctp_feats: np.ndarray, vir2_feats: np.ndarray, device) -> np.ndarray:
        return vir2_feats[self.top_tiles(ctp_feats, device)].mean(axis=0).astype(np.float32)

    def _generate_slide_embedding(self, feats, device, agg_feats=None, **kwargs) -> np.ndarray:
        if agg_feats is None:
            raise ValueError("agg_feats is required for slide embedding")
        return self._eagle_embedding(feats, agg_feats, device)

    def _generate_patient_embedding(self, feats_list, device, agg_feats_list=None, **kwargs) -> np.ndarray:
        if agg_feats_list is None:
            raise ValueError("agg_feats_list is required for patient embedding")
        return self._eagle_embedding(
            np.concatenate(feats_list, axis=0), np.concatenate(agg_feats_list, axis=0), device
        )

    def _paired_reader(self, feat_dir: Path, agg_feat_dir: Path):
        """A reader for ``_run_jobs``: a CTransPath h5 path → the validated
        (CTransPath, Virchow2) feature pair, the Virchow2 rows re-paired by
        µm coordinate, and the CTransPath coordinates."""

        def read(h5_ctp: Path) -> tuple[tuple[np.ndarray, np.ndarray], CoordsInfo]:
            ctp_feats, coords = self._validate_and_read_features(str(h5_ctp))
            vir2_path = Path(agg_feat_dir) / Path(h5_ctp).relative_to(feat_dir)
            vir2_feats, vir2_coords, vir2_extractor = self._read_h5(str(vir2_path))
            if vir2_extractor != str(self.required_agg_extractor):
                raise ValueError(
                    f"Aggregated features must be extracted with "
                    f"{self.required_agg_extractor}; {vir2_path} was extracted "
                    f"with {vir2_extractor}"
                )
            vir2_feats = _repair_row_order(coords.coords_um, vir2_coords.coords_um, vir2_feats, Path(h5_ctp).stem)
            return (ctp_feats, vir2_feats), coords

        return read

    @staticmethod
    def _agg_dir_from(kwargs) -> Path:
        agg_feat_dir = kwargs.get("agg_feat_dir")
        if not agg_feat_dir:
            raise ValueError("agg_feat_dir that contains virchow2 features is required for Eagle")
        return Path(agg_feat_dir)

    def encode_slides_(
        self, *, output_dir: Path, feat_dir: Path, device: str = "auto", generate_hash: bool = True, **kwargs
    ) -> None:
        agg_feat_dir = self._agg_dir_from(kwargs)
        encode_dir = self._make_output_dir(output_dir, "slide", generate_hash)
        jobs = [
            _EncodeJob(h5_path.stem, (encode_dir / h5_path.relative_to(feat_dir)).with_suffix(".h5"), (h5_path,))
            for h5_path in sorted(feat_dir.rglob("*.h5"))
        ]

        def embed(pairs: list, coords_list) -> np.ndarray:
            ctp_feats, vir2_feats = pairs[0]
            return self._eagle_embedding(ctp_feats, vir2_feats, device)

        self._run_jobs(jobs, embed, feat_type="slide", read=self._paired_reader(feat_dir, agg_feat_dir))

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
        agg_feat_dir = self._agg_dir_from(kwargs)
        encode_dir = self._make_output_dir(output_dir, "pat", generate_hash)
        slide_table = read_table(slide_table_path)
        jobs = [
            _EncodeJob(
                str(patient_id),
                (encode_dir / str(patient_id)).with_suffix(".h5"),
                tuple(Path(feat_dir) / fname for fname in group[filename_label]),
            )
            for patient_id, group in slide_table.groupby(patient_label)
        ]

        def embed(pairs: list, coords_list) -> np.ndarray:
            return self._eagle_embedding(
                np.concatenate([ctp for ctp, _ in pairs], axis=0),
                np.concatenate([vir2 for _, vir2 in pairs], axis=0),
                device,
            )

        self._run_jobs(jobs, embed, feat_type="patient", read=self._paired_reader(feat_dir, agg_feat_dir))
