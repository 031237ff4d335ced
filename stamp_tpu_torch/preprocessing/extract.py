"""Feature-extraction driver: slides → tiles → device batches → ``.h5``.

Counterpart of ``stamp_tpu.preprocessing.extract`` with the same contract:
shuffled slide worklist (several machines can share one output directory),
skip-if-h5-exists, per-slide fail-safe, fp16 features in the same ``.h5``
layout with the same attrs (``stamp_tpu_torch.io.h5``, which needs no
h5py), the rejection thumbnail, and a ``-{precision}`` dir suffix for
non-default precisions.
Tiling and slide reading are the port's copies of
``stamp_tpu/preprocessing/{tiling,wsi}.py``.

A producer thread tiles the slide into uint8 batches on a bounded queue
while the consumer runs the bf16 backbone on the device, so WSI decode,
host→device transfer and device compute overlap.

With ``macenko_normalization`` each uint8 batch is stain-normalized
(``ops.macenko``) on the extractor's device before the forward, as the JAX
package normalizes it on its device.

In a fleet (``parallel.distributed``: ``STAMP_COORDINATOR_ADDRESS``,
``STAMP_NUM_PROCESSES``, ``STAMP_PROCESS_ID``) each rank takes its
disjoint share of the worklist (``shard_worklist``, the JAX package's
shares, ``stamp_tpu/preprocessing/extract.py:317-333``) into the shared
output directory; skip-if-exists and atomic writes let a later run pick up
a crashed rank's share.

Difference from the JAX package's extraction: the artifact directory hash is that of
this package's sources, so its features never mix with the JAX package's
under skip-if-exists.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pandas as pd
import torch
from PIL import Image
from tqdm import tqdm

from stamp_tpu_torch.io.h5 import write_tile_feats_atomic
from stamp_tpu_torch.ops.macenko import macenko_normalize
from stamp_tpu_torch.parallel.distributed import init_distributed, process_count, process_index, shard_worklist
from stamp_tpu_torch.preprocessing.config import ExtractorName
from stamp_tpu_torch.preprocessing.extractor import Extractor
from stamp_tpu_torch.preprocessing.tiling import (
    MPPExtractionError,
    get_slide_mpp_,
    tiles_with_cache,
)
from stamp_tpu_torch.preprocessing.wsi import (
    UNSUPPORTED_CONTAINER_SUFFIXES,
    UnsupportedFormatError,
    open_slide,
)
from stamp_tpu_torch.types import ImageExtension, Microns, SlideMPP, SlidePixels, TilePixels
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.cache import get_processing_code_hash
from stamp_tpu_torch.utils.device import resolve_device

__all__ = ["extract_", "supported_extensions"]

Image.MAX_IMAGE_PIXELS = None

supported_extensions = {
    ".czi", ".svs", ".tif", ".vms", ".vmu", ".ndpi", ".scn", ".mrxs",
    ".tiff", ".svslide", ".bif", ".qptiff",
}  # fmt: skip

_logger = logging.getLogger("stamp")

# device batch of the extraction pipeline; the extractor pads a slide's last
# partial batch up to it (extractor.batch_floor)
_BATCH_SIZE = int(os.environ.get("STAMP_EXTRACT_BATCH", "64"))
_QUEUE_DEPTH = 4


def _slides_named_in(wsi_list: Path) -> set[str]:
    """Slide filenames from the first column of a .txt/.csv/.xls(x) worklist
    file; ``.txt`` is one verbatim filename per line."""
    suffix = wsi_list.suffix.lower()
    if suffix == ".txt":
        lines = (line.strip() for line in wsi_list.read_text().splitlines())
        return {line for line in lines if line}

    loaders = {
        ".csv": lambda p: pd.read_csv(p, header=None),
        ".xls": lambda p: pd.read_excel(p, header=None),
        ".xlsx": lambda p: pd.read_excel(p, header=None),
    }
    loader = loaders.get(suffix)
    if loader is None:
        raise ValueError(f"Unsupported file type: {suffix}")
    try:
        table = loader(wsi_list)
    except pd.errors.EmptyDataError:
        return set()
    first_column = table.iloc[:, 0].astype(str).str.strip()
    return set(first_column[first_column != ""])


def _build_worklist(wsi_dir: Path, wsi_list: Path | None) -> list[Path]:
    """Assemble + shuffle the slide worklist; slides in containers the
    reader does not implement are dropped with a named error."""
    if wsi_list is not None:
        candidates = [wsi_dir / name for name in _slides_named_in(wsi_list)]
    else:
        candidates = [
            p for ext in supported_extensions for p in wsi_dir.glob(f"**/*{ext}")
        ]

    readable = [
        p for p in candidates if p.suffix.lower() not in UNSUPPORTED_CONTAINER_SUFFIXES
    ]
    if dropped := sorted(set(candidates) - set(readable)):
        _logger.error(
            f"skipping {len(dropped)} slide(s) in unsupported container "
            f"formats {sorted({p.suffix.lower() for p in dropped})}: "
            f"{[p.name for p in dropped]} — convert to pyramidal "
            "TIFF/SVS or extract them with the reference pipeline."
        )
        if not readable:
            raise UnsupportedFormatError(
                f"every slide found in {wsi_dir} is in an unsupported container format"
            )
    if not readable:
        raise FileNotFoundError(
            f"no slides found in {wsi_dir}"
            + (" (or the wsi_list matched nothing)" if wsi_list else "")
        )

    rng = np.random.default_rng()  # deliberately unseeded: system entropy
    return [readable[i] for i in rng.permutation(len(readable))]


@dataclass(frozen=True)
class _TilingParams:
    """Host-side tiling knobs."""

    cache_dir: Path | None
    cache_tiles_ext: ImageExtension
    tile_size_um: Microns
    tile_size_px: TilePixels
    max_workers: int
    brightness_cutoff: int | None
    canny_cutoff: float | None
    default_slide_mpp: SlideMPP | None


def _batched_tiles(slide_path: Path, extractor: Extractor, p: _TilingParams):
    """Producer thread fills a bounded queue of (uint8 batch, coords) pairs."""
    q: queue.Queue = queue.Queue(maxsize=_QUEUE_DEPTH)
    sentinel = object()
    error: list[BaseException] = []

    def timed(iterator, name: str):
        """Attribute the generator's own time (tile decode/filter) to a stage."""
        iterator = iter(iterator)
        while True:
            with profiling.stage(name):
                try:
                    item = next(iterator)
                except StopIteration:
                    return
            yield item

    def producer() -> None:
        try:
            images: list[np.ndarray] = []
            coords: list[tuple[float, float]] = []
            for tile in timed(tiles_with_cache(
                slide_path,
                cache_dir=p.cache_dir,
                cache_tiles_ext=p.cache_tiles_ext,
                tile_size_um=p.tile_size_um,
                tile_size_px=p.tile_size_px,
                max_supertile_size_slide_px=SlidePixels(2**10),
                max_workers=p.max_workers,
                brightness_cutoff=p.brightness_cutoff,
                canny_cutoff=p.canny_cutoff,
                default_slide_mpp=p.default_slide_mpp,
            ), "preprocess/tiling"):
                with profiling.stage("preprocess/host_transform"):
                    images.append(extractor.transform_host(tile.image))
                coords.append((float(tile.coordinates.x), float(tile.coordinates.y)))
                if len(images) == _BATCH_SIZE:
                    q.put((np.stack(images), np.array(coords, dtype=np.float32)))
                    images, coords = [], []
            if images:
                q.put((np.stack(images), np.array(coords, dtype=np.float32)))
        except BaseException as e:  # noqa: BLE001 — reraised on the consumer side
            error.append(e)
        finally:
            q.put(sentinel)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    while (item := q.get()) is not sentinel:
        yield item
    thread.join()
    if error:
        raise error[0]


def _extract_slide(
    slide_path: Path, extractor: Extractor, tiling: _TilingParams, macenko_device: torch.device | None
) -> tuple[np.ndarray, np.ndarray] | None:
    """Run one slide through the tiling → device pipeline.

    Returns (fp16 feats, µm coords), or None when the slide yields no
    tiles.  Raises on decode/MPP failures — the caller owns the per-slide
    fail-safe.
    """
    if get_slide_mpp_(open_slide(slide_path), default_mpp=tiling.default_slide_mpp) is None:
        raise MPPExtractionError()

    feat_batches: list[torch.Tensor] = []
    coord_batches: list[np.ndarray] = []
    for batch, coords in _batched_tiles(slide_path, extractor, tiling):
        if macenko_device is not None:
            with profiling.stage("preprocess/macenko"):
                # the normalized batch stays on the device for the forward;
                # profiling syncs here to attribute the time to this stage
                batch = macenko_normalize(torch.from_numpy(batch).to(macenko_device))
                if profiling.timer.enabled and batch.is_cuda:
                    torch.cuda.synchronize(batch.device)
        # device tensors accumulate without a sync — the next batch's
        # transfer and compute queue behind this one
        with profiling.stage("preprocess/device_forward"):
            feats = extractor.forward(batch)
            if profiling.timer.enabled:
                # attribute the device wait here rather than at the h5 write
                feats = feats.cpu()
        feat_batches.append(feats)
        coord_batches.append(coords)

    if not feat_batches:
        return None
    fp16 = np.concatenate([f.cpu().numpy().astype(np.float16) for f in feat_batches])
    return fp16, np.concatenate(coord_batches)


def extract_(
    *,
    wsi_dir: Path,
    wsi_list: Path | None,
    output_dir: Path,
    generate_hash: bool = True,
    extractor: ExtractorName | Extractor,
    extractor_precision: str | None = None,
    tile_size_px: TilePixels,
    tile_size_um: Microns,
    default_slide_mpp: SlideMPP | None = None,
    brightness_cutoff: int | None = 240,
    canny_cutoff: float | None = 0.02,
    macenko_normalization: bool = False,
    cache_dir: Path | None,
    cache_tiles_ext: ImageExtension,
    max_workers: int,
    device: str | torch.device = "auto",
) -> None:
    """Extracts features from slides, fail-safe per slide.

    ``extractor_precision`` None defers to the STAMP_INT8_EXTRACTION env
    var; "int8" (from either) runs the ViT extractor as W8A8, into a
    ``-int8`` artifact directory with a ``precision`` attribute.
    """
    from stamp_tpu_torch.preprocessing.extractor import set_int8_extraction
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    device = resolve_device(device)
    if extractor_precision is not None:
        _logger.info(f"extractor precision pinned by config: {extractor_precision}")
        set_int8_extraction(extractor_precision == "int8")
    try:
        extractor = resolve_extractor(extractor, device)
    finally:
        set_int8_extraction(None)
    code_hash = get_processing_code_hash(Path(__file__))[:8]
    extractor_id = extractor.identifier
    actual_precision = extractor.precision
    _logger.info(f"Using extractor {extractor_id} ({actual_precision})")

    if cache_dir:
        cache_dir.mkdir(parents=True, exist_ok=True)

    # non-default precisions get their own artifact directory so a resumed
    # run can never silently mix numeric modes via skip-if-exists
    dir_id = extractor_id + (f"-{actual_precision}" if actual_precision != "bfloat16" else "")
    feat_output_dir = output_dir / (f"{dir_id}-{code_hash}" if generate_hash else dir_id)

    worklist = _build_worklist(wsi_dir, wsi_list)
    # an extraction fleet: each rank takes its disjoint share (slides never
    # span ranks, so no collective runs)
    init_distributed(use_cuda=device.type == "cuda")
    if process_count() > 1:
        worklist = shard_worklist(worklist)
        _logger.info(f"extraction fleet: process {process_index()}/{process_count()} takes {len(worklist)} slides")
    output_dir.mkdir(parents=True, exist_ok=True)
    tiling = _TilingParams(
        cache_dir=cache_dir,
        cache_tiles_ext=cache_tiles_ext,
        tile_size_um=tile_size_um,
        tile_size_px=tile_size_px,
        max_workers=max_workers,
        brightness_cutoff=brightness_cutoff,
        canny_cutoff=canny_cutoff,
        default_slide_mpp=default_slide_mpp,
    )

    n_handled = 0  # slides that produced output or were legitimately skipped
    n_unsupported = 0
    for slide_path in (progress := tqdm(worklist)):
        rel = slide_path.relative_to(wsi_dir)
        progress.set_description(str(rel))
        _logger.debug(f"processing {slide_path}")

        feature_output_path = (feat_output_dir / rel).with_suffix(".h5")
        if feature_output_path.exists():
            _logger.debug(f"skipping {slide_path} because {feature_output_path} already exists")
            n_handled += 1
            continue

        try:
            extracted = _extract_slide(slide_path, extractor, tiling, device if macenko_normalization else None)
        except MPPExtractionError:
            _logger.exception(
                "failed to extract MPP from slide. You can try manually setting "
                "it by adding `preprocessing.default_slide_mpp = <MPP>` "
            )
            continue
        except UnsupportedFormatError as e:
            n_unsupported += 1
            _logger.error(
                f"skipping {slide_path.name}: unsupported container ({e}) — "
                "convert to pyramidal TIFF/SVS or extract it with the "
                "reference pipeline."
            )
            continue
        except Exception:
            _logger.exception(f"error while extracting features from {slide_path}")
            continue
        n_handled += 1

        if extracted is None:
            _logger.info(f"no tiles found in {slide_path}, skipping")
            continue
        feats, coords = extracted

        try:
            with profiling.stage("preprocess/h5_write"):
                write_tile_feats_atomic(
                    output_path=feature_output_path,
                    feats=feats,
                    coords_um=coords,
                    extractor_id=str(extractor_id),
                    tile_size_um=tile_size_um,
                    tile_size_px=tile_size_px,
                    code_hash=code_hash,
                    precision=actual_precision if actual_precision != "bfloat16" else None,
                )
        except Exception:
            _logger.exception(f"error while writing {feature_output_path}")
            continue
        _logger.debug(f"saved features to {feature_output_path}")

        _write_rejection_thumb(
            slide_path,
            thumb_path=(feat_output_dir / rel).with_suffix(".jpg"),
            coords_um=coords,
            tile_size_um=tile_size_um,
            default_slide_mpp=default_slide_mpp,
        )

    if n_unsupported and not n_handled:
        raise UnsupportedFormatError(
            f"every slide found in {wsi_dir} is in an unsupported container format"
        )


def _write_rejection_thumb(
    slide_path: Path,
    *,
    thumb_path: Path,
    coords_um: np.ndarray,
    tile_size_um: Microns,
    default_slide_mpp: SlideMPP | None,
) -> None:
    """Save a slide thumbnail with every *rejected* tile region tinted red."""
    slide = open_slide(slide_path)
    mpp = get_slide_mpp_(slide, default_mpp=default_slide_mpp)

    # grid of tile cells covering the slide; mark the kept ones
    grid_extent = np.ceil(
        np.asarray(slide.dimensions, np.float64) * mpp / tile_size_um
    ).astype(np.int64)
    kept = np.zeros((grid_extent[1], grid_extent[0]), dtype=bool)  # [gy, gx]
    cells = np.floor(coords_um / tile_size_um).astype(np.int64)
    cells = cells[(cells >= 0).all(axis=1) & (cells < grid_extent).all(axis=1)]
    kept[cells[:, 1], cells[:, 0]] = True

    # paint rejected cells as a translucent red RGBA layer over the thumb
    overlay_px = np.zeros((*kept.shape, 4), dtype=np.uint8)
    overlay_px[~kept] = (255, 0, 0, 128)
    thumb = slide.get_thumbnail((512, 512)).convert("RGBA")
    overlay = Image.fromarray(overlay_px).resize(thumb.size, resample=Image.Resampling.NEAREST)
    thumb.paste(overlay, mask=overlay)

    thumb_path.parent.mkdir(exist_ok=True, parents=True)
    thumb.convert("RGB").save(thumb_path)
