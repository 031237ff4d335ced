"""Tiling engine: foreground grid, supertile reads, texture rejection, cache.

Copy of ``stamp_tpu/preprocessing/tiling.py``, kept in the port so that it
imports nothing of the JAX package; its tile-cache keys hash this file, so
they differ from the JAX package's.

Behavioral parity with reference src/stamp/preprocessing/tiling.py (the
contract, pinned by tests/test_preprocessing.py): MPP extraction cascade,
brightness-thumbnail foreground grid, thread-pooled batched "supertile"
reads (1024 slide-px default), identical tile-grid coordinates, Canny-edge
texture filter with the reference's hardcoded thresholds, and a zip tile
cache keyed on sha256(params + code hash) with atomic temp-file renames.

The implementation is array-first rather than a PIL-object pipeline:

  * all grid geometry lives in one immutable :class:`_GridSpec`, computed
    up front from the slide MPP; foreground supertile origins come out of
    a single vectorized thumbnail-brightness mask instead of a nested
    scan loop.
  * each worker thread decodes ONE supertile into ONE uint8 ndarray and
    slices the whole tile grid out of it as views — tiles only become
    PIL images at the last moment (cache write / host transform), so the
    extraction driver's device batches are assembled without a per-tile
    PIL round-trip.
  * the texture filter runs on an integer luma plane computed with PIL's
    exact L-mode coefficients ((r*19595 + g*38470 + b*7471 + 0x8000)>>16),
    so rejection decisions are bit-identical to the reference's
    per-tile ``np.array(tile.convert("L"))`` path.
  * slide decoding goes through the native libtiff-family reader
    (stamp_tpu_torch/preprocessing/wsi.py); each worker thread holds its own
    reader handle (native handles are not thread safe).

One deliberate behavioral deviation, shared with round 1: tiles whose
origin lies past the slide extent are dropped instead of being emitted as
100%-padding images.  The reference relies on the Canny filter to reject
those (black padding has no edges), which silently breaks when
``canny_cutoff`` is disabled and crashes its rejection-thumbnail grid
(reference preprocessing/__init__.py:395-407 — floor(coords/tile) indexes
past the ceil-sized inclusion map).  Partial edge tiles (origin inside the
slide) are kept, matching the reference.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import logging
import re
import threading
from collections.abc import Iterator
from concurrent import futures
from dataclasses import dataclass
from pathlib import Path
from tempfile import NamedTemporaryFile
from typing import Final, Generic, NamedTuple, TypedDict, TypeVar
from zipfile import ZipFile

import cv2
import numpy as np
from PIL import Image

from stamp_tpu_torch.preprocessing.wsi import (
    CTiffSlide,
    ImageSlide,
    MPPExtractionError,
    _load_native,
    get_slide_mpp_,
    open_slide,
)
from stamp_tpu_torch.types import (
    EXTENSION_TO_FORMAT,
    ImageExtension,
    Microns,
    SlideMPP,
    SlidePixels,
    TilePixels,
)

__all__ = [
    "tiles_with_cache",
    "get_slide_mpp_",
    "MPPExtractionError",
]

_logger = logging.getLogger("stamp")

# Digest of _this_ file: identifies the tiling procedure in cache keys so a
# change in rejection logic invalidates caches (reference tiling.py:43-46).
with open(__file__, "rb") as _this_file_fp:
    _CODE_HASH: Final[str] = hashlib.file_digest(_this_file_fp, "sha256").hexdigest()

# Canny thresholds are part of the rejection contract (reference
# tiling.py:280-291 hardcodes them the same way).
_CANNY_LO: Final[int] = 40
_CANNY_HI: Final[int] = 100

_Unit = TypeVar("_Unit")


@dataclass
class _XYCoords(Generic[_Unit]):
    x: _Unit
    y: _Unit


class _Tile(NamedTuple, Generic[_Unit]):
    """A tile with associated metadata."""

    image: Image.Image
    coordinates: _XYCoords[_Unit]
    size: _Unit


class _TilerParams(TypedDict):
    """The parameters used during tiling / background rejection.

    Key set identical to the reference (tiling.py:356-377) so cache zips are
    structurally interchangeable (the code hash inside necessarily differs).
    """

    slide_path: str
    tile_size_um: Microns
    tile_size_px: TilePixels
    max_supertile_size_slide_px: SlidePixels
    brightness_cutoff: int | None
    code_sha256: str
    tile_ext: ImageExtension


@dataclass(frozen=True)
class _GridSpec:
    """All tile-grid geometry, derived once per slide.

    A supertile is a square batch of ``n x n`` tiles read in one region
    request; ``n`` is the largest whole tile count fitting in
    ``max_supertile_size_slide_px`` at this slide's MPP (at least 1).
    """

    mpp: SlideMPP
    tile_um: Microns
    tile_px: TilePixels
    tiles_per_side: int  # n
    span_slide_px: int  # supertile edge in level-0 slide pixels
    span_out_px: int  # supertile edge after resize (n * tile_px)
    slide_w_px: int
    slide_h_px: int

    @property
    def span_um(self) -> float:
        return self.span_slide_px * self.mpp

    @property
    def extent_um(self) -> tuple[float, float]:
        """Slide extent (x, y) in microns; tiles originating past it are
        fully padding and get dropped."""
        return (self.slide_w_px * self.mpp, self.slide_h_px * self.mpp)

    def tile_origins_um(self, origin_px: np.ndarray) -> np.ndarray:
        """Micron origins of every tile in the supertile at ``origin_px``.

        Returns an (n, n, 2) float array of (x_um, y_um), row-major in
        (row, col) so axis 0 walks down the slide.
        """
        edge = np.arange(self.tiles_per_side, dtype=np.float64) * float(self.tile_um)
        base = origin_px.astype(np.float64) * float(self.mpp)
        xs = base[0] + edge
        ys = base[1] + edge
        return np.stack(np.broadcast_arrays(xs[None, :], ys[:, None]), axis=-1)


def _grid_spec(
    slide,
    *,
    tile_size_um: Microns,
    tile_size_px: TilePixels,
    max_supertile_size_slide_px: SlidePixels,
    default_slide_mpp: SlideMPP | None,
) -> _GridSpec:
    mpp = get_slide_mpp_(slide, default_mpp=default_slide_mpp)
    n = max(int((max_supertile_size_slide_px * mpp) // tile_size_um), 1)
    tile_slide_px = int(np.ceil(tile_size_um / mpp))
    w, h = slide.dimensions
    return _GridSpec(
        mpp=mpp,
        tile_um=tile_size_um,
        tile_px=tile_size_px,
        tiles_per_side=n,
        span_slide_px=tile_slide_px * n,
        span_out_px=int(tile_size_px) * n,
        slide_w_px=int(w),
        slide_h_px=int(h),
    )


def _foreground_origins(
    slide, spec: _GridSpec, brightness_cutoff: int | None
) -> np.ndarray:
    """Level-0 pixel origins of supertiles worth reading, as an (K, 2)
    int64 array of (x, y).

    A supertile is foreground when its cell in a grid-sized brightness
    thumbnail is darker than the cutoff (reference tiling.py:250-277 uses
    the same 2x-then-downsample thumbnail and ``convert("I")`` plane).
    """
    grid_w = -(-spec.slide_w_px // spec.span_slide_px)  # ceil-div
    grid_h = -(-spec.slide_h_px // spec.span_slide_px)
    if brightness_cutoff is None:
        keep = np.ones((grid_h, grid_w), dtype=bool)
    else:
        thumb = slide.get_thumbnail((grid_w * 2, grid_h * 2))
        brightness = np.asarray(
            thumb.resize((grid_w, grid_h)).convert("I"), dtype=np.int32
        )
        keep = brightness < brightness_cutoff
    cells = np.argwhere(keep)  # (K, 2) of (row, col), row-major
    return cells[:, ::-1].astype(np.int64) * spec.span_slide_px  # (x, y)


def _pil_luma(rgb_u8: np.ndarray) -> np.ndarray:
    """Grayscale plane bit-identical to PIL ``convert("L")`` (libImaging
    Convert.c L24 coefficients with round-half-up), so Canny rejection
    matches the reference's per-tile PIL path exactly.

    Prefers the native kernel (``wsi_luma_l24``): the numpy formulation
    holds the GIL for the whole uint32 ufunc chain — measured at ~24% of
    supertile-fetch wall time (scripts/tiling_scaling_probe.py), which is
    what capped thread scaling of the hot loop across host cores.  The
    ctypes call releases the GIL instead.
    """
    lib = _load_native()
    if lib is not None and hasattr(lib, "wsi_luma_l24"):
        rgb = np.ascontiguousarray(rgb_u8)
        out = np.empty(rgb.shape[:-1], np.uint8)
        lib.wsi_luma_l24(
            rgb.ctypes.data_as(ctypes.c_void_p),
            out.size,
            out.ctypes.data_as(ctypes.c_void_p),
        )
        return out
    px = rgb_u8.astype(np.uint32)
    return (
        (px[..., 0] * 19595 + px[..., 1] * 38470 + px[..., 2] * 7471 + 0x8000) >> 16
    ).astype(np.uint8)


def _has_enough_texture(tile: Image.Image, cutoff: float) -> bool:
    """True if the tile has enough edges to plausibly contain tissue.

    Single-tile form of the batched filter in :func:`_cut_supertile`
    (same Canny thresholds and edge-density score as the reference,
    tiling.py:280-291); kept for tests and ad-hoc use.
    """
    edges = cv2.Canny(_pil_luma(np.asarray(tile.convert("RGB"))), _CANNY_LO, _CANNY_HI)
    return bool(edges.mean() / 255.0 >= cutoff)


class _SupertileBatch(NamedTuple):
    """One decoded supertile, already cut into tiles.

    ``tiles`` is a (n, n, tile_px, tile_px, 3) uint8 view into the decoded
    plane; ``keep`` marks tiles that are inside the slide extent and (if a
    cutoff is set) textured enough to plausibly hold tissue.
    """

    tiles: np.ndarray
    origins_um: np.ndarray  # (n, n, 2) float64
    keep: np.ndarray  # (n, n) bool


def _cut_supertile(
    plane: np.ndarray, spec: _GridSpec, origin_px: np.ndarray, canny_cutoff: float | None
) -> _SupertileBatch:
    """Slice a decoded supertile plane into its tile grid and score it."""
    n, tp = spec.tiles_per_side, int(spec.tile_px)
    tiles = (
        plane.reshape(n, tp, n, tp, 3).transpose(0, 2, 1, 3, 4)
    )  # (row, col, y, x, c)

    origins = spec.tile_origins_um(origin_px)
    extent_x, extent_y = spec.extent_um
    keep = (origins[..., 0] < extent_x) & (origins[..., 1] < extent_y)

    if canny_cutoff is not None:
        luma = _pil_luma(plane).reshape(n, tp, n, tp).transpose(0, 2, 1, 3)
        for row, col in np.argwhere(keep):
            edges = cv2.Canny(np.ascontiguousarray(luma[row, col]), _CANNY_LO, _CANNY_HI)
            if edges.mean() / 255.0 < canny_cutoff:
                keep[row, col] = False

    return _SupertileBatch(tiles=tiles, origins_um=origins, keep=keep)


class _ReaderPool:
    """One native reader handle per worker thread.

    Native tiff-family handles are not thread safe; PIL-backed slides are
    effectively read-only for crops and can be shared.
    """

    def __init__(self, slide_path: Path, shared_slide) -> None:
        self._path = slide_path
        self._shared = shared_slide
        self._local = threading.local()

    def get(self):
        if isinstance(self._shared, ImageSlide):
            return self._shared
        slide = getattr(self._local, "slide", None)
        if slide is None:
            slide = self._local.slide = CTiffSlide(self._path)
        return slide


def _tissue_tile_batches(
    slide_path: Path,
    slide,
    *,
    spec: _GridSpec,
    max_workers: int,
    brightness_cutoff: int | None,
    canny_cutoff: float | None,
) -> Iterator[_SupertileBatch]:
    """Decode foreground supertiles concurrently, yielding scored batches
    in completion order (the hot loop of `stamp preprocess`)."""
    readers = _ReaderPool(slide_path, slide)

    def fetch(origin_px: np.ndarray) -> _SupertileBatch:
        region = (
            readers.get()
            .read_region(
                (int(origin_px[0]), int(origin_px[1])),
                0,
                (spec.span_slide_px, spec.span_slide_px),
            )
            .resize((spec.span_out_px, spec.span_out_px))
            .convert("RGB")
        )
        return _cut_supertile(np.asarray(region), spec, origin_px, canny_cutoff)

    with futures.ThreadPoolExecutor(max_workers) as pool:
        pending = [
            pool.submit(fetch, origin)
            for origin in _foreground_origins(slide, spec, brightness_cutoff)
        ]
        for done in futures.as_completed(pending):
            yield done.result()


def _iter_tiles(
    slide_path: Path,
    slide,
    *,
    tile_size_um: Microns,
    tile_size_px: TilePixels,
    max_supertile_size_slide_px: SlidePixels,
    max_workers: int,
    brightness_cutoff: int | None,
    canny_cutoff: float | None,
    default_slide_mpp: SlideMPP | None,
) -> Iterator[_Tile[Microns]]:
    """Adapt the array pipeline to the per-tile PIL interface the cache
    writer and host transforms consume."""
    spec = _grid_spec(
        slide,
        tile_size_um=tile_size_um,
        tile_size_px=tile_size_px,
        max_supertile_size_slide_px=max_supertile_size_slide_px,
        default_slide_mpp=default_slide_mpp,
    )
    for batch in _tissue_tile_batches(
        slide_path,
        slide,
        spec=spec,
        max_workers=max_workers,
        brightness_cutoff=brightness_cutoff,
        canny_cutoff=canny_cutoff,
    ):
        for row, col in np.argwhere(batch.keep):
            x_um, y_um = batch.origins_um[row, col]
            yield _Tile(
                image=Image.fromarray(batch.tiles[row, col]),
                coordinates=_XYCoords(Microns(x_um), Microns(y_um)),
                size=tile_size_um,
            )


# extensions are stored verbatim, so names carry ".jpg" or "..jpg" depending
# on whether the configured extension included its dot (reference writes the
# same way) — hence `\.+`
_CACHE_TILE_NAME = re.compile(r"tile_\((\d+\.\d+), (\d+\.\d+)\)\.+(\w+)$")


def _replay_cache(cache_file_path: Path) -> Iterator[_Tile]:
    """Replay tiles from a cache zip (name format shared with the
    reference, tiling.py:380-406)."""
    with ZipFile(cache_file_path, "r") as zip_fp:
        params: _TilerParams = json.loads(zip_fp.read("tiler_params.json").decode())
        ext = str(params.get("tile_ext", "jpg")).lstrip(".")
        for name in zip_fp.namelist():
            match = _CACHE_TILE_NAME.match(name)
            if match is None or match.group(3) != ext:
                continue
            with zip_fp.open(name, "r") as tile_fp:
                img = Image.open(tile_fp)
                img.load()
            yield _Tile(
                image=img,
                coordinates=_XYCoords(
                    Microns(float(match.group(1))), Microns(float(match.group(2)))
                ),
                size=params["tile_size_um"],
            )


def tiles_with_cache(
    slide_path: Path,
    *,
    cache_dir: Path | None,
    cache_tiles_ext: ImageExtension,
    tile_size_um: Microns,
    tile_size_px: TilePixels,
    max_supertile_size_slide_px: SlidePixels,
    max_workers: int,
    brightness_cutoff: int | None,
    canny_cutoff: float | None,
    default_slide_mpp: SlideMPP | None,
) -> Iterator[_Tile[Microns]]:
    """Iterate over tissue tiles, using / filling the zip cache
    (entry point parity: reference tiling.py:68-168)."""
    fresh_kwargs = dict(
        tile_size_um=tile_size_um,
        tile_size_px=tile_size_px,
        max_supertile_size_slide_px=max_supertile_size_slide_px,
        max_workers=max_workers,
        brightness_cutoff=brightness_cutoff,
        canny_cutoff=canny_cutoff,
        default_slide_mpp=default_slide_mpp,
    )
    if cache_dir is None:
        yield from _iter_tiles(slide_path, open_slide(slide_path), **fresh_kwargs)
        return

    tiler_params: _TilerParams = {
        "slide_path": str(slide_path),
        "tile_size_um": tile_size_um,
        "tile_size_px": tile_size_px,
        "max_supertile_size_slide_px": max_supertile_size_slide_px,
        "brightness_cutoff": brightness_cutoff,
        "code_sha256": _CODE_HASH,
        "tile_ext": cache_tiles_ext,
    }
    tiler_params_hash = hashlib.sha256(
        json.dumps(tiler_params, sort_keys=True).encode()
    ).hexdigest()
    cache_file_path = cache_dir / slide_path.with_suffix(f".{tiler_params_hash}.zip").name
    if cache_file_path.exists():
        yield from _replay_cache(cache_file_path)
        return

    # fill the cache atomically: write to a temp file, rename when complete
    with (
        NamedTemporaryFile(dir=cache_file_path.parent, delete=False) as tmp_cache_file,
        ZipFile(tmp_cache_file.name, "w") as zip_fp,
    ):
        try:
            with zip_fp.open("tiler_params.json", "w") as params_fp:
                params_fp.write(json.dumps(tiler_params).encode())

            save_opts = dict(icc_profile=None) if cache_tiles_ext == "png" else {}
            for tile in _iter_tiles(slide_path, open_slide(slide_path), **fresh_kwargs):
                entry = (
                    f"tile_({float(tile.coordinates.x)}, "
                    f"{float(tile.coordinates.y)}).{cache_tiles_ext}"
                )
                with zip_fp.open(entry, "w") as tile_zip_fp:
                    tile.image.save(
                        tile_zip_fp,
                        format=EXTENSION_TO_FORMAT[cache_tiles_ext],
                        **save_opts,
                    )
                yield tile
        except Exception:
            _logger.exception(f"error while processing {slide_path}")
            Path(tmp_cache_file.name).unlink(missing_ok=True)
            raise

        Path(tmp_cache_file.name).rename(cache_file_path)
