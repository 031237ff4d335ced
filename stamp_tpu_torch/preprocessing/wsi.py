"""Whole-slide-image reading.

Copy of ``stamp_tpu/preprocessing/wsi.py``, kept in the port so that it
imports nothing of the JAX package; the native reader is looked up only in
the repository's ``native/build/``.

The reference delegates WSI decoding to OpenSlide (reference tiling.py:24).
This framework ships its own reader stack:

* ``CTiffSlide`` — native C++ reader (native/wsireader.cpp, libtiff+libjpeg)
  for tiled pyramidal TIFF / Aperio SVS, loaded via ctypes.  This is the
  production path: region reads decode only the intersecting tiles, run
  multithreaded on the host, and feed pinned buffers to the device pipeline.
* ``ImageSlide`` — PIL-backed fallback for plain images (png/jpeg/small tiffs),
  mirroring ``openslide.ImageSlide``.

``open_slide`` dispatches by file content.  MPP extraction follows the
reference's cascade (tiling.py:409-475): resolution properties → embedded
comment ``<PixelSizeMicrons>`` → OME-XML ``PhysicalSizeX`` → SVS description
``MPP = …`` → TIFF resolution tags.
"""

from __future__ import annotations

import ctypes
import logging
import re
import xml.dom.minidom as minidom
from pathlib import Path

import numpy as np
from PIL import Image

from stamp_tpu_torch.types import SlideMPP

_logger = logging.getLogger("stamp")

Image.MAX_IMAGE_PIXELS = None

PROPERTY_NAME_MPP_X = "openslide.mpp-x"


class MPPExtractionError(Exception):
    """Raised when the MPP extraction from the slide's metadata fails."""


class UnsupportedFormatError(Exception):
    """Raised for WSI container formats the native reader cannot decode.

    The reference opens 12 formats through OpenSlide (reference
    preprocessing/__init__.py:43-56); the native reader covers the
    TIFF family (SVS incl. JPEG2000, generic pyramidal TIFF, NDPI, QPTIFF,
    BIF, SCN), 3DHISTECH MIRAX (.mrxs, native/mirax.cpp), Hamamatsu
    VMS/VMU (native/vms.cpp), Zeiss CZI (.czi, native/czi.cpp, incl.
    JPEG XR subblocks via native/jxr.cpp) plus anything PIL can open.
    This error names the gap instead of a cryptic per-slide stack
    trace.
    """


# vendor containers the native reader does not implement.  .svslide is
# SlideVault/Precipoint's SQLite-tile database (openslide reads it for the
# reference, preprocessing/__init__.py:47); there is no TIFF structure to
# reuse, so it is refused loudly by name instead of failing in PIL with a
# cryptic per-slide stack trace.
UNSUPPORTED_CONTAINER_SUFFIXES: set[str] = {".svslide"}

# vendor containers handled entirely by the native reader
# (no single-file magic to sniff, no PIL fallback)
_NATIVE_CONTAINER_SUFFIXES = {
    ".mrxs", ".vms", ".vmu", ".czi", ".scn", ".bif", ".qptiff", ".qptif",
}
# .scn/.bif/.qptiff are TIFF-shaped but carry vendor semantics (Leica
# collection stitch in native/scn.cpp, Ventana iScan metadata in
# native/bif.cpp, Akoya ImageType pyramid + multiplexed-IF refusal in
# native/qptiff.cpp); a PIL fallback would silently open the
# macro/thumbnail/first-band image, so route them native-only.


class ImageSlide:
    """PIL-backed slide for plain images (parity with openslide.ImageSlide)."""

    def __init__(self, image: Image.Image | Path | str) -> None:
        if not isinstance(image, Image.Image):
            image = Image.open(image)
        self._image = image
        self.properties: dict[str, str] = {}
        info_desc = image.info.get("description") if hasattr(image, "info") else None
        if info_desc:
            self.properties["tiff.ImageDescription"] = str(info_desc)

    @property
    def dimensions(self) -> tuple[int, int]:
        return self._image.size

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> Image.Image:
        if level != 0:
            raise ValueError("ImageSlide only has level 0")
        x, y = location
        w, h = size
        region = Image.new("RGBA", (w, h), (255, 255, 255, 0))
        crop = self._image.convert("RGBA").crop(
            (x, y, min(x + w, self._image.size[0]), min(y + h, self._image.size[1]))
        )
        region.paste(crop, (0, 0))
        return region

    def get_thumbnail(self, size: tuple[int, int]) -> Image.Image:
        thumb = self._image.convert("RGB").copy()
        thumb.thumbnail(size, Image.Resampling.LANCZOS)
        return thumb


# ---------------------------------------------------------------------------
# Native libtiff-backed reader
# ---------------------------------------------------------------------------

_NATIVE_LIB_PATHS = [
    Path(__file__).resolve().parents[2] / "native" / "build" / "libwsireader.so",
]

_native: ctypes.CDLL | None = None
_native_checked = False


def _load_native() -> ctypes.CDLL | None:
    global _native, _native_checked
    if _native_checked:
        return _native
    _native_checked = True
    for p in _NATIVE_LIB_PATHS:
        if p.exists():
            try:
                lib = ctypes.CDLL(str(p))
                lib.wsi_open.restype = ctypes.c_void_p
                lib.wsi_open.argtypes = [ctypes.c_char_p]
                lib.wsi_close.argtypes = [ctypes.c_void_p]
                lib.wsi_width.restype = ctypes.c_int64
                lib.wsi_width.argtypes = [ctypes.c_void_p]
                lib.wsi_height.restype = ctypes.c_int64
                lib.wsi_height.argtypes = [ctypes.c_void_p]
                lib.wsi_level_count.restype = ctypes.c_int32
                lib.wsi_level_count.argtypes = [ctypes.c_void_p]
                lib.wsi_description.restype = ctypes.c_char_p
                lib.wsi_description.argtypes = [ctypes.c_void_p]
                lib.wsi_mpp.restype = ctypes.c_double
                lib.wsi_mpp.argtypes = [ctypes.c_void_p]
                lib.wsi_read_region.restype = ctypes.c_int32
                lib.wsi_read_region.argtypes = [
                    ctypes.c_void_p,  # handle
                    ctypes.c_int64,  # x
                    ctypes.c_int64,  # y
                    ctypes.c_int64,  # w
                    ctypes.c_int64,  # h
                    ctypes.c_void_p,  # out buffer (RGBA)
                ]
                lib.wsi_read_level.restype = ctypes.c_int32
                lib.wsi_read_level.argtypes = [
                    ctypes.c_void_p,
                    ctypes.c_int32,  # level index
                    ctypes.c_void_p,  # out buffer
                ]
                lib.wsi_level_width.restype = ctypes.c_int64
                lib.wsi_level_width.argtypes = [ctypes.c_void_p, ctypes.c_int32]
                lib.wsi_level_height.restype = ctypes.c_int64
                lib.wsi_level_height.argtypes = [ctypes.c_void_p, ctypes.c_int32]
                try:  # failure-reason channel; absent in older builds
                    lib.wsi_last_error.restype = ctypes.c_char_p
                    lib.wsi_last_error.argtypes = []
                    lib.wsi_decode_errors.restype = ctypes.c_int64
                    lib.wsi_decode_errors.argtypes = [ctypes.c_void_p]
                except AttributeError:
                    pass
                try:  # raw-tile interface (J2K path); absent in older builds
                    lib.wsi_compression.restype = ctypes.c_int32
                    lib.wsi_compression.argtypes = [ctypes.c_void_p]
                    lib.wsi_raw_only.restype = ctypes.c_int32
                    lib.wsi_raw_only.argtypes = [ctypes.c_void_p]
                    lib.wsi_tile_width.restype = ctypes.c_int32
                    lib.wsi_tile_width.argtypes = [ctypes.c_void_p, ctypes.c_int32]
                    lib.wsi_tile_height.restype = ctypes.c_int32
                    lib.wsi_tile_height.argtypes = [ctypes.c_void_p, ctypes.c_int32]
                    lib.wsi_read_raw_tile.restype = ctypes.c_int64
                    lib.wsi_read_raw_tile.argtypes = [
                        ctypes.c_void_p,
                        ctypes.c_int32,
                        ctypes.c_int64,
                        ctypes.c_int64,
                        ctypes.c_void_p,
                        ctypes.c_int64,
                    ]
                except AttributeError:
                    pass
                try:  # GIL-free luma kernel (tiling hot loop); older builds lack it
                    lib.wsi_luma_l24.restype = None
                    lib.wsi_luma_l24.argtypes = [
                        ctypes.c_void_p,  # packed RGB8 in
                        ctypes.c_int64,  # pixel count
                        ctypes.c_void_p,  # L8 out
                    ]
                except AttributeError:
                    pass
                _native = lib
                break
            except OSError as e:  # pragma: no cover
                _logger.debug(f"could not load native wsi reader {p}: {e}")
    return _native


class CTiffSlide:
    """Slide backed by the native C++ reader (pyramidal TIFF / SVS / NDPI
    via libtiff, MIRAX .mrxs via the mirax.cpp backend — wsi_open dispatches
    on the file type)."""

    def __init__(self, path: Path | str) -> None:
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native wsi reader library not built")
        self._lib = lib
        self._handle = lib.wsi_open(str(path).encode())
        if not self._handle:
            reason = ""
            if hasattr(lib, "wsi_last_error"):
                raw = lib.wsi_last_error()
                reason = f": {raw.decode(errors='replace')}" if raw else ""
            raise RuntimeError(f"could not open slide {path}{reason}")
        self.path = Path(path)
        self.properties: dict[str, str] = {}
        desc = lib.wsi_description(self._handle)
        if desc:
            self.properties["tiff.ImageDescription"] = desc.decode(errors="replace")
        mpp = lib.wsi_mpp(self._handle)
        if mpp > 0:
            self.properties[PROPERTY_NAME_MPP_X] = str(mpp)
            self.properties["openslide.mpp-y"] = str(mpp)
        self._decode_errors_reported = 0

    def __del__(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.wsi_close(self._handle)
            self._handle = None

    @property
    def dimensions(self) -> tuple[int, int]:
        return (
            int(self._lib.wsi_width(self._handle)),
            int(self._lib.wsi_height(self._handle)),
        )

    @property
    def level_count(self) -> int:
        return int(self._lib.wsi_level_count(self._handle))

    @property
    def level_dimensions(self) -> tuple[tuple[int, int], ...]:
        """(width, height) per pyramid level, level 0 first — the
        OpenSlide property of the same name."""
        return tuple(
            (
                int(self._lib.wsi_level_width(self._handle, i)),
                int(self._lib.wsi_level_height(self._handle, i)),
            )
            for i in range(self.level_count)
        )

    @property
    def _raw_only(self) -> bool:
        fn = getattr(self._lib, "wsi_raw_only", None)
        return bool(fn(self._handle)) if fn else False

    # --- JPEG2000 (Aperio 33003/33005) path: libtiff hands us the raw tile
    # codestreams, Pillow/openjpeg decodes them host-side ---------------------

    def _decode_raw_tile(self, level: int, tx: int, ty: int) -> np.ndarray:
        import io

        tw = int(self._lib.wsi_tile_width(self._handle, level))
        th = int(self._lib.wsi_tile_height(self._handle, level))
        buf = ctypes.create_string_buffer(tw * th * 4 + 4096)
        n = self._lib.wsi_read_raw_tile(
            self._handle, level, tx, ty, buf, len(buf)
        )
        if n < 0 and -n > len(buf):
            buf = ctypes.create_string_buffer(-n)
            n = self._lib.wsi_read_raw_tile(
                self._handle, level, tx, ty, buf, len(buf)
            )
        if n <= 0:
            raise RuntimeError(f"raw tile read failed at level {level} ({tx},{ty})")
        img = Image.open(io.BytesIO(buf.raw[:n]))  # j2k codestream
        arr = np.asarray(img.convert("RGB"), dtype=np.uint8)
        if arr.shape[0] != th or arr.shape[1] != tw:
            padded = np.zeros((th, tw, 3), np.uint8)
            padded[: arr.shape[0], : arr.shape[1]] = arr
            arr = padded
        return arr

    def _read_region_raw(
        self, x: int, y: int, w: int, h: int, level: int = 0
    ) -> np.ndarray:
        tw = int(self._lib.wsi_tile_width(self._handle, level))
        th = int(self._lib.wsi_tile_height(self._handle, level))
        if tw == 0 or th == 0:
            raise RuntimeError("raw-only slide without tiles")
        lw = int(self._lib.wsi_level_width(self._handle, level))
        lh = int(self._lib.wsi_level_height(self._handle, level))
        out = np.full((h, w, 4), 255, np.uint8)
        x0, y0 = max(x, 0), max(y, 0)
        x1, y1 = min(x + w, lw), min(y + h, lh)
        ty = (y0 // th) * th
        while ty < y1:
            tx = (x0 // tw) * tw
            while tx < x1:
                tile = self._decode_raw_tile(level, tx, ty)
                cx0, cx1 = max(tx, x0), min(tx + tw, x1)
                cy0, cy1 = max(ty, y0), min(ty + th, y1)
                out[cy0 - y : cy1 - y, cx0 - x : cx1 - x, :3] = tile[
                    cy0 - ty : cy1 - ty, cx0 - tx : cx1 - tx
                ]
                tx += tw
            ty += th
        return out

    def _warn_on_decode_errors(self) -> None:
        """Degraded-but-successful reads (undecodable tiles rendered as
        background) must not pass silently — surface them as warnings."""
        fn = getattr(self._lib, "wsi_decode_errors", None)
        if fn is None:
            return
        count = int(fn(self._handle))
        if count > self._decode_errors_reported:
            _logger.warning(
                f"{self.path.name}: {count - self._decode_errors_reported} "
                "tile(s) failed to decode and were rendered as background "
                f"({count} total for this slide)"
            )
            self._decode_errors_reported = count

    def read_region(
        self, location: tuple[int, int], level: int, size: tuple[int, int]
    ) -> Image.Image:
        if level != 0:
            raise ValueError("only level-0 reads are supported")
        x, y = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        if self._raw_only:
            return Image.fromarray(self._read_region_raw(x, y, w, h), "RGBA")
        buf = np.empty((h, w, 4), dtype=np.uint8)
        rc = self._lib.wsi_read_region(
            self._handle, x, y, w, h, buf.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise RuntimeError(f"read_region failed with code {rc}")
        self._warn_on_decode_errors()
        return Image.fromarray(buf, "RGBA")

    def read_region_array(
        self, location: tuple[int, int], size: tuple[int, int]
    ) -> np.ndarray:
        """Zero-PIL fast path: level-0 region as an RGBA uint8 array."""
        x, y = int(location[0]), int(location[1])
        w, h = int(size[0]), int(size[1])
        buf = np.empty((h, w, 4), dtype=np.uint8)
        rc = self._lib.wsi_read_region(
            self._handle, x, y, w, h, buf.ctypes.data_as(ctypes.c_void_p)
        )
        if rc != 0:
            raise RuntimeError(f"read_region failed with code {rc}")
        self._warn_on_decode_errors()
        return buf

    def get_thumbnail(self, size: tuple[int, int]) -> Image.Image:
        # use the smallest pyramid level at least as large as `size`
        n = int(self._lib.wsi_level_count(self._handle))
        best = 0
        for i in range(n - 1, -1, -1):
            lw = int(self._lib.wsi_level_width(self._handle, i))
            lh = int(self._lib.wsi_level_height(self._handle, i))
            if lw >= size[0] or lh >= size[1]:
                best = i
                break
        lw = int(self._lib.wsi_level_width(self._handle, best))
        lh = int(self._lib.wsi_level_height(self._handle, best))
        if self._raw_only:
            buf = self._read_region_raw(0, 0, lw, lh, level=best)
        else:
            buf = np.empty((lh, lw, 4), dtype=np.uint8)
            rc = self._lib.wsi_read_level(
                self._handle, best, buf.ctypes.data_as(ctypes.c_void_p)
            )
            if rc != 0:
                raise RuntimeError(f"reading level {best} failed with code {rc}")
        img = Image.fromarray(buf, "RGBA").convert("RGB")
        img.thumbnail(size, Image.Resampling.LANCZOS)
        return img


_TIFF_MAGICS = (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")


def open_slide(path: Path | str):
    """Open a slide with the best available backend."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in UNSUPPORTED_CONTAINER_SUFFIXES:
        raise UnsupportedFormatError(
            f"'{suffix}' slides (multi-file vendor container) are not "
            "supported by the native reader — convert to pyramidal "
            "TIFF/SVS, or extract this cohort with the reference pipeline."
        )
    if suffix in _NATIVE_CONTAINER_SUFFIXES:
        # MIRAX / Hamamatsu VMS/VMU / Zeiss CZI: vendor containers handled
        # entirely by the native reader (native/{mirax,vms,czi}.cpp).
        if _load_native() is None:
            raise UnsupportedFormatError(
                f"{path.name}: {suffix} slides need the native reader "
                "(build native/ with `make`)."
            )
        try:
            return CTiffSlide(path)
        except RuntimeError as e:
            raise UnsupportedFormatError(f"{path.name}: {e}") from e
    with open(path, "rb") as fp:
        magic = fp.read(4)
    if suffix == ".ndpi" and magic in (b"II*\x00", b"MM\x00*"):
        # Hamamatsu NDPI ≥4 GiB keeps classic 32-bit TIFF offsets that wrap;
        # the native reader reconstructs them (native/ndpi.cpp, OpenSlide's
        # fixup convention) — but that path needs the native library.
        if path.stat().st_size >= 2**32 and _load_native() is None:
            raise UnsupportedFormatError(
                f"{path.name}: NDPI files over 4 GiB need the native reader "
                "(build native/ with `make`)."
            )
    if magic in _TIFF_MAGICS and _load_native() is not None:
        try:
            return CTiffSlide(path)
        except Exception as e:
            _logger.debug(f"native reader failed on {path} ({e}), trying PIL")
    return ImageSlide(path)


# ---------------------------------------------------------------------------
# MPP extraction (reference tiling.py:409-475)
# ---------------------------------------------------------------------------


def _extract_mpp_from_comments(slide) -> SlideMPP | None:
    slide_properties = slide.properties.get("openslide.comment", "")
    match = re.search(r"<PixelSizeMicrons>(.*?)</PixelSizeMicrons>", slide_properties)
    if match is not None and (mpp := match.group(1)) is not None:
        return SlideMPP(float(mpp))
    return None


def _extract_mpp_from_metadata(slide) -> SlideMPP | None:
    try:
        xml_text = slide.properties.get("tiff.ImageDescription") or None
        if xml_text is None:
            return None
        doc = minidom.parseString(xml_text)
        collection = doc.documentElement
        if collection is None:
            return None
        images = collection.getElementsByTagName("Image")
        pixels = images[0].getElementsByTagName("Pixels")
        mpp = float(pixels[0].getAttribute("PhysicalSizeX"))
    except Exception:
        return None
    return SlideMPP(mpp)


def _extract_mpp_from_svs_description(slide) -> SlideMPP | None:
    """Aperio SVS puts ``|MPP = 0.25|`` into the TIFF description."""
    desc = slide.properties.get("tiff.ImageDescription", "")
    match = re.search(r"MPP\s*=\s*([0-9.]+)", desc)
    if match:
        try:
            return SlideMPP(float(match.group(1)))
        except ValueError:
            return None
    return None


def get_slide_mpp_(slide, *, default_mpp: SlideMPP | None) -> SlideMPP | None:
    """MPP extraction cascade; raises MPPExtractionError when nothing works
    and no default is given (reference tiling.py:409-446)."""
    if isinstance(slide, (str, Path)):
        slide = open_slide(slide)

    slide_mpp: SlideMPP | None = None
    if PROPERTY_NAME_MPP_X in slide.properties:
        slide_mpp = SlideMPP(float(slide.properties[PROPERTY_NAME_MPP_X]))
    elif slide_mpp := _extract_mpp_from_comments(slide):
        pass
    elif slide_mpp := _extract_mpp_from_metadata(slide):
        pass
    elif slide_mpp := _extract_mpp_from_svs_description(slide):
        pass

    if slide_mpp is None and default_mpp:
        _logger.warning(
            f"could not infer slide MPP from metadata, using {default_mpp} instead."
        )
    elif slide_mpp is None and default_mpp is None:
        raise MPPExtractionError()

    return slide_mpp or default_mpp
