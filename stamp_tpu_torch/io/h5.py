"""The ``.h5`` tile-feature file, written and read without h5py.

The port writes the same files as ``stamp_tpu.io.h5.write_tile_feats_atomic``
(datasets ``coords`` and ``feats``, the same root attributes and types), but
machines that run the port need not have h5py, so the HDF5 encoding is done
here for exactly the objects such a file holds:

* superblock version 2, root group as a version-2 object header with compact
  link storage (Link Info, Group Info and one Link message per dataset);
* datasets with contiguous layout, numeric datatypes, simple dataspaces;
* scalar root attributes: variable-length UTF-8 strings (stored in one
  global heap collection), 64-bit floats and 64-bit signed integers —
  h5py reads them back as ``str``, ``numpy.float64`` and ``numpy.int64``,
  as it does for the files h5py writes.

``read_h5`` parses files of this layout (superblock version 2, which h5py
does not write by default).  The feature readers of the deploy path
(``get_coords``, ``read_feats``, ``detect_feature_type``; counterparts of
``stamp_tpu/io/h5.py:27-177``) read this layout without h5py, so the port
runs where h5py is missing; any other file they open with h5py, imported
inside the function.  The format follows the HDF5 File Format Specification
version 3.0.
"""

from __future__ import annotations

import logging
import mmap
import struct
from dataclasses import dataclass
from pathlib import Path
from tempfile import NamedTemporaryFile

import numpy as np
from packaging.version import Version

import stamp_tpu_torch
from stamp_tpu_torch.types import Microns, SlideMPP, TilePixels

_logger = logging.getLogger("stamp")

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF
_GCOL_SIZE = 4096  # the smallest global heap collection HDF5 reads
_MASK = 0xFFFFFFFF

# object header message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_VALUE, _LINK, _LAYOUT = 1, 2, 3, 5, 6, 8
_GROUP_INFO, _ATTRIBUTE = 10, 12


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _MASK


def lookup3(data: bytes, initval: int = 0) -> int:
    """Bob Jenkins' lookup3 ``hashlittle``, HDF5's metadata checksum."""
    length = len(data)
    a = b = c = (0xDEADBEEF + length + initval) & _MASK
    i = 0
    while length - i > 12:
        a = (a + int.from_bytes(data[i : i + 4], "little")) & _MASK
        b = (b + int.from_bytes(data[i + 4 : i + 8], "little")) & _MASK
        c = (c + int.from_bytes(data[i + 8 : i + 12], "little")) & _MASK
        a = (a - c) & _MASK; a ^= _rot(c, 4); c = (c + b) & _MASK  # noqa: E702
        b = (b - a) & _MASK; b ^= _rot(a, 6); a = (a + c) & _MASK  # noqa: E702
        c = (c - b) & _MASK; c ^= _rot(b, 8); b = (b + a) & _MASK  # noqa: E702
        a = (a - c) & _MASK; a ^= _rot(c, 16); c = (c + b) & _MASK  # noqa: E702
        b = (b - a) & _MASK; b ^= _rot(a, 19); a = (a + c) & _MASK  # noqa: E702
        c = (c - b) & _MASK; c ^= _rot(b, 4); b = (b + a) & _MASK  # noqa: E702
        i += 12
    if length - i == 0:
        return c
    tail = data[i:].ljust(12, b"\0")
    a = (a + int.from_bytes(tail[0:4], "little")) & _MASK
    b = (b + int.from_bytes(tail[4:8], "little")) & _MASK
    c = (c + int.from_bytes(tail[8:12], "little")) & _MASK
    c ^= b; c = (c - _rot(b, 14)) & _MASK  # noqa: E702
    a ^= c; a = (a - _rot(c, 11)) & _MASK  # noqa: E702
    b ^= a; b = (b - _rot(a, 25)) & _MASK  # noqa: E702
    c ^= b; c = (c - _rot(b, 16)) & _MASK  # noqa: E702
    a ^= c; a = (a - _rot(c, 4)) & _MASK  # noqa: E702
    b ^= a; b = (b - _rot(a, 14)) & _MASK  # noqa: E702
    c ^= b; c = (c - _rot(b, 24)) & _MASK  # noqa: E702
    return c


# --- datatype message bodies --------------------------------------------------

_FLOAT_LAYOUT = {  # itemsize → (exponent location, exponent bits, mantissa bits, bias)
    2: (10, 5, 10, 15),
    4: (23, 8, 23, 127),
    8: (52, 11, 52, 1023),
}


def _dtype_float(itemsize: int) -> bytes:
    exp_loc, exp_bits, mant_bits, bias = _FLOAT_LAYOUT[itemsize]
    bits = 8 * itemsize
    # class 1, version 1; little-endian, IEEE implied-MSB mantissa, sign bit
    return struct.pack("<B3BI", 0x11, 0x20, bits - 1, 0, itemsize) + struct.pack(
        "<HHBBBBI", 0, bits, exp_loc, exp_bits, 0, mant_bits, bias
    )


def _dtype_int(itemsize: int, signed: bool) -> bytes:
    # class 0, version 1; little-endian
    return struct.pack("<B3BI", 0x10, 0x08 if signed else 0, 0, 0, itemsize) + struct.pack(
        "<HH", 0, 8 * itemsize
    )


# class 9 (variable-length), version 1: a UTF-8, null-padded string whose
# elements are (length, global heap collection address, object index)
_DTYPE_VLEN_STR = struct.pack("<B3BI", 0x19, 0x01, 0x01, 0, 4 + 8 + 4) + _dtype_int(1, False)


def _dtype_of(arr: np.ndarray) -> bytes:
    if arr.dtype.kind == "f" and arr.dtype.itemsize in _FLOAT_LAYOUT:
        return _dtype_float(arr.dtype.itemsize)
    if arr.dtype.kind in "iu":
        return _dtype_int(arr.dtype.itemsize, arr.dtype.kind == "i")
    raise TypeError(f"no HDF5 encoding here for {arr.dtype}")


def _dataspace(shape: tuple[int, ...]) -> bytes:
    kind = 1 if shape else 0  # simple or scalar
    return struct.pack("<BBBB", 2, len(shape), 0, kind) + b"".join(
        struct.pack("<Q", d) for d in shape
    )


# --- object headers -----------------------------------------------------------


def _message(kind: int, body: bytes, flags: int = 0) -> bytes:
    return struct.pack("<BHB", kind, len(body), flags) + body


def _object_header(messages: list[bytes]) -> bytes:
    """Version-2 object header, one chunk, 4-byte chunk size, checksummed."""
    body = b"".join(messages)
    head = b"OHDR" + struct.pack("<BBI", 2, 0x02, len(body)) + body
    return head + struct.pack("<I", lookup3(head))


def _dataset_header(arr: np.ndarray, address: int) -> bytes:
    return _object_header(
        [
            _message(_DATASPACE, _dataspace(arr.shape)),
            _message(_DATATYPE, _dtype_of(arr), flags=1),
            # version 3: late allocation, fill written if set, default fill
            _message(_FILL_VALUE, struct.pack("<BB", 3, 0x0A), flags=1),
            # version 3, contiguous: address and size of the raw data
            _message(_LAYOUT, struct.pack("<BBQQ", 3, 1, address, arr.nbytes)),
        ]
    )


def _attribute(name: str, dtype: bytes, space: bytes, data: bytes) -> bytes:
    raw = name.encode() + b"\0"
    body = struct.pack("<BBHHHB", 3, 0, len(raw), len(dtype), len(space), 1)
    return _message(_ATTRIBUTE, body + raw + dtype + space + data)


def _link(name: str, address: int) -> bytes:
    raw = name.encode()
    # version 1, flags 0x10: hard link, 1-byte name length, UTF-8 name
    return _message(_LINK, struct.pack("<BBBB", 1, 0x10, 1, len(raw)) + raw + struct.pack("<Q", address))


def _root_header(
    datasets: dict[str, int], attrs: dict[str, str | int | float], strings: dict[str, int], gcol: int
) -> bytes:
    messages = [
        # Link Info v0: no creation order, compact storage (no fractal heap)
        _message(_LINK_INFO, struct.pack("<BBQQ", 0, 0, _UNDEF, _UNDEF)),
        _message(_GROUP_INFO, struct.pack("<BB", 0, 0)),
    ]
    messages += [_link(name, addr) for name, addr in datasets.items()]
    scalar = _dataspace(())
    for name, value in attrs.items():
        if isinstance(value, str):
            data = struct.pack("<IQI", len(value.encode()), gcol, strings[name])
            messages.append(_attribute(name, _DTYPE_VLEN_STR, scalar, data))
        elif isinstance(value, (int, np.integer)):
            messages.append(_attribute(name, _dtype_int(8, True), scalar, struct.pack("<q", int(value))))
        else:
            messages.append(_attribute(name, _dtype_float(8), scalar, struct.pack("<d", float(value))))
    return _object_header(messages)


def _global_heap(objects: list[bytes]) -> bytes:
    """One collection of ``_GCOL_SIZE`` bytes holding ``objects`` (1-based
    indices), the rest marked free (object 0)."""
    out = bytearray(b"GCOL" + struct.pack("<B3xQ", 1, _GCOL_SIZE))
    for index, data in enumerate(objects, start=1):
        out += struct.pack("<HH4xQ", index, 0, len(data)) + data.ljust(-(-len(data) // 8) * 8, b"\0")
    free = _GCOL_SIZE - len(out)
    if free < 0:
        raise ValueError("attribute strings exceed one global heap collection")
    if free >= 16:
        out += struct.pack("<HH4xQ", 0, 0, free)
    return bytes(out.ljust(_GCOL_SIZE, b"\0"))


def write_h5(path: Path, datasets: dict[str, np.ndarray], attrs: dict[str, str | int | float]) -> None:
    """Write an HDF5 file with ``datasets`` under the root group and scalar
    root ``attrs`` (str, int or float)."""
    arrays = {name: np.ascontiguousarray(arr) for name, arr in datasets.items()}
    for arr in arrays.values():
        if arr.dtype.byteorder == ">":
            raise TypeError("big-endian arrays are not supported")
    string_names = [name for name, v in attrs.items() if isinstance(v, str)]
    strings = {name: i for i, name in enumerate(string_names, start=1)}
    heap = _global_heap([attrs[name].encode() for name in string_names])

    # header sizes do not depend on the addresses they hold: size them first
    sizes = [len(_dataset_header(arr, 0)) for arr in arrays.values()]
    root_size = len(_root_header({n: 0 for n in arrays}, attrs, strings, 0))
    superblock_size = 48
    root_addr = superblock_size
    header_addrs = np.cumsum([root_addr + root_size, *sizes[:-1]]).tolist()
    gcol_addr = root_addr + root_size + sum(sizes)
    data_addr = gcol_addr + len(heap)
    data_addrs = np.cumsum([data_addr, *[a.nbytes for a in arrays.values()][:-1]]).tolist()
    eof = data_addr + sum(a.nbytes for a in arrays.values())

    superblock = _SIGNATURE + struct.pack("<BBBBQQQQ", 2, 8, 8, 0, 0, _UNDEF, eof, root_addr)
    superblock += struct.pack("<I", lookup3(superblock))
    with open(path, "wb") as fp:
        fp.write(superblock)
        fp.write(_root_header(dict(zip(arrays, header_addrs)), attrs, strings, gcol_addr))
        for arr, addr in zip(arrays.values(), data_addrs):
            fp.write(_dataset_header(arr, addr))
        fp.write(heap)
        for arr in arrays.values():
            fp.write(arr.tobytes())


def write_tile_feats_atomic(
    *,
    output_path: Path,
    feats: np.ndarray,
    coords_um: np.ndarray,
    extractor_id: str,
    tile_size_um: float,
    tile_size_px: int,
    code_hash: str,
    precision: str | None = None,
) -> None:
    """Atomically write a tile-level feature file with the attrs of
    ``stamp_tpu.io.h5.write_tile_feats_atomic``."""
    attrs: dict[str, str | int | float] = {
        "stamp_version": stamp_tpu_torch.__version__,
        "extractor": str(extractor_id),
        "unit": "um",
        "tile_size_um": float(tile_size_um),
        "tile_size_px": int(tile_size_px),
        "code_hash": code_hash,
        "feat_type": "tile",
    }
    if precision is not None:
        attrs["precision"] = precision
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with NamedTemporaryFile(dir=output_path.parent, delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        write_h5(tmp_path, {"coords": coords_um, "feats": feats}, attrs)
    except BaseException:
        tmp_path.unlink(missing_ok=True)
        raise
    tmp_path.rename(output_path)


def write_pooled_feats_atomic(
    *,
    output_path: Path,
    feats: np.ndarray,
    encoder_id: str,
    precision: str,
    feat_type: str,
    code_hash: str,
    source_precision: str | None = None,
) -> None:
    """Atomically write a slide- or patient-level feature file with the
    datasets and attrs of ``stamp_tpu.io.h5.write_pooled_feats_atomic``.
    ``source_precision`` carries the numeric mode of the tile extraction
    when it was not the default (int8 provenance survives pooling)."""
    attrs: dict[str, str | int | float] = {
        "version": stamp_tpu_torch.__version__,
        "encoder": str(encoder_id),
        "precision": str(precision),
        "stamp_version": stamp_tpu_torch.__version__,
        "code_hash": code_hash,
        "feat_type": feat_type,
    }
    if source_precision is not None:
        attrs["source_precision"] = source_precision
    output_path.parent.mkdir(parents=True, exist_ok=True)
    with NamedTemporaryFile(dir=output_path.parent, delete=False) as tmp:
        tmp_path = Path(tmp.name)
    try:
        write_h5(tmp_path, {"feats": np.asarray(feats)}, attrs)
    except BaseException:
        tmp_path.unlink(missing_ok=True)
        raise
    tmp_path.rename(output_path)


# --- reading back what write_h5 wrote ----------------------------------------


def _messages(buf: bytes, addr: int) -> list[tuple[int, bytes]]:
    if buf[addr : addr + 4] != b"OHDR" or buf[addr + 4] != 2 or buf[addr + 5] != 0x02:
        raise ValueError(f"unsupported object header at {addr}")
    (size,) = struct.unpack_from("<I", buf, addr + 6)
    end = addr + 10 + size
    if lookup3(buf[addr:end]) != struct.unpack_from("<I", buf, end)[0]:
        raise ValueError(f"object header checksum mismatch at {addr}")
    out, p = [], addr + 10
    while p + 4 <= end:
        kind, length, _flags = struct.unpack_from("<BHB", buf, p)
        out.append((kind, buf[p + 4 : p + 4 + length]))
        p += 4 + length
    return out


def _decode_dtype(body: bytes) -> np.dtype | str:
    """The numpy dtype of a datatype message, or "vlen-str"."""
    cls, flags, _b1, _b2, size = struct.unpack_from("<B3BI", body)
    if cls == 0x11:
        return np.dtype(f"<f{size}")
    if cls == 0x10:
        return np.dtype(f"<{'i' if flags & 0x08 else 'u'}{size}")
    if cls == 0x19:
        return "vlen-str"
    raise ValueError(f"unsupported datatype class byte {cls:#x}")


def read_h5(
    path: Path, *, datasets: bool = True
) -> tuple[dict[str, np.ndarray], dict[str, str | int | float]]:
    """(datasets, root attrs) of a file written by ``write_h5``.  The file is
    memory-mapped, so with ``datasets=False`` only its headers are read."""
    with open(path, "rb") as fp, mmap.mmap(fp.fileno(), 0, access=mmap.ACCESS_READ) as buf:
        return _parse_h5(buf, Path(path), with_datasets=datasets)


def _parse_h5(buf, path: Path, *, with_datasets: bool):
    if buf[:8] != _SIGNATURE or buf[8] != 2:
        raise ValueError(f"{path}: not a version-2 superblock HDF5 file")
    if lookup3(buf[:44]) != struct.unpack_from("<I", buf, 44)[0]:
        raise ValueError(f"{path}: superblock checksum mismatch")
    (root,) = struct.unpack_from("<Q", buf, 36)

    datasets: dict[str, np.ndarray] = {}
    attrs: dict[str, str | int | float] = {}
    for kind, body in _messages(buf, root):
        if kind == _LINK and with_datasets:
            n = body[3]
            name = body[4 : 4 + n].decode()
            (addr,) = struct.unpack_from("<Q", body, 4 + n)
            parts = dict(_messages(buf, addr))
            ndims = parts[_DATASPACE][1]
            shape = struct.unpack_from(f"<{ndims}Q", parts[_DATASPACE], 4)
            dtype = _decode_dtype(parts[_DATATYPE])
            _v, _cls, data_addr, nbytes = struct.unpack_from("<BBQQ", parts[_LAYOUT])
            count = nbytes // dtype.itemsize
            # a copy, so that no array holds on to the mapping
            datasets[name] = np.frombuffer(buf, dtype, count=count, offset=data_addr).reshape(shape).copy()
        elif kind == _ATTRIBUTE:
            _v, _f, name_len, dt_len, sp_len, _enc = struct.unpack_from("<BBHHHB", body)
            p = 9
            name = body[p : p + name_len - 1].decode()
            dtype = _decode_dtype(body[p + name_len :])
            data = body[p + name_len + dt_len + sp_len :]
            if dtype == "vlen-str":
                length, gcol, index = struct.unpack_from("<IQI", data)
                q = gcol + 16
                while True:
                    idx, _refs, size = struct.unpack_from("<HH4xQ", buf, q)
                    if idx == index:
                        attrs[name] = buf[q + 16 : q + 16 + length].decode()
                        break
                    if idx == 0:
                        raise ValueError(f"{path}: string of attribute {name!r} not found")
                    q += 16 + -(-size // 8) * 8
            else:
                attrs[name] = np.frombuffer(data, dtype, count=1)[0]
    return datasets, attrs


# --- the feature readers of the deploy path -----------------------------------


def _is_own_layout(path: Path) -> bool:
    """Whether ``path`` has the superblock version ``write_h5`` writes."""
    with open(path, "rb") as fp:
        head = fp.read(9)
    return len(head) == 9 and head[:8] == _SIGNATURE and head[8] == 2


def _read_feature_file(path: Path, *, datasets: bool = True) -> tuple[dict[str, np.ndarray], dict]:
    """(datasets, root attrs) of a feature file of either layout."""
    if _is_own_layout(path):
        return read_h5(path, datasets=datasets)
    import h5py

    with h5py.File(path, "r") as h5:
        attrs = dict(h5.attrs)
        arrays = {
            name: np.asarray(h5[name])
            for name in (h5 if datasets else ())
            if isinstance(h5[name], h5py.Dataset)
        }
    return arrays, attrs


@dataclass
class CoordsInfo:
    coords_um: np.ndarray
    tile_size_um: Microns
    tile_size_px: TilePixels | None = None

    @property
    def mpp(self) -> SlideMPP:
        if not self.tile_size_px:
            raise RuntimeError(
                "tile size in pixels is not available. "
                "Please reextract them using `stamp preprocess`."
            )
        return SlideMPP(self.tile_size_um / self.tile_size_px)


def get_stride(coords: np.ndarray) -> float:
    """Minimum step width between any two coordinates (reference data.py:1150-1161)."""
    xs = np.unique(coords[:, 0])
    ys = np.unique(coords[:, 1])
    return float(
        min(
            np.diff(xs).min() if len(xs) > 1 else np.inf,
            np.diff(ys).min() if len(ys) > 1 else np.inf,
        )
    )


def get_coords(datasets: dict[str, np.ndarray], attrs: dict, filename: str | Path) -> CoordsInfo:
    """Tile coordinates in µm from a feature file's datasets and root attrs,
    handling every historic layout as ``stamp_tpu.io.h5.get_coords`` does:

      - no ``coords`` dataset at all (multiplex bypass): fake (i, 0) coords
      - STAMP v2:     attrs ``tile_size`` + ``unit == "um"``
      - current:      attrs ``tile_size_um`` (+ optional ``tile_size_px``)
      - historic:     stride ≈ 224 → coords are 224px-units of 256µm tiles
    """
    if "coords" not in datasets:
        n = datasets["patch_embeddings"].shape[0]
        coords_um = np.stack([np.arange(n), np.zeros(n)], axis=1).astype(np.float32)
        return CoordsInfo(coords_um, Microns(0.0), TilePixels(0))

    coords = datasets["coords"]
    tile_size_um: Microns | None = None
    tile_size_px: TilePixels | None = None
    coords_um: np.ndarray | None = None

    if (tile_size := attrs.get("tile_size", None)) and attrs.get("unit", None) == "um":
        # STAMP v2 format
        tile_size_um = Microns(float(tile_size))
        coords_um = coords
    elif tile_size := attrs.get("tile_size_um", None):
        # Newer STAMP format
        tile_size_um = Microns(float(tile_size))
        coords_um = coords
    elif round(float(attrs.get("tile_size", get_stride(coords.astype(np.float32))))) == 224:
        # Historic STAMP format: coordinates have unit 256um/224px
        _logger.debug(
            f"{filename}: tile stride is roughly 224, assuming "
            "coordinates have unit 256um/224px (historic STAMP format)"
        )
        tile_size_um = Microns(256.0)
        tile_size_px = TilePixels(224)
        coords_um = coords / 224 * 256

    if (version_str := attrs.get("stamp_version")) and (
        extraction_version := Version(str(version_str))
    ) > Version(stamp_tpu_torch.__version__):
        raise RuntimeError(
            "features were extracted with a newer version of stamp, please "
            f"update your stamp to at least version {extraction_version}."
        )

    if not tile_size_px and "tile_size_px" in attrs:
        tile_size_px = TilePixels(int(attrs["tile_size_px"]))

    if not tile_size_um or coords_um is None:
        raise RuntimeError(
            "unable to infer coordinates from feature file. "
            "Please reextract them using `stamp preprocess`."
        )
    return CoordsInfo(np.asarray(coords_um, dtype=np.float32), tile_size_um, tile_size_px)


def detect_feature_type(feature_dir: Path) -> str:
    """Feature level ('tile' / 'slide' / 'patient') from the h5 attrs of
    every file under ``feature_dir`` (reference data.py:424-457)."""
    feature_types: set[str] = set()
    files_checked = 0
    for file in feature_dir.rglob("*.h5"):
        files_checked += 1
        _, attrs = _read_feature_file(file, datasets=False)
        feat_type = attrs.get("feat_type")
        if feat_type is not None or attrs.get("encoder") is not None:
            feature_types.add(str(feat_type))
        else:
            feature_types.add("tile")

    if files_checked == 0:
        raise RuntimeError("No .h5 feature files found in feature_dir.")
    if len(feature_types) > 1:
        raise RuntimeError(
            f"Multiple feature types detected in {feature_dir}: {feature_types}. "
            "All feature files must have the same type."
        )
    return feature_types.pop()


def read_feats(h5_path: Path | str) -> tuple[np.ndarray, CoordsInfo]:
    """A tile feature file → (feats [N, F] float32, coords info)."""
    datasets, attrs = _read_feature_file(Path(h5_path))
    feats = datasets["feats"] if "feats" in datasets else datasets["patch_embeddings"]
    return feats.astype(np.float32, copy=False), get_coords(datasets, attrs, h5_path)
