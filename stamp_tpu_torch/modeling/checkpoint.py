"""The ``model.ckpt`` checkpoint: hyper-parameters + a variable tree, as npz.

Reads and writes the same ``stamp-tpu-ckpt-v2`` files as
``stamp_tpu.modeling.checkpoint``: one array per leaf of the JAX module's
variable tree (key ``var:`` + the JSON-encoded path), the hyper-parameters
as a JSON header, loaded with ``allow_pickle=False`` so a checkpoint never
executes code.  Pickle files are refused.  ``stamp_version`` is gated
against this package's ``__version__``: older than 2.5.0 or newer than the
installed version is refused.

The variable tree is nested dicts of numpy arrays on both sides of the
file; each backbone's ``variables_from_jax`` / ``variables_to_jax``
(``models.weights``) map it to and from a torch ``state_dict``.
"""

from __future__ import annotations

import io
import json
import zipfile
from pathlib import Path
from typing import Any

import numpy as np
from packaging.version import Version

import stamp_tpu_torch

CKPT_FORMAT = "stamp-tpu-ckpt-v2"

_HEADER_KEY = "__stamp_header__"
_VAR_PREFIX = "var:"


def check_version_compatibility(stamp_version: str | Version) -> None:
    """Version gate (reference models/__init__.py:92-105)."""
    v = Version(str(stamp_version))
    if v < Version("2.5.0"):
        raise ValueError(
            f"model has been built with stamp version {v} "
            "which is incompatible with the current version."
        )
    elif v > Version(stamp_tpu_torch.__version__):
        raise ValueError(
            "model has been built with a stamp version newer than the installed "
            f"one ({v} > {stamp_tpu_torch.__version__}). "
            "Please upgrade stamp to a compatible version."
        )


def _jsonify(obj: Any) -> Any:
    """Hyper-parameters → JSON-safe (numpy scalars/arrays, paths, tuples)."""
    if isinstance(obj, dict):
        return {str(k): _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _jsonify(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    if isinstance(obj, Path):
        return str(obj)
    return obj


def _flatten(tree: Any, prefix: tuple[str, ...] = ()) -> dict[tuple[str, ...], Any]:
    if isinstance(tree, dict):
        out: dict[tuple[str, ...], Any] = {}
        for k, v in tree.items():
            out.update(_flatten(v, prefix + (str(k),)))
        return out
    return {prefix: tree}


def _unflatten(flat: dict[tuple[str, ...], np.ndarray]) -> Any:
    root: dict = {}
    for path, value in flat.items():
        node = root
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = value
    return root


def save_checkpoint(path: Path, *, hyper_parameters: dict[str, Any], variables: Any) -> None:
    """Write ``variables`` (nested dicts of arrays) and ``hyper_parameters``
    to ``path``, atomically."""
    path.parent.mkdir(parents=True, exist_ok=True)

    arrays: dict[str, np.ndarray] = {}
    for var_path, leaf in _flatten(variables).items():
        arrays[_VAR_PREFIX + json.dumps(list(var_path))] = np.asarray(leaf)

    header = json.dumps({"format": CKPT_FORMAT, "hyper_parameters": _jsonify(hyper_parameters)})
    arrays[_HEADER_KEY] = np.frombuffer(header.encode("utf-8"), dtype=np.uint8)

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_bytes(buf.getvalue())
    tmp.rename(path)


def load_checkpoint(path: Path | str) -> dict[str, Any]:
    """``{"format", "hyper_parameters", "variables"}`` of a checkpoint."""
    path = Path(path)
    with open(path, "rb") as fp:
        magic = fp.read(2)
    if magic.startswith(b"\x80"):  # pickle protocol ≥2 marker
        raise ValueError(
            f"{path} is a pickle file — refusing to load it (pickle "
            "checkpoints can execute arbitrary code; re-train or re-export "
            "with this version to get the npz-based format)."
        )
    try:
        archive = np.load(path, allow_pickle=False)
    except (OSError, ValueError, EOFError, zipfile.BadZipFile) as e:
        raise ValueError(f"{path} is not a stamp-tpu checkpoint") from e

    if _HEADER_KEY not in archive:
        raise ValueError(f"{path} is not a stamp-tpu checkpoint")
    header = json.loads(bytes(archive[_HEADER_KEY]).decode("utf-8"))
    if header.get("format") != CKPT_FORMAT:
        raise ValueError(f"{path} is not a stamp-tpu checkpoint")

    flat = {
        tuple(json.loads(key[len(_VAR_PREFIX) :])): archive[key]
        for key in archive.files
        if key.startswith(_VAR_PREFIX)
    }

    hparams = header["hyper_parameters"]
    check_version_compatibility(hparams.get("stamp_version", "0.0.0"))
    return {
        "format": header["format"],
        "hyper_parameters": hparams,
        "variables": _unflatten(flat),
    }
