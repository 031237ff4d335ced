"""Unit types and shared aliases.

Copy of ``stamp_tpu/types.py``, kept in the port so that it imports nothing
of the JAX package.

The pipeline juggles three coordinate systems — physical microns on the
tissue, level-0 scan pixels, and resized tile pixels — plus the scalar that
converts between them (microns per pixel).  Each gets its own ``NewType`` so
mixing them up is a type error rather than a silently wrong heatmap.  Mirrors
the semantic unit system of the reference (src/stamp/types.py:23-62) without
depending on a framework: array-valued data is numpy (or torch in the port).
"""

from collections.abc import Mapping
from pathlib import Path
from typing import Final, Literal, NewType, TypeAlias, TypeVar

# --- physical / pixel units -------------------------------------------------

Microns = NewType("Microns", float)
"""Micrometers of actual tissue on the slide."""

SlideMPP = NewType("SlideMPP", float)
"""Microns per pixel at scan level 0 — the µm ↔ pixel conversion factor."""

SlidePixels = NewType("SlidePixels", int)
"""Pixels in the WSI's level-0 (highest magnification) coordinate frame."""

TilePixels = NewType("TilePixels", int)
"""Pixels of the resized tile as the extractor model sees it."""

# --- tile cache -------------------------------------------------------------

ImageExtension: TypeAlias = Literal["png", "jpg"]
EXTENSION_TO_FORMAT: Final[Mapping[str, str]] = {
    "png": "png",
    "jpg": "jpeg",
}

# --- cohort / modeling ------------------------------------------------------

PatientId: TypeAlias = str
PandasLabel: TypeAlias = str
"""A column name in a clinical or slide table."""

FeaturePath = NewType("FeaturePath", Path)
"""Path of an ``.h5`` feature file."""

Category: TypeAlias = str
GroundTruth: TypeAlias = str
MultiClassGroundTruth: TypeAlias = tuple[str, ...]
SurvivalGroundTruth: TypeAlias = tuple[float | None, int | None]
"""(time-to-event, event-observed) — either may be missing in messy tables."""

GroundTruthType = TypeVar("GroundTruthType", covariant=True)

BagSize: TypeAlias = int
DeviceLikeType: TypeAlias = str | int

Task: TypeAlias = Literal["classification", "regression", "survival"]
"""Multi-target classification is `classification` with a list of ground
truth labels; it is not a separate task value."""
