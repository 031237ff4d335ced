"""Tiny cells for the benchmark's CPU tests: the real cells' files with
widths and traffic cut to what a CPU test holds (the port's UNI2 entry is
swapped for a tiny tower of the same kind for the test's duration)."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import spec  # noqa: E402

TINY_VIT = dict(embed_dim=48, num_heads=3, depth=24)  # every block of UNI2-h, at a tiny width
TINY_MIL = dict(dim_input=32, dim_model=16, dim_feedforward=16, n_heads=2)


@pytest.fixture
def tiny_uni2(monkeypatch):
    """The port's UNI2 entry as a tiny tower (224 px, 14 px patches, 8 registers, SwiGLU)."""
    from stamp_tpu_torch.models import vit_image

    tiny = dataclasses.replace(vit_image.VIT_CONFIGS["uni2"], **TINY_VIT)
    monkeypatch.setitem(vit_image.VIT_CONFIGS, "uni2", tiny)
    return tiny


def tiny_cell(workload: str, limits: dict | None = None) -> spec.Cell:
    """``workload``'s cell at tiny widths and traffic, with its own limits
    unless ``limits`` is given."""
    c = spec.cell(workload)
    if c.driver_name == "extract":
        config = dict(c.config, **TINY_VIT, mlp_hidden=int(TINY_VIT["embed_dim"] * 5.33334))
        traffic = dict(c.traffic, batch=4, pool_batches=2, reference_block=4, slide_tiles=[9, 3, 6])
    else:
        config = dict(c.config, **TINY_MIL)
        whole = c.traffic["bag_size"] is None
        traffic = dict(c.traffic, patients=8, tiles_min=20, tiles_max=700, batch_size=1 if whole else 4,
                       bag_size=None if whole else 16)  # fmt: skip
    return dataclasses.replace(c, config=config, traffic=traffic, limits=limits or c.limits)
