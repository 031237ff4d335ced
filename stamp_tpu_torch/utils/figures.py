"""matplotlib, where it is installed.

The card's machine has no matplotlib.  The port's ``statistics`` and
``heatmaps`` write every table and every ``raw/`` image without it; each
figure that needs it (the statistics' SVGs, heatmaps' ``plots/`` PNGs) is
skipped, and the command names the skipped figures in one warning.
"""

from __future__ import annotations

import logging
from collections.abc import Sequence
from pathlib import Path

_logger = logging.getLogger("stamp")


def pyplot():
    """``matplotlib.pyplot``, or None where matplotlib is not installed."""
    try:
        from matplotlib import pyplot as plt
    except ImportError:
        return None
    return plt


def warn_not_written(figures: Sequence[Path]) -> None:
    """One warning naming every figure that was not written."""
    if figures:
        _logger.warning(
            f"matplotlib is not installed: {len(figures)} figure(s) not written: "
            + ", ".join(str(f) for f in figures)
        )
