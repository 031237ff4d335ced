"""Timing of a set-up's phases."""

from __future__ import annotations

import sys
import time


class Phases:
    """Set-up's phases, timed on the host and reported on standard error."""

    def __init__(self) -> None:
        self.t = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name], self.t = now - self.t, now

    def report(self) -> None:
        print("setup phases (s): " + ", ".join(f"{k} {v:.3f}" for k, v in self.seconds.items()), file=sys.stderr)
