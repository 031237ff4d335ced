"""Per-stage wall-clock timer for ``--profile``.

The stage timer of ``stamp_tpu/utils/profiling.py`` (``StageTimer``,
``timer``, ``stage``), copied so that the port imports nothing of the JAX
package.  The JAX package's ``device_trace`` / ``profiled_run`` wrap a
``jax.profiler`` trace and have no counterpart here yet.
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict


class StageTimer:
    """Accumulates wall-clock time per named stage (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.enabled = False

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self.seconds[name] += dt
                self.calls[name] += 1

    def reset(self) -> None:
        with self._lock:
            self.seconds.clear()
            self.calls.clear()

    def report(self) -> str:
        if not self.seconds:
            return "no stages recorded"
        width = max(len(n) for n in self.seconds)
        total = sum(self.seconds.values())
        lines = [f"{'stage':<{width}}  {'calls':>7}  {'total s':>9}  {'share':>6}"]
        for name, secs in sorted(self.seconds.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<{width}}  {self.calls[name]:>7d}  {secs:>9.2f}  "
                f"{secs / total:>6.1%}"
            )
        return "\n".join(lines)


#: process-global timer used by the pipeline stages
timer = StageTimer()
stage = timer.stage
