"""Tracing and profiling for ``--profile``.

Two layers, as in ``stamp_tpu/utils/profiling.py`` (the stage timer is its
copy, so that the port imports nothing of the JAX package):

* ``stage(name)`` — a nestable wall-clock stage timer.  Pipeline code
  brackets its phases (tile decode, device forward, h5 write, training
  step, …); the accumulated table is logged at the end of a profiled run.
  While a device trace runs, each stage is also a
  ``torch.profiler.record_function`` range, so the trace names the stages.
* ``device_trace(out_dir)`` — a ``torch.profiler`` trace (CPU activity,
  and CUDA activity when the command runs on a card) around the whole
  command, exported as a Chrome/TensorBoard trace
  ``<out_dir>/profile/<name>.pt.trace.json``: ``rank{r}`` in a fleet (each
  rank its own file), ``stamp`` otherwise.  If the profiler cannot start,
  a warning says why and only the stage table is kept, as the JAX package
  does; if it starts but records nothing on the card, a warning says so.
  Shapes and stacks are not recorded: a whole command's trace holds every
  operator event, and they would multiply its size.

``profiled_run(out_dir)`` is ``stamp --profile <command>``: both layers, the
table logged at the end (``stage_table()`` alone is the table without the
trace).  The profiler only observes: a command's outputs are those of the
same command without ``--profile``.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
import warnings
from collections import defaultdict
from pathlib import Path

_logger = logging.getLogger("stamp")


class StageTimer:
    """Accumulates wall-clock time per named stage (thread-safe)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.enabled = False
        self.tracing = False  # a device trace runs: stages are record_function ranges too

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            if self.tracing:
                import torch

                with torch.profiler.record_function(name):
                    yield
            else:
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


def trace_name() -> str:
    """This process's trace file stem: ``rank{r}`` in a fleet, else ``stamp``."""
    rank = os.environ.get("STAMP_PROCESS_ID") if os.environ.get("STAMP_NUM_PROCESSES") else None
    return "stamp" if rank is None else f"rank{rank}"


def _cuda_events(prof) -> int:
    """The number of device (CUDA) events a stopped profiler recorded."""
    from torch.autograd import DeviceType

    return sum(e.device_type() == DeviceType.CUDA for e in prof.profiler.kineto_results.events())


@contextlib.contextmanager
def device_trace(out_dir: Path, *, cuda: bool = False):
    """A ``torch.profiler`` trace around a block (CPU activity, and CUDA
    activity with ``cuda``), written to ``<out_dir>/profile/`` at the end;
    yields the trace's path, or None (with a warning) when the profiler
    cannot start.  The profiler's own warnings go to the log, and so does
    one when a CUDA trace holds no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    path = Path(out_dir) / "profile" / f"{trace_name()}.pt.trace.json"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    prof = None
    try:
        with warnings.catch_warnings(record=True) as said:  # the profiler's own warnings, into the log
            warnings.simplefilter("always")
            prof = profile(activities=activities, record_shapes=False, with_stack=False)
            prof.start()
        for w in said:
            _logger.warning(f"torch.profiler: {w.message}")
    except Exception as e:  # a machine whose profiler cannot start: the stage table stays
        _logger.warning(f"device tracing unavailable ({type(e).__name__}: {e}); stage timing only")
        prof = None
    if prof is not None:
        _logger.info(f"writing a {'CPU and CUDA' if cuda else 'CPU'} trace to {path}")
        timer.tracing = True
    try:
        yield None if prof is None else path
    finally:
        timer.tracing = False
        if prof is not None:
            try:
                if cuda and torch.cuda.is_initialized():
                    torch.cuda.synchronize()  # the device's last kernels belong to the trace
                prof.stop()
                if cuda and not _cuda_events(prof):
                    _logger.warning("the trace recorded no CUDA activity: the profiler could not trace the card; "
                                    "the trace holds the CPU side only")  # fmt: skip
                path.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(path))
            except Exception as e:
                _logger.warning(f"writing the device trace failed ({type(e).__name__}: {e})")


@contextlib.contextmanager
def stage_table():
    """The stage timer around a block, its table logged at the end."""
    timer.enabled = True
    timer.reset()
    try:
        yield
    finally:
        _logger.info("profile — per-stage wall time:\n" + timer.report())
        timer.enabled = False


@contextlib.contextmanager
def profiled_run(out_dir: Path, *, cuda: bool = False):
    """``--profile``: the device trace and the stage table."""
    with stage_table(), device_trace(out_dir, cuda=cuda):
        yield
