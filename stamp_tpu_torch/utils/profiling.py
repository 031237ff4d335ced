"""Tracing and profiling: the program's spans and counters, and ``--profile``.

* ``stage(name)`` — a span around one phase of the work (tile decode, the
  extractor's upload and tower, the training step's forward, loss,
  backward and optimizer, …).  Spans nest: each records its name, its
  start and end on ``time.time_ns()``'s clock (the host clock that
  ``torch.profiler`` stamps its events with, so a span lies on the same
  timeline as the trace's ranges and device work), its parent (the span
  open around it on the same thread), its top-level span's index (the
  identifier every span of one call shares), the thread and its self
  time (its duration less its children's).  While a ``torch.profiler``
  runs each span is also a ``record_function`` range.
* ``count(name, n)`` — a counter at the same boundaries (tiles, the rows a
  backbone computes), stamped on the same clock.
* ``device_trace(out_dir)`` — a ``torch.profiler`` trace (CPU activity,
  and CUDA activity when the command runs on a card) around the whole
  command, exported as a Chrome/TensorBoard trace
  ``<out_dir>/profile/<name>.pt.trace.json``: ``rank{r}`` in a fleet (each
  rank its own file), ``stamp`` otherwise.  If the profiler cannot start,
  a warning says why and only the stage table is kept, as the JAX package
  does; if it starts but records nothing on the card, a warning says so.
  Shapes and stacks are not recorded: a whole command's trace holds every
  operator event, and they would multiply its size.

Spans and counts are recorded while the timer is enabled (``--profile``,
``stage_table()``) or any ``torch.profiler`` runs, into a bounded ring of
the newest ``RING`` records (``records()`` reads it) and into per-name sums
(the stage table, whatever the ring has dropped).  Otherwise ``stage``
returns one shared no-op context and ``count`` returns at once.  No span
synchronizes with the device or reads a device value: a span's time is the
host's, which includes whatever the host waits for inside it (a blocking
copy), and the device's time per span is in the trace.

``profiled_run(out_dir)`` is ``stamp --profile <command>``: the trace and
the stage table, logged at the end (``stage_table()`` alone is the table
without the trace).  The profiler only observes: a command's outputs are
those of the same command without ``--profile``.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
import warnings
from collections import defaultdict, deque
from pathlib import Path
from typing import NamedTuple

import torch

_logger = logging.getLogger("stamp")

#: records the ring keeps (the newest; the stage table's sums keep counting)
RING = 1 << 18
_profiler_enabled = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()  # shared: the off path allocates nothing


class Span(NamedTuple):
    """A finished span; times in ns on ``time.time_ns()``'s clock."""

    index: int
    name: str
    start_ns: int
    end_ns: int
    parent: int | None  # the index of the span open around it on its thread
    root: int  # the index of its top-level span (its own if it has no parent)
    thread: int
    self_ns: int  # its duration less its children's


class Count(NamedTuple):
    """One ``count(name, n)``, stamped on ``time.time_ns()``'s clock."""

    time_ns: int
    name: str
    n: int


class _OpenSpan:
    __slots__ = ("timer", "name", "index", "root", "outer", "start", "children", "range")

    def __init__(self, timer: StageTimer, name: str) -> None:
        self.timer, self.name = timer, name

    def __enter__(self) -> None:
        stack = self.timer._stack()
        self.outer = stack[-1] if stack else None
        self.index = next(self.timer._indices)
        self.root = self.index if self.outer is None else self.outer.root
        self.children = 0
        self.range = None
        if _profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.time_ns()  # inside the range: the span lies within it

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.timer._stack().pop()
        if self.range is not None:
            self.range.__exit__(*exc)
        duration = end - self.start
        outer = self.outer
        if outer is not None:
            outer.children += duration
        self.timer._finish(Span(self.index, self.name, self.start, end, None if outer is None else outer.index,
                                self.root, threading.get_ident(), duration - self.children))  # fmt: skip


class StageTimer:
    """Spans and counters (thread-safe): the ring of the newest records and
    per-name sums of time, self time, calls and counts."""

    def __init__(self, ring: int = RING) -> None:
        self._lock = threading.Lock()
        self._local = threading.local()
        self._indices = itertools.count()
        self.log: deque[Span | Count] = deque(maxlen=ring)
        self.seconds: dict[str, float] = defaultdict(float)
        self.self_seconds: dict[str, float] = defaultdict(float)
        self.calls: dict[str, int] = defaultdict(int)
        self.counts: dict[str, int] = defaultdict(int)
        self.enabled = False

    def recording(self) -> bool:
        """Whether spans and counts are recorded: the timer is enabled or a
        ``torch.profiler`` runs."""
        return self.enabled or _profiler_enabled()

    def stage(self, name: str):
        """A span called ``name`` around a block (a no-op when not recording)."""
        if not (self.enabled or _profiler_enabled()):
            return _OFF
        return _OpenSpan(self, name)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name`` (nothing when not recording)."""
        if not (self.enabled or _profiler_enabled()):
            return
        record = Count(time.time_ns(), name, n)
        with self._lock:
            self.log.append(record)
            self.counts[name] += n

    def _stack(self) -> list[_OpenSpan]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _finish(self, span: Span) -> None:
        with self._lock:
            self.log.append(span)
            self.seconds[span.name] += (span.end_ns - span.start_ns) / 1e9
            self.self_seconds[span.name] += span.self_ns / 1e9
            self.calls[span.name] += 1

    def records(self) -> list[Span | Count]:
        """The ring's spans and counts, oldest first (a span is recorded
        when it ends, so after its children)."""
        with self._lock:
            return list(self.log)

    def reset(self) -> None:
        with self._lock:
            self.log.clear()
            self.seconds.clear()
            self.self_seconds.clear()
            self.calls.clear()
            self.counts.clear()

    def report(self) -> str:
        """The stage table: host time per stage, shares of the self time."""
        if not (self.seconds or self.counts):
            return "no stages recorded"
        width = max(len(n) for n in [*self.seconds, *self.counts])
        total = sum(self.self_seconds.values()) or 1.0
        lines = []
        if self.seconds:
            lines.append(f"{'stage':<{width}}  {'calls':>7}  {'total s':>9}  {'self s':>9}  {'share':>6}")
        for name, secs in sorted(self.self_seconds.items(), key=lambda kv: -kv[1]):
            lines.append(
                f"{name:<{width}}  {self.calls[name]:>7d}  {self.seconds[name]:>9.2f}  {secs:>9.2f}  "
                f"{secs / total:>6.1%}"
            )
        if self.counts:
            lines.append(f"{'counter':<{width}}  {'total':>7}")
            lines += [f"{name:<{width}}  {n:>7d}" for name, n in sorted(self.counts.items())]
        return "\n".join(lines)


#: process-global timer used by the pipeline stages
timer = StageTimer()
stage = timer.stage
count = timer.count
records = timer.records
recording = timer.recording


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
    try:
        yield None if prof is None else path
    finally:
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
        _logger.info("profile — per-stage wall time (host clock):\n" + timer.report())
        timer.enabled = False


@contextlib.contextmanager
def profiled_run(out_dir: Path, *, cuda: bool = False):
    """``--profile``: the device trace and the stage table."""
    with stage_table(), device_trace(out_dir, cuda=cuda):
        yield
