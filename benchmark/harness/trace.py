"""The traced run: the benchmark's spans, its op wrappers and the device trace.

In a traced run (``--trace 1``) the benchmark opens ``record_function``
spans around the calls it makes into each layer (``bench/...``) and wraps
the op entry points that a per-layer metric names (``WRAPS``) where the
models look them up, each call in a span ``bench.op/<op>#<i>``, and
``torch.profiler`` traces the card over the window.  The trace stays in
memory; ``TraceData`` is what the metric readers read.  In an untraced run
the tracer does nothing and wraps nothing.

Every device event but a user span's projection onto the device's timeline
(kernels, copies, memsets) counts as the card being busy.  An op call's
device time is that of the device work inside its span's projection (the
profiler projects a span onto the device over the work launched within it,
whether an ATen op or a kernel library called through ``ctypes`` launched
it); the stream runs one thing at a time, so the projections do not
overlap.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import importlib
import itertools
import math
from collections import defaultdict
from collections.abc import Callable, Sequence
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

SPAN_PREFIX = "bench"
OP_PREFIX = "bench.op/"
WINDOW_SPAN = "bench/window"
#: entries of each list in a result line's ``breakdown``
BREAKDOWN_ENTRIES = 10


@dataclass(frozen=True)
class Wrap:
    """An op entry point to wrap: ``module.attribute``, spanned as ``op``;
    ``describe(args, kwargs)`` records the call's shapes after it returns
    (outside its span, without a sync)."""

    module: str
    attribute: str
    op: str
    describe: Callable[[tuple, dict], dict]


@dataclass
class OpCall:
    info: dict  # what the wrap's ``describe`` recorded
    device_s: float  # the device work inside the call span's projection


@dataclass
class TraceData:
    """What a traced window left: the window, the benchmark's host spans,
    the device activity, each wrapped op's calls, and the driver's counts."""

    window_s: float
    busy_s: float
    spans: list[tuple[int, int, str]]  # (start ns, end ns, name), the benchmark's
    ops: dict[str, list[OpCall]]
    device_ops: list[list]  # [[name, seconds], ...], the most device time first
    idle_gaps: list[list]  # [[innermost host span, seconds], ...], the longest first
    counts: dict = field(default_factory=dict)
    config: dict = field(default_factory=dict)
    peaks: dict | None = None
    diagnostics: dict = field(default_factory=dict)

    def span_seconds(self, name: str) -> list[float]:
        """The host durations of the benchmark's spans called ``name``."""
        return [(end - start) / 1e9 for start, end, n in self.spans if n == name]

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)


class Tracer:
    """Spans, op wrappers and ``torch.profiler`` over the window, when enabled."""

    def __init__(self, enabled: bool, wraps: Sequence[Wrap] = ()) -> None:
        self.enabled = enabled
        self._wraps = list({(w.module, w.attribute): w for w in wraps}.values())
        self._calls: dict[str, dict[int, dict]] = defaultdict(dict)
        self._counter = itertools.count()
        self._restore: list[tuple[object, str, object]] = []
        self._prof = None

    def span(self, name: str):
        return record_function(name) if self.enabled else contextlib.nullcontext()

    def _wrapped(self, wrap: Wrap, fn: Callable) -> Callable:
        calls, counter = self._calls[wrap.op], self._counter

        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            i = next(counter)
            with record_function(f"{OP_PREFIX}{wrap.op}#{i}"):
                out = fn(*args, **kwargs)
            calls[i] = wrap.describe(args, kwargs)
            return out

        return wrapped

    def __enter__(self) -> Tracer:
        if not self.enabled:
            return self
        for wrap in self._wraps:
            module = importlib.import_module(wrap.module)
            fn = getattr(module, wrap.attribute)
            self._restore.append((module, wrap.attribute, fn))
            setattr(module, wrap.attribute, self._wrapped(wrap, fn))
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
        self._prof = profile(activities=activities, record_shapes=False)
        self._prof.start()
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        try:
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            self._prof.stop()
        finally:
            for module, attribute, fn in reversed(self._restore):
                setattr(module, attribute, fn)
            self._restore.clear()

    def data(self, *, counts: dict, config: dict, peaks: dict | None) -> TraceData:
        """The trace, read once the tracer has exited."""
        return read_kineto(self._prof.profiler.kineto_results.events(), self._calls, counts, config, peaks)


def _merged(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[tuple[int, int]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


def _innermost(spans: list[tuple[int, int, str]], starts: list[int], t: int, fallback: str) -> str:
    """The latest-starting benchmark span open at host time ``t``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 10_000, -1), -1):
        start, end, name = spans[j]
        if end >= t:
            return name.split("#", 1)[0]
    return fallback


def read_kineto(events, calls: dict[str, dict[int, dict]], counts: dict, config: dict,
                peaks: dict | None) -> TraceData:  # fmt: skip
    """``TraceData`` from a stopped profiler's kineto events."""
    annotations: set[str] = set()  # every user span's name: its projection onto the device is no device work
    spans: list[tuple[int, int, str]] = []
    device: list[tuple[int, int, str]] = []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.is_user_annotation():
                name = e.name()
                annotations.add(name)
                if name.startswith(SPAN_PREFIX):
                    spans.append((e.start_ns(), e.end_ns(), name))
        else:
            device.append((e.start_ns(), e.end_ns(), e.name()))
    projections = {n: (s, e) for s, e, n in device if n in annotations and n.startswith(OP_PREFIX)}
    work = sorted((s, e, n) for s, e, n in device if n not in annotations)
    spans.sort()
    window = next(((s, e) for s, e, n in spans if n == WINDOW_SPAN), None)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span")
    w0, w1 = window
    inside = [(max(s, w0), min(e, w1), n) for s, e, n in work if e > w0 and s < w1]
    busy = _merged([(s, e) for s, e, _n in inside])

    by_name: dict[str, int] = defaultdict(int)
    for s, e, n in inside:
        by_name[n[:120]] += e - s
    device_ops = [[n, ns / 1e9] for n, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    starts = [s for s, _e, _n in spans]
    gaps: dict[str, int] = defaultdict(int)
    edges = [w0] + [t for s, e in busy for t in (s, e)] + [w1]
    for gap_start, gap_end in zip(edges[::2], edges[1::2]):
        if gap_end > gap_start:
            gaps[_innermost(spans, starts, gap_start, WINDOW_SPAN)] += gap_end - gap_start
    idle_gaps = [[n, ns / 1e9] for n, ns in sorted(gaps.items(), key=lambda kv: -kv[1])[:BREAKDOWN_ENTRIES]]

    # each wrapped op call: its host span, and the device work inside its span's projection
    work_starts = [s for s, _e, _n in work]
    prefix = list(itertools.accumulate((e - s for s, e, _n in work), initial=0))
    ops: dict[str, list[OpCall]] = defaultdict(list)
    unprojected = 0
    for start, end, name in spans:
        if not name.startswith(OP_PREFIX):
            continue
        op, _, index = name[len(OP_PREFIX):].partition("#")
        info = calls.get(op, {}).get(int(index))
        if info is None:
            continue
        device_ns = 0
        if name in projections:
            p0, p1 = projections[name]
            device_ns = prefix[bisect.bisect_right(work_starts, p1)] - prefix[bisect.bisect_left(work_starts, p0)]
        else:
            unprojected += 1
        ops[op].append(OpCall(info=info, device_s=device_ns / 1e9))
    return TraceData(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        spans=spans,
        ops=dict(ops),
        device_ops=device_ops,
        idle_gaps=idle_gaps,
        counts=counts,
        config=config,
        peaks=peaks,
        diagnostics={"spans": len(spans), "device_events": len(work), "op_calls": sum(map(len, ops.values())),
                     "op_calls_without_device_projection": unprojected},  # fmt: skip
    )


def roofline_pct(calls: list[OpCall], bound: Callable[[dict, dict], float], peaks: dict | None) -> float | None:
    """The calls' least time (``bound(info, peaks)`` each) over the device
    time they launched, in %; None where nothing was traced or the card's
    peaks are unknown."""
    if not calls or peaks is None:
        return None
    device_s = sum(c.device_s for c in calls)
    if device_s <= 0.0:
        return None
    value = 100.0 * sum(bound(c.info, peaks) for c in calls) / device_s
    return value if math.isfinite(value) else None
