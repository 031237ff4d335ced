"""One run of one cell: set-up, the window, the check and the result line.

Generic over cells: the driver, the traffic, the limits and the per-layer
metrics are found by the names in ``BENCHMARK.json`` (``spec``).  With
``trace`` off the metrics are the cell's end-to-end ones (``setup_s`` and
the driver's rate); with it on, its per-layer ones, read from the traced
window by each metric's own reader, which may find nothing to read (the
metric is then left out of the line).
"""

from __future__ import annotations

import math
import subprocess
import sys
import time

import torch

from benchmark.harness import spec
from benchmark.harness.peaks import card_peaks
from benchmark.harness.trace import Tracer

#: the port's launch counters, read around the window (a module not loaded is skipped)
COUNTER_MODULES = ("stamp_tpu_torch.ops.flash_attention", "stamp_tpu_torch.ops.ln_dense")


def _counters() -> dict[str, int]:
    out = {}
    for name in COUNTER_MODULES:
        module = sys.modules.get(name)
        for attr in dir(module) if module is not None else ():
            if attr.endswith("LAUNCHES") and isinstance(getattr(module, attr), int):
                out[f"{name.rsplit('.', 1)[1]}.{attr}"] = getattr(module, attr)
    return out


def power_limit_w() -> float | None:
    """The card's power limit (``nvidia-smi``), or None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True).stdout  # fmt: skip
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def _number(x: float) -> float | str:
    return x if math.isfinite(x) else str(x)


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device: torch.device, started: float,
             *, control: bool = False, fault: str | None = None) -> dict:  # fmt: skip
    """The result line of one run (``started``: the process's start on the
    clock of ``time.perf_counter``, from which ``setup_s`` counts)."""
    driver = spec.driver(cell)
    readers = {m["name"]: spec.metric_reader(cell, m["name"]) for m in cell.per_layer} if trace else {}
    wraps = [w for reader in readers.values() for w in getattr(reader, "WRAPS", ())]
    cuda = device.type == "cuda"
    session = driver.Session(cell, seed, device, control=control, fault=fault)
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - started
    before = _counters()
    tracer = Tracer(trace, wraps)
    with tracer:
        window = session.run_window(seconds, tracer)
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    launches = {k: v - before.get(k, 0) for k, v in _counters().items() if v != before.get(k, 0)}
    print(f"window: {window.get('steps', window.get('batches'))} calls, {window['tiles']} tiles in "
          f"{window['window_s']:.3f} s; launches {launches}", file=sys.stderr)  # fmt: skip
    kind = torch.cuda.get_device_name(device) if cuda else "cpu"
    t_read = time.perf_counter()
    data = tracer.data(counts=window, config=cell.config, peaks=card_peaks(kind)) if trace else None
    if data is not None:
        print(f"trace read in {time.perf_counter() - t_read:.1f} s: {data.diagnostics}", file=sys.stderr)
    checks = session.check()
    correct = all(value <= limit for value, limit in checks.values())

    if trace:
        values = {name: reader.read(data) for name, reader in readers.items()}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if values[m["name"]] is not None}  # fmt: skip
    else:
        measured = dict(window, setup_s=setup_s)
        metrics = {m["name"]: {"value": measured[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": cell.chips,
                   "memory_peak_bytes": memory_peak, "power_limit_w": power_limit_w() if cuda else None}  # fmt: skip
    result = {"correct": correct, "attempted": session.attempted, "failed": int(session.failed),
              "metrics": metrics, "device": device_info}  # fmt: skip
    if data is not None:
        device_info.update(busy_s=data.busy_s, window_s=data.window_s)
        result["breakdown"] = {"device_ops": data.device_ops, "idle_gaps": data.idle_gaps}
    result["checks"] = {name: {"value": _number(value), "limit": limit} for name, (value, limit) in checks.items()}
    return result

