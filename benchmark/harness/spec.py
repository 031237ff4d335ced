"""The benchmark's specification: ``BENCHMARK.json`` and the files it names.

Whatever belongs to one configuration, traffic mix, cell or per-layer
metric is a file of its own, found by its name, so that a new one goes in
as new files and entries with no edit to a file that is there:

- ``configs/<config>.json`` (the path ``BENCHMARK.json`` gives): the
  widths, the precision, the peak the MFU divides by and the driver's name;
- ``traffic/<traffic>.json``: the traffic mix's parameters;
- ``limits/<workload>.json``: the cell's limits on the numbers that decide
  ``correct``;
- ``drivers/<driver>.py``: one per kind of entry (``extract``, ``train``);
- ``metrics/<metric>.py``: one per per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

#: the checkout: ``BENCHMARK.json`` lies at its root, this file under ``benchmark/harness/``
ROOT = Path(__file__).resolve().parents[2]


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything its files hold."""

    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: tuple[dict, ...]
    per_layer: tuple[dict, ...]
    bench_dir: Path

    @property
    def driver_name(self) -> str:
        return self.config["driver"]


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _for_cell(metric: dict, workload: str) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a per-layer metric names its cells."""
    return workload in metric["workloads"] if "workloads" in metric else True


def cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload``; raises KeyError naming the known ones."""
    spec = load_spec(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if workload not in entries:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; known: {sorted(entries)}")
    entry = entries[workload]
    config_entry = next(c for c in spec["configs"] if c["name"] == entry["config"])
    bench_dir = root / spec["paths"][0]
    end_to_end = tuple(m for m in spec["end_to_end"] if _for_cell(m, workload))
    per_layer = tuple(m for m in spec["per_layer"] if workload in m["workloads"])
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=json.loads((root / config_entry["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic" / f"{entry['traffic']}.json").read_text()),
        limits=json.loads((bench_dir / "limits" / f"{workload}.json").read_text()),
        end_to_end=end_to_end,
        per_layer=per_layer,
        bench_dir=bench_dir,
    )


def load_module(path: Path) -> ModuleType:
    """A module from its file (metric files carry dots in their names),
    loaded once per path."""
    name = "_bench_" + re.sub(r"\W", "_", str(path.resolve()))
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def driver(c: Cell) -> ModuleType:
    return load_module(c.bench_dir / "drivers" / f"{c.driver_name}.py")


def metric_reader(c: Cell, metric: str) -> ModuleType:
    """``metrics/<metric>.py``: ``read(trace) -> float | None`` and, for an
    op's roofline, ``WRAPS`` and ``describe``."""
    return load_module(c.bench_dir / "metrics" / f"{metric}.py")
