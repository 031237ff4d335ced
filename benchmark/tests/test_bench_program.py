"""The readers of the port's own spans and counts: only the records inside
the traced window count, and a port that keeps none gives no metric."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.runner import run_cell
from benchmark.harness.spec import ROOT
from benchmark.harness.trace import TraceData
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.profiling import Count, Span

from conftest import tiny_cell

W0, W1 = 1_000_000_000, 2_000_000_000  # the window, ns


def _metric(name: str):
    return spec.load_module(ROOT / "benchmark" / "metrics" / f"{name}.py")


def _trace() -> TraceData:
    spans = [(W0 - 5_000, W1 + 5_000, "bench/setup"), (W0, W1, "bench/window"), (W0 + 10, W0 + 20, "bench/step")]
    return TraceData(window_s=(W1 - W0) / 1e9, busy_s=0.5, spans=spans, ops={}, device_ops=[], idle_gaps=[])


def _span(i: int, name: str, start: int, end: int, self_ns: int | None = None, parent: int | None = None) -> Span:
    return Span(i, name, start, end, parent, i if parent is None else parent, 1, end - start if self_ns is None else self_ns)


RECORDS = [
    _span(0, "extract/upload", W0 - 3_000_000, W0 + 1_000_000),  # starts before the window
    _span(1, "extract/upload", W0 + 1_000_000, W0 + 5_000_000),  # 4 ms
    _span(2, "extract/upload", W0 + 10_000_000, W0 + 12_000_000),  # 2 ms
    _span(3, "extract/upload", W1 - 1_000_000, W1 + 1_000_000),  # ends after it
    _span(4, "train/loss", W0 + 20_000_000, W0 + 30_000_000, self_ns=6_000_000, parent=9),
    _span(5, "train/loss", W0 + 40_000_000, W0 + 50_000_000, self_ns=8_000_000, parent=10),
    _span(6, "train/loss", W1 + 10, W1 + 20),
    Count(W0 - 1, "train/tiles", 1_000_000),
    Count(W0 + 100, "train/tiles", 3_000),
    Count(W0 + 100, "train/rows", 4_096),
    Count(W0 + 200, "train/tiles", 5_000),
    Count(W0 + 200, "train/rows", 8_192),
    Count(W1 + 1, "train/rows", 1),
]


@pytest.fixture
def records(monkeypatch):
    found: list = []
    monkeypatch.setattr(profiling, "records", lambda: list(found))
    return found


@pytest.mark.parametrize(("name", "want"), [
    ("upload_ms_per_batch.extract", 3.0),  # (4 + 2) / 2
    ("loss_ms_per_step.train", 7.0),  # self times (6 + 8) / 2
    ("valid_rows_pct.train", 100.0 * 8_000 / 12_288),
])  # fmt: skip
def test_readers_keep_only_the_window(records, name, want):
    records.extend(RECORDS)
    assert _metric(name).read(_trace()) == pytest.approx(want)


@pytest.mark.parametrize("name", ["upload_ms_per_batch.extract", "loss_ms_per_step.train", "valid_rows_pct.train"])
def test_readers_find_nothing(records, monkeypatch, name):
    trace = _trace()
    assert _metric(name).read(trace) is None  # no records at all
    records.extend(r for r in RECORDS if r.name not in ("extract/upload", "train/loss", "train/tiles"))
    assert _metric(name).read(trace) is None  # records, but none of this metric's inside the window
    records.extend(RECORDS)
    monkeypatch.delattr(profiling, "records")  # a port that keeps no records
    assert _metric(name).read(trace) is None


def test_a_traced_tiny_cell_reads_the_program(tiny_uni2):
    """A tiny whole-slide cell, traced on the CPU: the port's counters give
    the share of valid rows of its padded bags, and its loss spans a time."""
    cell = tiny_cell("mil_vit.train.wholeslide", {"loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2})
    result = run_cell(cell, 2**31 + 5, 0.3, True, torch.device("cpu"), time.perf_counter())
    metrics = result["metrics"]
    assert 0.0 < metrics["valid_rows_pct.train"]["value"] < 100.0
    assert metrics["loss_ms_per_step.train"]["value"] > 0.0
    extract = tiny_cell("uni2.extract.bf16", {"feat_rel_err_max": 0.5, "feat_rel_err_median": 0.5})
    line = run_cell(extract, 2**31 + 5, 0.3, True, torch.device("cpu"), time.perf_counter())
    assert line["metrics"]["upload_ms_per_batch.extract"]["value"] > 0.0
