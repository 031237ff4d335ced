"""The shape of a run's last line, and a run without a card."""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.harness.runner import run_cell
from benchmark.harness.spec import ROOT

from conftest import tiny_cell

LOOSE = {"feat_rel_err_max": 0.5, "feat_rel_err_median": 0.5, "loss_gap": 1e-3, "grad_gap": 1e-2, "change_gap": 1e-2}


@pytest.mark.parametrize("workload", ["uni2.extract.bf16", "mil_vit.train.bag512"])
@pytest.mark.parametrize("trace", [False, True])
def test_result_line(workload, trace, tiny_uni2):
    cell = tiny_cell(workload, {k: v for k, v in LOOSE.items() if k in tiny_cell(workload).limits})
    result = run_cell(cell, 2**31 + 11, 0.3, trace, torch.device("cpu"), time.perf_counter())
    line = json.loads(json.dumps(result))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(cell.limits) <= set(line["checks"])
    assert all(set(c) == {"value", "limit"} for c in line["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    wanted = cell.per_layer if trace else cell.end_to_end
    for name, metric in line["metrics"].items():
        assert metric["unit"] == next(m["unit"] for m in wanted if m["name"] == name)
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert all(len(v) <= 10 for v in line["breakdown"].values())
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}


def test_no_card_no_result():
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "uni2.extract.bf16", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)  # fmt: skip
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert run.returncode != 0 and run.stdout == ""
    assert "CUDA device" in run.stderr
