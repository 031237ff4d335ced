"""Every cell end to end on the card, briefly: ``python -m pytest -m cuda benchmark/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec
from benchmark.harness.spec import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w["name"] for w in spec.load_spec()["workloads"]])
def test_cell_runs_correct_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA GPU")
    run = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload, "--seed", "2147483651",
                          "--seconds", "2", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=1200)  # fmt: skip
    assert run.returncode == 0, run.stderr[-3000:]
    line = json.loads(run.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
