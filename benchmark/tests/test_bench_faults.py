"""``correct`` comes out false for the control and for each fault a cell can
have, with the cell's own limits, at tiny widths on the CPU (the harness's
look for a card skipped, the rest of a run driven)."""

from __future__ import annotations

import time

import pytest
import torch

from benchmark.harness.runner import run_cell

from conftest import tiny_cell

CASES = [
    ("uni2.extract.bf16", {}, True),
    ("uni2.extract.bf16", {"control": True}, False),
    ("uni2.extract.bf16", {"fault": "answer_altered"}, False),
    ("uni2.extract.w8a8", {}, True),
    ("uni2.extract.w8a8", {"control": True}, False),
    ("uni2.extract.w8a8", {"fault": "answer_altered"}, False),
    ("mil_vit.train.wholeslide", {}, True),
    ("mil_vit.train.wholeslide", {"control": True}, False),
    ("mil_vit.train.wholeslide", {"fault": "state_unchanged"}, False),
    ("mil_vit.train.wholeslide", {"fault": "answer_altered"}, False),
    ("mil_vit.train.bag512", {}, True),
    ("mil_vit.train.bag512", {"control": True}, False),
    ("mil_vit.train.bag512", {"fault": "state_unchanged"}, False),
    ("mil_vit.train.bag512", {"fault": "half_batch"}, False),
    ("mil_vit.train.bag512", {"fault": "answer_altered"}, False),
]


@pytest.mark.parametrize(("workload", "planted", "correct"), CASES)
def test_correct(workload, planted, correct, tiny_uni2):
    result = run_cell(tiny_cell(workload), 2**31 + 19, 0.3, False, torch.device("cpu"), time.perf_counter(), **planted)
    assert result["correct"] is correct, result["checks"]
