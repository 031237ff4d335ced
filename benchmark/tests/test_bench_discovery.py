"""A new configuration, traffic mix, cell and per-layer metric go in as new
files and entries in BENCHMARK.json, with no edit to a file that is there."""

from __future__ import annotations

import hashlib
import json
import shutil
import time

import torch

from benchmark.harness import spec
from benchmark.harness.runner import run_cell
from benchmark.harness.spec import ROOT

from conftest import TINY_MIL

NEW_METRIC = '''
def read(trace):
    steps = trace.span_seconds("bench/step")
    return float(len(steps)) if steps else None
'''


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "benchmark").rglob("*")) if p.is_file() and "__pycache__" not in p.parts}  # fmt: skip


def test_new_files_and_entries_are_found(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(tmp_path)
    bench = tmp_path / "benchmark"
    config = json.loads((bench / "configs" / "mil_vit.json").read_text())
    (bench / "configs" / "mil_small.json").write_text(json.dumps(dict(config, name="mil_small", **TINY_MIL)))
    (bench / "traffic" / "smallslides.json").write_text(json.dumps(
        {"patients": 6, "tiles_min": 30, "tiles_max": 600, "batch_size": 1, "bag_size": None, "train_share": 0.75,
         "compared_steps": 3, "late_steps": 2}))  # fmt: skip
    (bench / "limits" / "mil_small.train.small.json").write_text(json.dumps(
        {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3}))  # fmt: skip
    (bench / "metrics" / "steps_in_window.train.py").write_text(NEW_METRIC)
    spec_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_json["configs"].append({"name": "mil_small", "source": "https://example.org/mil", "reduced": [],
                                 "file": "benchmark/configs/mil_small.json", "why": "a test"})  # fmt: skip
    spec_json["workloads"].append({"name": "mil_small.train.small", "config": "mil_small", "traffic": "smallslides",
                                   "chips": 1, "why": "a test"})  # fmt: skip
    for metric in spec_json["end_to_end"]:
        if metric["name"] == "train_tiles_per_s":
            metric["workloads"].append("mil_small.train.small")
    spec_json["per_layer"].append({"name": "steps_in_window.train", "unit": "steps", "better": "higher",
                                   "source": "host_clock", "layer": "Training engine", "moves": "train_tiles_per_s",
                                   "workloads": ["mil_small.train.small"]})  # fmt: skip
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_json))

    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before  # nothing that was there changed

    cell = spec.cell("mil_small.train.small", root=tmp_path)
    assert cell.config["dim_model"] == TINY_MIL["dim_model"] and cell.traffic["patients"] == 6
    assert [m["name"] for m in cell.end_to_end] == ["train_tiles_per_s", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["steps_in_window.train"]
    device = torch.device("cpu")
    untraced = run_cell(cell, 3, 0.3, False, device, time.perf_counter())
    traced = run_cell(cell, 3, 0.3, True, device, time.perf_counter())
    assert untraced["correct"] and traced["correct"]
    assert set(untraced["metrics"]) == {"train_tiles_per_s", "setup_s"}
    assert traced["metrics"]["steps_in_window.train"]["value"] >= 1


def test_a_cell_reports_only_its_own_metrics():
    cell = spec.cell("uni2.extract.bf16")
    assert [m["name"] for m in cell.end_to_end] == ["extract_tiles_per_s", "setup_s"]
    names = {m["name"] for m in cell.per_layer}
    assert "ln_dense_roofline" in names and "ln_quant_dense_roofline" not in names


def test_every_named_file_exists():
    s = spec.load_spec()
    bench = ROOT / s["paths"][0]
    for config in s["configs"]:
        assert (ROOT / config["file"]).is_file()
    for workload in s["workloads"]:
        cell = spec.cell(workload["name"])
        assert (bench / "drivers" / f"{cell.driver_name}.py").is_file()
        assert (bench / "traffic" / f"{workload['traffic']}.json").is_file()
        assert (bench / "limits" / f"{workload['name']}.json").is_file()
    for metric in s["per_layer"]:
        assert callable(spec.metric_reader(spec.cell(metric["workloads"][0]), metric["name"]).read)
