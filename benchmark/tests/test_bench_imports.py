"""Nothing the benchmark runs loads JAX or the JAX package (top-level names compared whole)."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from benchmark.harness.imports import forbidden
from benchmark.harness.spec import ROOT


@pytest.mark.parametrize(("names", "found"), [
    (["stamp_tpu_torch", "stamp_tpu_torch.ops.ln_dense", "jaxtyping", "flaxen", "torch"], []),
    (["stamp_tpu", "stamp_tpu.ops"], ["stamp_tpu", "stamp_tpu.ops"]),
    (["jax", "jaxlib.xla_client", "flax.linen", "numpy"], ["flax.linen", "jax", "jaxlib.xla_client"]),
])  # fmt: skip
def test_top_level_names_are_compared_whole(names, found):
    assert forbidden(names) == found


def test_no_source_of_the_benchmark_imports_them():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                [node.module] if isinstance(node, ast.ImportFrom) and node.module and not node.level else [])  # fmt: skip
            assert forbidden(names) == [], f"{path}: {names}"
            assert not any(n and n.split(".")[0] in ("bench", "chip_smoke", "scripts") for n in names), path


DRY_RUN = """
import dataclasses, sys, time
sys.path[:0] = [{root!r}, {tests!r}]
import torch
from benchmark.harness.imports import forbidden
from benchmark.harness.runner import run_cell
from stamp_tpu_torch.models import vit_image
from conftest import TINY_VIT, tiny_cell
vit_image.VIT_CONFIGS["uni2"] = dataclasses.replace(vit_image.VIT_CONFIGS["uni2"], **TINY_VIT)
for workload in ("uni2.extract.w8a8", "mil_vit.train.wholeslide"):
    run_cell(tiny_cell(workload), 1, 0.2, True, torch.device("cpu"), time.perf_counter())
print("FORBIDDEN", forbidden(sys.modules))
"""


def test_a_dry_run_loads_none_of_them():
    code = DRY_RUN.format(root=str(ROOT), tests=str(ROOT / "benchmark" / "tests"))
    run = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "FORBIDDEN []" in run.stdout
