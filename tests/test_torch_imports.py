"""The port imports neither JAX, flax nor anything of the JAX package
(``stamp_tpu``), and imports without triton, h5py, scikit-learn,
matplotlib, nvcc or a GPU (the card's machine has no h5py, scikit-learn or
matplotlib).  Checked in a fresh interpreter that imports every module of
the port: this test process has jax and stamp_tpu loaded already
(tests/conftest.py).  ``statistics`` and ``heatmaps`` also run there with
matplotlib and scikit-learn refused."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_REFUSE = r"""
import importlib.abc
import json
import sys


class _Refuse(importlib.abc.MetaPathFinder):
    # act as if triton, h5py, scikit-learn and matplotlib were not
    # installed, whatever this machine has
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("triton", "h5py", "sklearn", "matplotlib"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None


sys.meta_path.insert(0, _Refuse())
"""


_IMPORT_EVERY_MODULE = _REFUSE + r"""
import importlib
import pkgutil

import stamp_tpu_torch
import stamp_tpu_torch.ops._build as build

imported = []
for info in pkgutil.walk_packages(stamp_tpu_torch.__path__, "stamp_tpu_torch."):
    importlib.import_module(info.name)
    imported.append(info.name)


def loaded(top):
    return sorted(m for m in sys.modules if m == top or m.startswith(top + "."))


print(json.dumps({
    "imported": imported,
    "jax": loaded("jax"),
    "flax": loaded("flax"),
    "stamp_tpu": loaded("stamp_tpu"),
    "triton": "triton" in sys.modules,
    "h5py": "h5py" in sys.modules,
    "sklearn": "sklearn" in sys.modules,
    "matplotlib": "matplotlib" in sys.modules,
    "library_loaded": build._lib is not None,
}))
"""


def _run(probe: str, tmp_path, *args: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on the path
    env["HOME"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", probe, *args],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_port_imports_without_jax_triton_h5py_or_nvcc(tmp_path):
    proc = _run(_IMPORT_EVERY_MODULE, tmp_path)
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    # every module of the port, the deploy, training, encoding, model-zoo,
    # extractor-family and encoder-zoo slices' among them
    assert {
        "stamp_tpu_torch.__main__",
        "stamp_tpu_torch.encoding.encoder._virtual_slide",
        "stamp_tpu_torch.encoding.encoder.titan",
        "stamp_tpu_torch.encoding.encoder._weights",
        "stamp_tpu_torch.encoding.encoder.chief",
        "stamp_tpu_torch.encoding.encoder.cobra",
        "stamp_tpu_torch.encoding.encoder.eagle",
        "stamp_tpu_torch.encoding.encoder.gigapath",
        "stamp_tpu_torch.encoding.encoder.madeleine",
        "stamp_tpu_torch.encoding.encoder.prism",
        "stamp_tpu_torch.models.slide_encoders_cobra",
        "stamp_tpu_torch.models.slide_encoders_longnet",
        "stamp_tpu_torch.ops.dilated_attention",
        "stamp_tpu_torch.ops.ssd",
        "stamp_tpu_torch.encoding.init",
        "stamp_tpu_torch.models.slide_encoders",
        "stamp_tpu_torch.heatmaps._colormaps",
        "stamp_tpu_torch.heatmaps.generate",
        "stamp_tpu_torch.modeling.crossval",
        "stamp_tpu_torch.modeling.deploy",
        "stamp_tpu_torch.modeling.interop",
        "stamp_tpu_torch.modeling.registry",
        "stamp_tpu_torch.modeling.splits",
        "stamp_tpu_torch.modeling.train",
        "stamp_tpu_torch.models.barspoon",
        "stamp_tpu_torch.models.beit3",
        "stamp_tpu_torch.models.clip_vision",
        "stamp_tpu_torch.models.coca",
        "stamp_tpu_torch.models.swin",
        "stamp_tpu_torch.models.ticon",
        "stamp_tpu_torch.models.towers",
        "stamp_tpu_torch.ops.macenko",
        "stamp_tpu_torch.preprocessing.extractor.clip_like",
        "stamp_tpu_torch.preprocessing.extractor.coca_beit3",
        "stamp_tpu_torch.preprocessing.extractor.empty",
        "stamp_tpu_torch.preprocessing.extractor.swin",
        "stamp_tpu_torch.preprocessing.extractor.ticon",
        "stamp_tpu_torch.preprocessing.extractor.zoo",
        "stamp_tpu_torch.models.mlp",
        "stamp_tpu_torch.models.trans_mil",
        "stamp_tpu_torch.models.vision_transformer",
        "stamp_tpu_torch.models.weights",
        "stamp_tpu_torch.ops.flash_attention",
        "stamp_tpu_torch.preprocessing.extract",
        "stamp_tpu_torch.statistics.core",
        "stamp_tpu_torch.statistics.metrics",
        "stamp_tpu_torch.statistics.plots",
        "stamp_tpu_torch.parallel.distributed",
        "stamp_tpu_torch.parallel.mesh",
        "stamp_tpu_torch.parallel.prefetch",
        "stamp_tpu_torch.parallel._fleet_launch",
        "stamp_tpu_torch.parallel._dist_dryrun",
        "stamp_tpu_torch.parallel._extract_fleet_dryrun",
    } <= set(seen.pop("imported"))
    assert seen == {
        "jax": [], "flax": [], "stamp_tpu": [], "triton": False, "h5py": False,
        "sklearn": False, "matplotlib": False, "library_loaded": False,
    }


_IMPORT_PARALLEL = _REFUSE + r"""
import importlib

for name in ("distributed", "mesh", "prefetch", "_fleet_launch", "_dist_dryrun", "_extract_fleet_dryrun"):
    importlib.import_module("stamp_tpu_torch.parallel." + name)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_parallel_modules_import_alone(tmp_path):
    """``stamp_tpu_torch.parallel.*`` alone loads no JAX, nothing of the JAX
    package, no matplotlib, scikit-learn or h5py."""
    proc = _run(_IMPORT_PARALLEL, tmp_path)
    tops = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "torch" in tops
    assert not tops & {"jax", "flax", "jaxlib", "stamp_tpu", "matplotlib", "sklearn", "h5py", "triton"}


_IMPORT_OPS_AND_MODELS = r"""
import importlib
import json
import pkgutil
import sys

import stamp_tpu_torch.models
import stamp_tpu_torch.ops

names = [info.name for package in (stamp_tpu_torch.ops, stamp_tpu_torch.models)
         for info in pkgutil.walk_packages(package.__path__, package.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(json.dumps({"imported": names, "parallel": sorted(m for m in sys.modules if m.startswith("stamp_tpu_torch.parallel"))}))
"""


def test_ops_and_models_import_nothing_of_the_parallel_layer(tmp_path):
    """The layering: a step hands its collectives to the forward
    (``ops.step_group``), so no module under ``ops/`` or ``models/`` imports
    ``stamp_tpu_torch.parallel``, at the top or inside a function (read
    from the sources), nor loads it through another module (a fresh
    interpreter that imports all of them)."""
    import ast

    package = REPO / "stamp_tpu_torch"
    for path in sorted([*(package / "ops").rglob("*.py"), *(package / "models").rglob("*.py")]):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [f"{node.module}.{a.name}" for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any(n.startswith("stamp_tpu_torch.parallel") for n in names), (path, ast.dump(node))
    seen = json.loads(_run(_IMPORT_OPS_AND_MODELS, tmp_path).stdout.strip().splitlines()[-1])
    assert "stamp_tpu_torch.ops.step_group" in seen["imported"] and "stamp_tpu_torch.models.trans_mil" in seen["imported"]
    assert seen["parallel"] == []


_WITHOUT_MATPLOTLIB = _REFUSE + r"""
import logging
import sys
from pathlib import Path

from stamp_tpu_torch.heatmaps.generate import heatmaps_
from stamp_tpu_torch.statistics import compute_stats_

logging.basicConfig(level=logging.WARNING, format="%(message)s")
root = Path(sys.argv[1])
compute_stats_(task="classification", output_dir=root / "stats", pred_csvs=[root / "patient-preds.csv"],
               ground_truth_label="gt", true_class="b")
heatmaps_(feature_dir=root / "feats", wsi_dir=root / "wsi", checkpoint_path=root / "model.ckpt",
          output_dir=root / "heatmaps", slide_paths=None, device="cpu", default_slide_mpp=256 / 224,
          opacity=0.6, topk=1, bottomk=1)
assert "matplotlib" not in sys.modules and "sklearn" not in sys.modules
"""


def test_statistics_and_heatmaps_without_matplotlib_or_sklearn(tmp_path):
    """Every table, ``raw/`` image and tile crop is written; each figure
    that needs matplotlib is named in one warning per command."""
    import heatmaps_util
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(0)
    probs = rng.random(30)
    pd.DataFrame({"PATIENT": [f"p{i}" for i in range(30)], "gt": np.where(rng.random(30) < probs, "b", "a"),
                  "gt_a": 1 - probs, "gt_b": probs}).to_csv(tmp_path / "patient-preds.csv", index=False)  # fmt: skip
    heatmaps_util.write_slide(tmp_path)
    heatmaps_util.write_checkpoint(tmp_path / "model.ckpt", "classification")
    proc = _run(_WITHOUT_MATPLOTLIB, tmp_path, str(tmp_path))

    stats = tmp_path / "stats"
    assert sorted(p.name for p in stats.iterdir()) == [
        "gt_categorical-stats_aggregated.csv", "gt_categorical-stats_individual.csv",
    ]  # fmt: skip
    raw = sorted(p.name for p in (tmp_path / "heatmaps" / "slide1" / "raw").iterdir())
    panels = [p for p in raw if "=" in p]  # slide1-{category}={probability}.png
    assert [p.split("=")[0] for p in panels] == ["slide1-a", "slide1-b", "slide1-c"]
    assert raw == sorted(["slide1-classmap.png", "thumbnail-slide1.png", *panels,
                          *(f"raw-overlay-slide1-{c}.png" for c in "abc")])  # fmt: skip
    assert len(list((tmp_path / "heatmaps" / "slide1" / "tiles").iterdir())) == 2
    assert not list((tmp_path / "heatmaps" / "slide1" / "plots").iterdir())
    warnings = [line for line in proc.stderr.splitlines() if "matplotlib is not installed" in line]
    assert len(warnings) == 2
    for name in ("roc-curve_gt=b.svg", "pr-curve_gt=b.svg"):
        assert str(stats / name) in warnings[0]
    for name in ("overview-slide1.png", *(f"overlay-slide1-{c}.png" for c in "abc")):
        assert str(tmp_path / "heatmaps" / "slide1" / "plots" / name) in warnings[1]


def test_port_sources_name_no_jax_import():
    """No module of the port (nor chip_smoke.py) has an import of jax, flax
    or the JAX package: ``import stamp_tpu``, ``from stamp_tpu import`` and
    ``from stamp_tpu.… import`` are refused as much as ``import jax``."""
    sources = sorted((REPO / "stamp_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for src in sources:
        for line in src.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                for module in " ".join(words[1:]).split(" import ")[0].split(","):
                    top = module.strip().split(" ")[0].split(".")[0]
                    assert top not in ("jax", "flax", "jaxlib", "stamp_tpu"), f"{src}: {line}"
