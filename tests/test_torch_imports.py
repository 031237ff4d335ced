"""The port imports neither JAX, flax nor anything of the JAX package
(``stamp_tpu``), and imports without triton, h5py, scikit-learn, nvcc or a
GPU (the card's machine has no h5py and no scikit-learn).  Checked
in a fresh interpreter that imports every module of the port: this test
process has jax and stamp_tpu loaded already (tests/conftest.py)."""

import json
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

_PROBE = r"""
import importlib.abc
import json
import sys


class _Refuse(importlib.abc.MetaPathFinder):
    # act as if triton, h5py and scikit-learn were not installed, whatever
    # this machine has
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("triton", "h5py", "sklearn"):
            raise ModuleNotFoundError(f"No module named {name!r}")
        return None


sys.meta_path.insert(0, _Refuse())

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
    "library_loaded": build._lib is not None,
}))
"""


def test_port_imports_without_jax_triton_h5py_or_nvcc(tmp_path):
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on the path
    env["HOME"] = str(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    seen = json.loads(proc.stdout.strip().splitlines()[-1])
    # every module of the port, the deploy, training and encoding slices' among them
    assert {
        "stamp_tpu_torch.__main__",
        "stamp_tpu_torch.encoding.encoder._virtual_slide",
        "stamp_tpu_torch.encoding.encoder.titan",
        "stamp_tpu_torch.encoding.init",
        "stamp_tpu_torch.models.slide_encoders",
        "stamp_tpu_torch.modeling.crossval",
        "stamp_tpu_torch.modeling.deploy",
        "stamp_tpu_torch.modeling.splits",
        "stamp_tpu_torch.modeling.train",
        "stamp_tpu_torch.models.vision_transformer",
        "stamp_tpu_torch.ops.flash_attention",
        "stamp_tpu_torch.preprocessing.extract",
    } <= set(seen.pop("imported"))
    assert seen == {
        "jax": [], "flax": [], "stamp_tpu": [], "triton": False, "h5py": False,
        "sklearn": False, "library_loaded": False,
    }


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
