"""``encode_slides`` and ``encode_patients`` of the port against the JAX
package's, through both CLIs on the CPU, for CHIEF, EAGLE, COBRA, GigaPath,
PRISM and MADELEINE (TITAN's are in ``tests/test_torch_titan.py``).

The weights are the same in both packages: CHIEF's and EAGLE's random ones
(``STAMP_RANDOM_WEIGHTS=1``: the same numpy draws), the flax encoders' from
one upstream-layout checkpoint under ``STAMP_WEIGHTS_DIR`` written by the
torch oracles of ``tests/test_converter_parity.py``.  GigaPath, PRISM and
COBRA run at a small width (64, two layers; GigaPath with its published
segments and dilations) in both packages, MADELEINE at its published one;
the input widths are the extractors'.  A cohort holds slides of 20, 33 and
40 tiles (one with an int8 ``precision`` attribute) and one of another
extractor, which both skip; patients are two slides and one.  The h5
``feats`` agree within 1e-4 (absolute and relative) and the attributes are
equal."""

import functools
import logging
import sys

import h5py
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from test_converter_parity import _TorchCobra, _TorchLongNetViT, _TorchMadeleine, _TorchPrism

from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

# encoder → (the extractor its tiles need, their width, the width of its output)
ENCODERS = {
    "chief": ("chief-ctranspath", 768, 768),
    "eagle": ("ctranspath", 768, 1280),  # the output is Virchow2's
    "cobra": ("virchow2", 2560, 2560),
    "gigapath": ("gigapath", 1536, 64),
    "prism": ("virchow-full", 2560, 64),
    "madeleine": ("conch", 512, 512),
}
SLIDES = {"s0": 20, "s1": 33, "s2": 40}
_SMALL = {  # the module each package's encoder builds, made small
    "gigapath": ("LongNetViT", dict(dim=64, depth=2, num_heads=4)),
    "prism": ("PrismPerceiver", dict(dim=64, num_latents=16, depth=2, num_heads=4)),
    "cobra": ("CobraNet", dict(d_model=64)),
}


@pytest.fixture
def stamp_logger_handlers():
    """Drop the log handlers a CLI run adds to the shared "stamp" logger."""
    logger = logging.getLogger("stamp")
    before = list(logger.handlers)
    yield
    for handler in logger.handlers[:]:
        if handler not in before:
            logger.removeHandler(handler)
            handler.close()


def _coords(n: int) -> np.ndarray:
    idx = np.arange(n)
    return (np.stack([idx % 8, idx // 8], axis=1) * 256.0).astype(np.float32)


def _write(path, feats, coords, extractor, precision=None) -> None:
    write_tile_feats_atomic(
        output_path=path, feats=feats.astype(np.float16), coords_um=coords, extractor_id=extractor,
        tile_size_um=256.0, tile_size_px=224, code_hash="test", precision=precision,
    )  # fmt: skip


def _write_cohort(root, extractor: str, dim: int) -> None:
    rng = np.random.default_rng(21)
    for name, n in SLIDES.items():
        _write(root / "feats" / f"{name}.h5", rng.normal(size=(n, dim)), _coords(n), f"{extractor}-0123abcd",
               precision="int8" if name == "s1" else None)  # fmt: skip
    _write(root / "feats" / "other.h5", rng.normal(size=(12, 64)), _coords(12), "plip")
    pd.DataFrame({"PATIENT": ["p1", "p1", "p2", "p3"], "FILENAME": ["s0.h5", "s1.h5", "s2.h5", "other.h5"]}).to_csv(
        root / "slide.csv", index=False
    )


def _write_virchow2(root) -> None:
    """EAGLE's aggregation features (1280-d Virchow2) of the same tiles,
    s1's rows shuffled against its CTransPath file."""
    rng = np.random.default_rng(22)
    for name, n in SLIDES.items():
        order = rng.permutation(n) if name == "s1" else np.arange(n)
        _write(root / "virchow2" / f"{name}.h5", rng.normal(size=(n, 1280)), _coords(n)[order], "virchow2")


def _write_checkpoint(root, encoder: str) -> None:
    torch.manual_seed(23)
    if encoder == "gigapath":
        oracle = _TorchLongNetViT(d_in=1536, dim=64, depth=2, num_heads=4, segments=(128, 512, 2048, 8192),
                                  dilations=(1, 2, 4, 8))  # fmt: skip
        name, sd = "slide_encoder.pth", oracle.checkpoint()
    elif encoder == "prism":
        name, sd = "prism.bin", _TorchPrism(d_in=2560, dim=64, n_latents=16, depth=2, num_heads=4).checkpoint()
    elif encoder == "cobra":
        name, sd = "cobra.pth", _TorchCobra(d_in=2560, d_model=64, depth=2).checkpoint()
        sd |= {f"embed.512.{n}": p.detach().numpy() for n, p in torch.nn.Linear(512, 64).named_parameters()}
    else:
        name, sd = "madeleine.pt", _TorchMadeleine(d_in=512, dim=512, num_heads=4).checkpoint()
    (root / "weights").mkdir()
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, root / "weights" / name)


def _run_both(root, monkeypatch, command: str, section: dict) -> tuple:
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    name = "slide_encoding" if command == "encode_slides" else "patient_encoding"
    kind = "slide" if command == "encode_slides" else "pat"
    outs = []
    for package in ("jax", "torch"):
        config = root / f"{package}-{command}.yaml"
        out = root / package
        config.write_text(yaml.safe_dump({name: {**section, "output_dir": str(out), "generate_hash": False}}))
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["stamp", "-c", str(config), command])
            jax_main()
        else:
            torch_main(["-c", str(config), command])
        outs.append(out / f"{section['encoder']}-{kind}")
    return tuple(outs)


def _read(path):
    with h5py.File(path) as h5:
        return np.asarray(h5["feats"]), dict(h5.attrs)


def _assert_same_files(jax_dir, torch_dir, names: list[str], out_dim: int, feat_type: str) -> None:
    assert sorted(p.name for p in torch_dir.glob("*.h5")) == sorted(p.name for p in jax_dir.glob("*.h5")) == names
    for name in names:
        (want, want_attrs), (got, got_attrs) = _read(jax_dir / name), _read(torch_dir / name)
        assert got.shape == want.shape == (out_dim,) and got.dtype == np.float32
        for attr in ("encoder", "precision", "feat_type", "source_precision"):
            assert got_attrs.get(attr) == want_attrs.get(attr), (name, attr)
        assert got_attrs["feat_type"] == feat_type
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("encoder", list(ENCODERS))
def test_encode_slides_and_patients_match_jax(tmp_path, monkeypatch, stamp_logger_handlers, encoder):
    extractor, dim, out_dim = ENCODERS[encoder]
    _write_cohort(tmp_path, extractor, dim)
    section = {"encoder": encoder, "feat_dir": str(tmp_path / "feats"), "device": "cpu"}
    if encoder == "eagle":
        _write_virchow2(tmp_path)
        section["agg_feat_dir"] = str(tmp_path / "virchow2")
    if encoder in ("chief", "eagle"):
        monkeypatch.setenv("STAMP_RANDOM_WEIGHTS", "1")
    else:
        _write_checkpoint(tmp_path, encoder)
        monkeypatch.setenv("STAMP_WEIGHTS_DIR", str(tmp_path / "weights"))
        monkeypatch.delenv("STAMP_RANDOM_WEIGHTS", raising=False)
    if encoder in _SMALL:
        cls, kwargs = _SMALL[encoder]
        for package in ("stamp_tpu", "stamp_tpu_torch"):
            module = __import__(f"{package}.encoding.encoder.{encoder}", fromlist=[cls])
            monkeypatch.setattr(module, cls, functools.partial(getattr(module, cls), **kwargs))

    jax_dir, torch_dir = _run_both(tmp_path, monkeypatch, "encode_slides", section)
    _assert_same_files(jax_dir, torch_dir, ["s0.h5", "s1.h5", "s2.h5"], out_dim, "slide")
    assert _read(torch_dir / "s1.h5")[1]["source_precision"] == "int8"
    assert _read(torch_dir / "s0.h5")[1]["precision"] == (
        "torch.float16" if encoder in ("gigapath", "prism") else "torch.float32"
    )

    section["slide_table"] = str(tmp_path / "slide.csv")
    jax_dir, torch_dir = _run_both(tmp_path, monkeypatch, "encode_patients", section)
    _assert_same_files(jax_dir, torch_dir, ["p1.h5", "p2.h5"], out_dim, "patient")
    assert _read(torch_dir / "p1.h5")[1]["source_precision"] == "int8"

    # skip-if-exists: a rerun of the port writes nothing
    written = {p: p.stat().st_mtime_ns for p in torch_dir.glob("*.h5")}
    from stamp_tpu_torch.__main__ import main as torch_main

    torch_main(["-c", str(tmp_path / "torch-encode_patients.yaml"), "encode_patients"])
    assert {p: p.stat().st_mtime_ns for p in torch_dir.glob("*.h5")} == written


def test_eagle_refuses_another_tile_set_as_jax_does(tmp_path, monkeypatch):
    """A Virchow2 file whose coordinates are not the CTransPath file's (not
    just reordered) raises the JAX package's error in the paired reader."""
    from stamp_tpu.encoding.encoder.eagle import Eagle as JaxEagle
    from stamp_tpu_torch.encoding.encoder.eagle import Eagle

    monkeypatch.setenv("STAMP_RANDOM_WEIGHTS", "1")
    _write_cohort(tmp_path, "ctranspath", 768)
    rng = np.random.default_rng(24)
    coords = _coords(20)
    coords[3] += 1.0
    _write(tmp_path / "virchow2" / "s0.h5", rng.normal(size=(20, 1280)), coords, "virchow2")
    errors = []
    for encoder in (JaxEagle(), Eagle()):
        with pytest.raises(ValueError, match="tile sets differ") as e:
            encoder._paired_reader(tmp_path / "feats", tmp_path / "virchow2")(tmp_path / "feats" / "s0.h5")
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_missing_weights_raise_with_guidance(monkeypatch):
    """Every encoder without weights and without STAMP_RANDOM_WEIGHTS
    raises FileNotFoundError naming it, as the JAX package's do."""
    from stamp_tpu_torch.encoding.init import _resolve

    monkeypatch.delenv("STAMP_RANDOM_WEIGHTS", raising=False)
    for var in ("STAMP_WEIGHTS_DIR", "XDG_CACHE_HOME", "HF_HOME"):
        monkeypatch.setenv(var, "/nonexistent")
    for name in ("chief", "eagle", "titan", "cobra", "gigapath", "prism", "madeleine"):
        with pytest.raises(FileNotFoundError, match="STAMP_RANDOM_WEIGHTS"):
            _resolve(name)
