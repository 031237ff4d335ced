"""The port's extraction slice end to end on the CPU: the same slide and the
same torch checkpoint through ``stamp_tpu``'s and ``stamp_tpu_torch``'s
``extract_``, compared h5 against h5; the port's CLI in a subprocess; and
the features that must raise instead of falling back."""

import logging
import os
import subprocess
import sys
from pathlib import Path

import h5py
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from stamp_tpu.models import vit_image as jax_vit
from stamp_tpu.types import Microns, TilePixels
from stamp_tpu_torch.models import vit_image as torch_vit
from stamp_tpu_torch.ops import flash_attention as torch_attn
from stamp_tpu_torch.ops import ln_dense as torch_ln_dense
from stamp_tpu_torch.utils.device import resolve_device

REPO = Path(__file__).resolve().parent.parent
_TINY = dict(patch_size=32, embed_dim=64, depth=1, num_heads=2)


@pytest.fixture
def synthetic_slide(tmp_path):
    """1536×1024 TIFF at 1 µm/px: left 2/3 textured 'tissue', right white."""
    rng = np.random.default_rng(0)
    arr = np.full((1024, 1536, 3), 255, np.uint8)
    arr[:, :1024] = rng.integers(60, 200, (1024, 1024, 3), dtype=np.uint8)
    slide_dir = tmp_path / "slides"
    slide_dir.mkdir()
    path = slide_dir / "slide.tif"
    Image.fromarray(arr).save(
        path,
        format="TIFF",
        compression="tiff_lzw",
        resolution=10000.0,
        resolution_unit=3,  # px per cm → 1 µm/px
    )
    return path


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


def _read_h5(path: Path):
    with h5py.File(path) as h5:
        attrs = dict(h5.attrs)
        feats = np.asarray(h5["feats"])
        coords = np.asarray(h5["coords"])
    order = np.lexsort((coords[:, 1], coords[:, 0]))
    return attrs, feats[order], coords[order]


def _extract_kwargs(slide: Path, out: Path) -> dict:
    return dict(
        wsi_dir=slide.parent,
        output_dir=out,
        wsi_list=None,
        cache_dir=None,
        cache_tiles_ext="jpg",
        tile_size_px=TilePixels(224),
        tile_size_um=Microns(256.0),
        max_workers=2,
        default_slide_mpp=None,
        brightness_cutoff=240,
        canny_cutoff=0.02,
        generate_hash=True,
    )


def test_extract_matches_jax_package(synthetic_slide, tmp_path, monkeypatch):
    from stamp_tpu.preprocessing.extract import extract_ as jax_extract
    from stamp_tpu.preprocessing.extractor import make_vit_extractor as jax_make
    from stamp_tpu_torch.preprocessing.extract import extract_ as torch_extract
    from stamp_tpu_torch.preprocessing.extractor import make_vit_extractor as torch_make

    monkeypatch.setitem(jax_vit.VIT_CONFIGS, "test-tiny", jax_vit.ViTConfig(**_TINY))
    monkeypatch.setitem(torch_vit.VIT_CONFIGS, "test-tiny", torch_vit.ViTConfig(**_TINY))
    weights = tmp_path / "weights"
    weights.mkdir()
    model = torch_vit.init_random_weights_(
        torch_vit.ImageViT(torch_vit.ViTConfig(**_TINY)), torch.Generator().manual_seed(3)
    )
    torch.save(model.state_dict(), weights / "test-tiny.bin")
    monkeypatch.setenv("STAMP_WEIGHTS_DIR", str(weights))
    monkeypatch.delenv("STAMP_RANDOM_WEIGHTS", raising=False)
    launches = (torch_attn.LAUNCHES, torch_ln_dense.LAUNCHES)

    factory = dict(identifier="test-tiny", arch="test-tiny", weight_files=["test-tiny.bin"])
    jax_extract(
        extractor=jax_make(**factory), **_extract_kwargs(synthetic_slide, tmp_path / "jax")
    )
    torch_extract(
        extractor=torch_make(**factory, device=torch.device("cpu")),
        device="cpu",
        **_extract_kwargs(synthetic_slide, tmp_path / "torch"),
    )

    (jax_h5,) = (tmp_path / "jax").rglob("*.h5")
    (torch_h5,) = (tmp_path / "torch").rglob("*.h5")
    # each package hashes its own sources into the artifact directory name
    assert jax_h5.parent.name.startswith("test-tiny-")
    assert torch_h5.parent.name.startswith("test-tiny-")
    assert jax_h5.parent.name != torch_h5.parent.name
    assert len(list((tmp_path / "torch").rglob("*.jpg"))) == 1  # rejection thumb

    jax_attrs, jax_feats, jax_coords = _read_h5(jax_h5)
    torch_attrs, torch_feats, torch_coords = _read_h5(torch_h5)
    assert jax_attrs.pop("code_hash") != torch_attrs.pop("code_hash")
    assert jax_attrs == torch_attrs
    np.testing.assert_array_equal(torch_coords, jax_coords)
    assert torch_feats.dtype == np.float16 and torch_feats.shape == jax_feats.shape
    assert len(torch_feats) == 16  # 4×4 tissue tiles
    # both packages run the backbone in bf16, rounding at different places
    a, b = torch_feats.astype(np.float32), jax_feats.astype(np.float32)
    np.testing.assert_allclose(a, b, atol=5e-2)
    cos = (a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1))
    assert (cos > 0.999).all(), cos.min()
    # on the CPU the wrappers run their plain versions: no kernel launched
    assert (torch_attn.LAUNCHES, torch_ln_dense.LAUNCHES) == launches == (0, 0)


def test_cli_preprocess_writes_h5(synthetic_slide, tmp_path):
    """``python -m stamp_tpu_torch -c config.yaml preprocess`` with
    ``device: cpu`` and random weights (DinoBloom-S, the zoo's smallest)."""
    out = tmp_path / "features"
    config = tmp_path / "config.yaml"
    config.write_text(
        yaml.safe_dump(
            {
                "preprocessing": {
                    "output_dir": str(out),
                    "wsi_dir": str(synthetic_slide.parent),
                    "extractor": "dino-bloom",
                    "device": "cpu",
                    "max_workers": 2,
                }
            }
        )
    )
    env = {
        **os.environ,
        "STAMP_RANDOM_WEIGHTS": "1",
        "STAMP_EXTRACT_BATCH": "16",
        "HOME": str(tmp_path),
    }
    proc = subprocess.run(
        [sys.executable, "-m", "stamp_tpu_torch", "-c", str(config), "preprocess"],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    (h5_path,) = out.rglob("*.h5")
    assert h5_path.parent.name.startswith("dino-bloom-")
    with h5py.File(h5_path) as h5:
        assert h5.attrs["extractor"] == "dino-bloom"
        feats = np.asarray(h5["feats"])
    assert feats.dtype == np.float16 and feats.shape == (16, 384)
    assert np.isfinite(feats).all() and np.abs(feats).max() > 0


def test_auto_device_raises_without_cuda(synthetic_slide, tmp_path, stamp_logger_handlers, caplog):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="device: cpu"):
        resolve_device("auto")
    with pytest.raises(RuntimeError, match="device: cpu"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("tpu")

    from stamp_tpu_torch.__main__ import main

    config = tmp_path / "config.yaml"
    config.write_text(
        yaml.safe_dump(
            {
                "preprocessing": {
                    "output_dir": str(tmp_path / "out"),
                    "wsi_dir": str(synthetic_slide.parent),
                    "extractor": "uni2",
                }
            }
        )
    )
    with pytest.raises(SystemExit) as exc:
        main(["-c", str(config), "preprocess"])
    assert exc.value.code != 0
    assert "is_available() is False" in caplog.text
    assert not list((tmp_path / "out").rglob("*.h5"))


@pytest.mark.parametrize("command", ["statistics", "heatmaps"])
def test_ported_subcommands_run(command, tmp_path, stamp_logger_handlers):
    """``python -m stamp_tpu_torch -c config.yaml statistics | heatmaps`` on
    the CPU (with matplotlib, which this machine has: the figures too)."""
    import heatmaps_util
    import pandas as pd

    from stamp_tpu_torch.__main__ import main

    out = tmp_path / "out"
    if command == "statistics":
        rng = np.random.default_rng(0)
        probs = rng.random(30)
        csv = tmp_path / "patient-preds.csv"
        pd.DataFrame({"PATIENT": [f"p{i}" for i in range(30)], "gt": np.where(rng.random(30) < probs, "b", "a"),
                      "gt_a": 1 - probs, "gt_b": probs}).to_csv(csv, index=False)  # fmt: skip
        section = {"output_dir": str(out), "pred_csvs": [str(csv)], "ground_truth_label": "gt", "true_class": "b"}
    else:
        wsi_dir, feat_dir = heatmaps_util.write_slide(tmp_path)
        ckpt = heatmaps_util.write_checkpoint(tmp_path / "model.ckpt", "classification")
        section = {"output_dir": str(out), "feature_dir": str(feat_dir), "wsi_dir": str(wsi_dir),
                   "checkpoint_path": str(ckpt), "device": "cpu", "topk": 1,
                   "default_slide_mpp": heatmaps_util.SLIDE_MPP}  # fmt: skip
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({command: section}))
    main(["-c", str(config), command])
    written = {str(p.relative_to(out)) for p in out.rglob("*") if p.is_file()}
    if command == "statistics":
        assert {"gt_categorical-stats_individual.csv", "gt_categorical-stats_aggregated.csv",
                "roc-curve_gt=b.svg", "pr-curve_gt=b.svg"} <= written  # fmt: skip
    else:
        assert {"slide1/raw/slide1-classmap.png", "slide1/raw/thumbnail-slide1.png",
                "slide1/plots/overview-slide1.png", "slide1/plots/overlay-slide1-a.png"} <= written  # fmt: skip
        assert len([w for w in written if "/tiles/" in w]) == 1


@pytest.mark.parametrize("command", ["export_ckpt"])
def test_unported_subcommands_exit_nonzero(command, tmp_path, stamp_logger_handlers, caplog):
    """Every subcommand is ported now (``export_ckpt`` last): a failing one
    exits non-zero with its error logged, here a source checkpoint that
    does not exist."""
    from stamp_tpu_torch.__main__ import main

    config = tmp_path / "config.yaml"
    config.write_text("{}\n")
    paths = [str(tmp_path / "model.ckpt"), str(tmp_path / "model.npz")] if command == "export_ckpt" else []
    with pytest.raises(SystemExit) as exc:
        main(["-c", str(config), command, *paths])
    assert exc.value.code != 0
    assert "model.ckpt" in caplog.text and "not yet ported" not in caplog.text


@pytest.mark.parametrize("command", ["encode_slides", "encode_patients"])
@pytest.mark.parametrize("encoder", ["chief", "eagle", "cobra", "gigapath", "prism", "madeleine"])
def test_unported_encoders_exit_nonzero(command, encoder, tmp_path, stamp_logger_handlers, caplog):
    """Only TITAN is ported: every other encoder names the JAX package's
    command."""
    from stamp_tpu_torch.__main__ import main

    section = "slide_encoding" if command == "encode_slides" else "patient_encoding"
    fields = {"encoder": encoder, "output_dir": str(tmp_path / "out"), "feat_dir": str(tmp_path), "device": "cpu"}
    if command == "encode_patients":
        fields["slide_table"] = str(tmp_path / "slide.csv")
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({section: fields}))
    with pytest.raises(SystemExit) as exc:
        main(["-c", str(config), command])
    assert exc.value.code != 0
    assert f"run `python -m stamp_tpu {command}`" in caplog.text
    assert not (tmp_path / "out").exists() or not list((tmp_path / "out").rglob("*.h5"))


def test_int8_and_macenko_raise(synthetic_slide, tmp_path, monkeypatch):
    from stamp_tpu_torch.preprocessing.extract import extract_
    from stamp_tpu_torch.preprocessing.extractor import (
        make_vit_extractor,
        set_int8_extraction,
    )
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    monkeypatch.setitem(torch_vit.VIT_CONFIGS, "test-tiny", torch_vit.ViTConfig(**_TINY))
    monkeypatch.setenv("STAMP_RANDOM_WEIGHTS", "1")
    cpu = torch.device("cpu")
    factory = dict(identifier="test-tiny", arch="test-tiny", device=cpu)
    assert make_vit_extractor(**factory).precision == "bfloat16"

    # int8 is ported: requested by the environment or the config layer, it
    # builds the W8A8 extractor, whose features go to their own directory
    monkeypatch.setenv("STAMP_INT8_EXTRACTION", "1")
    int8 = make_vit_extractor(**factory)
    assert int8.precision == "int8"
    monkeypatch.delenv("STAMP_INT8_EXTRACTION")
    set_int8_extraction(True)
    try:
        assert make_vit_extractor(**factory).precision == "int8"
    finally:
        set_int8_extraction(None)
    extract_(extractor=int8, device="cpu", **_extract_kwargs(synthetic_slide, tmp_path / "out"))
    (h5_path,) = (tmp_path / "out").rglob("*.h5")
    assert h5_path.parent.name.startswith("test-tiny-int8-")
    attrs, feats, _ = _read_h5(h5_path)
    assert attrs["precision"] == "int8" and feats.shape == (16, 64) and np.isfinite(feats).all()

    with pytest.raises(NotImplementedError, match="macenko"):
        extract_(
            extractor="uni2",
            macenko_normalization=True,
            device="cpu",
            **_extract_kwargs(synthetic_slide, tmp_path / "out"),
        )
    for family in ("ctranspath", "conch", "musk", "plip", "ticon", "empty"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_extractor(family, cpu)
