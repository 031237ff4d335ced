"""The port's TITAN slide and patient encoding against the JAX package's, on
the CPU: ``flash_alibi2d_mha`` (against the Pallas kernel in interpret
mode), ``TitanViT`` on its dense path and on its kernel path (the JAX
package made to take its Pallas branch), the weight carry-over and the
upstream checkpoint loader, and ``encode_slides`` / ``encode_patients``
through both CLIs from the same checkpoint."""

import functools
import logging
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from jax.experimental import pallas as pl

from stamp_tpu.models import slide_encoders as jax_se
from stamp_tpu_torch.io.h5 import write_tile_feats_atomic
from stamp_tpu_torch.models import slide_encoders as torch_se
from stamp_tpu_torch.ops import flash_attention as torch_attn

_SMALL = dict(dim=64, depth=2, num_heads=4)


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run Pallas kernels in interpreter mode (no TPU here)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


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


def test_flash_alibi2d_mha_matches_jax(interpret_pallas):
    """Integer coordinates, the CLS row/column exemption, N off the block
    sizes (the test_ops.py case)."""
    from stamp_tpu.ops.flash_attention import flash_alibi2d_mha

    rng = np.random.default_rng(4)
    bh, n, d = 3, 300, 32
    q, k, v = (rng.normal(size=(bh, n, d)).astype(np.float32) for _ in range(3))
    coords = rng.integers(0, 40, size=(bh, n, 2)).astype(np.float32)
    slopes = np.asarray([0.5, 0.1, 0.02], np.float32)
    for exempt in (True, False):
        ref = flash_alibi2d_mha(*map(jnp.asarray, (q, k, v, coords, slopes)), exempt_first=exempt, block_q=128, block_k=128)
        got = torch_attn.flash_alibi2d_mha(*map(torch.from_numpy, (q, k, v, coords, slopes)), exempt_first=exempt)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)
    assert torch_attn.FLASH_ALIBI2D_LAUNCHES == 0  # the CPU takes the plain version


def test_alibi_slopes_match_jax():
    for heads in (4, 12):
        np.testing.assert_array_equal(torch_se.alibi_slopes(heads), jax_se.alibi_slopes(heads))


def _jax_titan(flash_min_tiles: int = 2048, feat_dim: int = 48):
    module = jax_se.TitanViT(**_SMALL, flash_min_tiles=flash_min_tiles)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((4, feat_dim)), jnp.zeros((4, 2), jnp.int32))
    return module, jax.tree_util.tree_map(np.asarray, variables)


def _torch_titan(variables: dict, flash_min_tiles: int = 2048, feat_dim: int = 48) -> torch_se.TitanViT:
    model = torch_se.TitanViT(**_SMALL, flash_min_tiles=flash_min_tiles, feat_dim=feat_dim).eval()
    model.load_state_dict(torch_se.variables_from_jax(variables, _SMALL["depth"]))  # strict
    return model


def _slide(n: int, feat_dim: int = 48, seed: int = 0):
    """Features and an integer grid of a slide-shaped tissue region."""
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(n, feat_dim)).astype(np.float32)
    side = int(np.ceil(np.sqrt(n * 1.5)))
    cells = rng.choice(side * side, size=n, replace=False)
    grid = np.stack([cells % side, cells // side], axis=1).astype(np.int64)
    return feats, grid


def test_variables_round_trip():
    _, variables = _jax_titan()
    sd = torch_se.variables_from_jax(variables, _SMALL["depth"])
    assert set(sd) == set(torch_se.TitanViT(**_SMALL, feat_dim=48).state_dict())
    back = torch_se.variables_to_jax(sd, _SMALL["depth"])
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))


def test_titan_dense_path_matches_jax():
    module, variables = _jax_titan()
    feats, grid = _slide(300)
    ref = np.asarray(module.apply(variables, jnp.asarray(feats), jnp.asarray(grid)))
    with torch.inference_mode():
        got = _torch_titan(variables)(torch.from_numpy(feats), torch.from_numpy(grid)).numpy()
    assert got.shape == ref.shape == (64,)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_titan_kernel_path_matches_jax(interpret_pallas, monkeypatch):
    """Both packages on their flash branch at 300 tiles: the JAX package
    through its Pallas kernel (its backend made to read "tpu"), the port
    through ``flash_alibi2d_mha`` (its plain version on the CPU): CLS
    coordinates at (0, 0), no ``+1e-12`` in the distance."""
    monkeypatch.setattr(jax_se.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(torch_se, "_use_flash_kernel", lambda n, min_tiles, device: n >= min_tiles)
    calls = []
    plain = torch_attn.flash_alibi2d_mha_reference
    monkeypatch.setattr(
        torch_se, "flash_alibi2d_mha", lambda *a, **kw: calls.append(a[0].shape) or plain(*a, **kw)
    )
    module, variables = _jax_titan(flash_min_tiles=256)
    feats, grid = _slide(300, seed=1)
    ref = np.asarray(module.apply(variables, jnp.asarray(feats), jnp.asarray(grid)))
    with torch.inference_mode():
        got = _torch_titan(variables, flash_min_tiles=256)(torch.from_numpy(feats), torch.from_numpy(grid)).numpy()
    assert calls == [(_SMALL["num_heads"], 301, _SMALL["dim"] // _SMALL["num_heads"])] * _SMALL["depth"]
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def _upstream_checkpoint(model: torch_se.TitanViT) -> dict[str, torch.Tensor]:
    """``model``'s weights under an upstream checkpoint's names: a
    ``model.`` prefix, ``patch_embed.proj.*`` and a [1, 1, dim] CLS token."""
    sd = {}
    for key, value in model.state_dict().items():
        key = key.replace("patch_embed.", "patch_embed.proj.")
        sd["model." + key] = value.reshape(1, 1, -1) if key == "cls_token" else value
    sd["model.head.weight"] = torch.zeros(3)  # ignored by both loaders
    return sd


def test_checkpoint_loader_matches_jax_converter():
    model = torch_se.init_random_weights_(torch_se.TitanViT(**_SMALL, feat_dim=48), torch.Generator().manual_seed(3))
    ckpt = _upstream_checkpoint(model)
    loaded = torch_se.load_titan_state_dict(ckpt, torch_se.TitanViT(**_SMALL, feat_dim=48))
    for key, value in model.state_dict().items():
        torch.testing.assert_close(loaded[key], value, rtol=0, atol=0, msg=key)
    want = jax_se.convert_titan_state_dict({k: v.numpy() for k, v in ckpt.items()}, depth=_SMALL["depth"])
    back = torch_se.variables_to_jax(loaded, _SMALL["depth"])
    flat_want = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_want) == len(flat_back)
    for path, leaf in flat_want:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))
    del ckpt["model.norm.weight"]
    with pytest.raises(KeyError, match="norm.weight"):
        torch_se.load_titan_state_dict(ckpt, torch_se.TitanViT(**_SMALL, feat_dim=48))


# --- encode_slides / encode_patients through both CLIs ---------------------------


def _write_cohort(feat_dir, tiles: dict[str, int], extractor: dict[str, str]) -> None:
    """CONCH1.5-attributed tile-feature files (768-d, 256 µm tiles on a
    grid), written with the port's writer; ``extractor`` overrides the
    attribute per slide."""
    rng = np.random.default_rng(9)
    for name, n in tiles.items():
        side = int(np.ceil(np.sqrt(n)))
        idx = np.arange(n)
        coords = (np.stack([idx % side, idx // side], axis=1) * 256.0).astype(np.float32)
        write_tile_feats_atomic(
            output_path=feat_dir / f"{name}.h5", feats=rng.normal(size=(n, 768)).astype(np.float16),
            coords_um=coords, extractor_id=extractor.get(name, "conch1_5-0123abcd"), tile_size_um=256.0,
            tile_size_px=224, code_hash="test", precision="int8" if name == "s1" else None,
        )  # fmt: skip


def _run_both(tmp_path, monkeypatch, command: str, section: dict) -> tuple:
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    name = "slide_encoding" if command == "encode_slides" else "patient_encoding"
    outs = []
    for package in ("jax", "torch"):
        config = tmp_path / f"{package}-{command}.yaml"
        out = tmp_path / package
        config.write_text(yaml.safe_dump({name: {**section, "output_dir": str(out), "generate_hash": False}}))
        if package == "jax":
            monkeypatch.setattr(sys, "argv", ["stamp", "-c", str(config), command])
            jax_main()
        else:
            torch_main(["-c", str(config), command])
        outs.append(out / ("titan-slide" if command == "encode_slides" else "titan-pat"))
    return tuple(outs)


def _read(path):
    with h5py.File(path) as h5:
        return np.asarray(h5["feats"]), dict(h5.attrs)


def test_encode_slides_and_patients_match_jax(tmp_path, monkeypatch, stamp_logger_handlers):
    """Both CLIs from one upstream checkpoint (full TITAN width: 768, 12
    layers, 12 heads): the same files, attributes and embeddings within
    1e-4.  A slide of another extractor is skipped by both."""
    feat_dir = tmp_path / "feats"
    tiles = {"s0": 40, "s1": 57, "s2": 23, "other": 30}
    _write_cohort(feat_dir, tiles, {"other": "uni"})
    pd.DataFrame({"PATIENT": ["p1", "p1", "p2", "p3"], "FILENAME": ["s0.h5", "s1.h5", "s2.h5", "other.h5"]}).to_csv(
        tmp_path / "slide.csv", index=False
    )
    weights = tmp_path / "weights"
    weights.mkdir()
    model = torch_se.init_random_weights_(torch_se.TitanViT(), torch.Generator().manual_seed(5))
    torch.save(_upstream_checkpoint(model), weights / "TITAN.bin")
    monkeypatch.setenv("STAMP_WEIGHTS_DIR", str(weights))
    monkeypatch.delenv("STAMP_RANDOM_WEIGHTS", raising=False)
    launches = torch_attn.FLASH_ALIBI2D_LAUNCHES

    jax_dir, torch_dir = _run_both(tmp_path, monkeypatch, "encode_slides", {"encoder": "titan", "feat_dir": str(feat_dir), "device": "cpu"})
    names = sorted(p.name for p in torch_dir.glob("*.h5"))
    assert names == sorted(p.name for p in jax_dir.glob("*.h5")) == ["s0.h5", "s1.h5", "s2.h5"]
    for name in names:
        (want, want_attrs), (got, got_attrs) = _read(jax_dir / name), _read(torch_dir / name)
        assert got.shape == want.shape == (768,) and got.dtype == np.float32
        for attr in ("encoder", "precision", "feat_type", "source_precision"):
            assert got_attrs.get(attr) == want_attrs.get(attr), (name, attr)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert _read(torch_dir / "s1.h5")[1]["source_precision"] == "int8"
    assert _read(torch_dir / "s0.h5")[1]["feat_type"] == "slide"

    jax_dir, torch_dir = _run_both(
        tmp_path, monkeypatch, "encode_patients",
        {"encoder": "titan", "feat_dir": str(feat_dir), "slide_table": str(tmp_path / "slide.csv"), "device": "cpu"},
    )  # fmt: skip
    names = sorted(p.name for p in torch_dir.glob("*.h5"))
    assert names == sorted(p.name for p in jax_dir.glob("*.h5")) == ["p1.h5", "p2.h5"]
    for name in names:
        (want, want_attrs), (got, got_attrs) = _read(jax_dir / name), _read(torch_dir / name)
        assert got.shape == want.shape == (768,)
        for attr in ("encoder", "precision", "feat_type", "source_precision"):
            assert got_attrs.get(attr) == want_attrs.get(attr), (name, attr)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    assert _read(torch_dir / "p1.h5")[1]["source_precision"] == "int8"
    assert torch_attn.FLASH_ALIBI2D_LAUNCHES == launches  # the CPU: no kernel


def test_virtual_slide_offsets_and_mpp(tmp_path):
    """A patient's slides side by side along x, each shifted by its
    predecessors' width plus one tile; mixed mpp raises."""
    from stamp_tpu_torch.encoding.encoder.titan import Titan

    feat_dir = tmp_path / "feats"
    _write_cohort(feat_dir, {"a": 9, "b": 4}, {})
    enc = Titan.__new__(Titan)  # no weights needed to assemble
    enc.required_extractors, enc._source_precisions = ["conch1_5"], set()
    feats, coords = enc._assemble_virtual_slide(feat_dir, ["a.h5", "b.h5", "missing.h5"], patient_id="p")
    assert feats.shape == (13, 768)
    np.testing.assert_array_equal(coords.coords_um[9:, 0], np.array([0, 1, 0, 1]) * 256.0 + 2 * 256.0 + 256.0)
    write_tile_feats_atomic(
        output_path=feat_dir / "c.h5", feats=np.zeros((2, 768), np.float16), coords_um=np.zeros((2, 2), np.float32),
        extractor_id="conch1_5", tile_size_um=256.0, tile_size_px=512, code_hash="test",
    )  # fmt: skip
    with pytest.raises(ValueError, match="same mpp"):
        enc._assemble_virtual_slide(feat_dir, ["a.h5", "c.h5"], patient_id="p")
