"""The port's ``heatmaps`` against the JAX package on the same inputs and weights.

* the four colormap tables of ``heatmaps._colormaps`` against matplotlib,
  bitwise;
* Grad-CAM (per category and single), per-tile scores and attention rollout
  (dense, and streamed from (q, k)) against the JAX functions, the weights
  carried across with ``variables_from_jax``: max |Δ| ≤ 1e-4 of max |JAX|.
  The whole-slide case (4,096 tiles, T = 4,097, tiny widths) takes the
  port's flash wrappers (their plain versions on the CPU: the forward, the
  backward and the distance-weighted sum) against the JAX package's einsum
  path;
* ``heatmaps_`` end to end for classification, regression and survival with
  a cut-off: the same files as ``stamp_tpu``'s, the ``raw/`` PNGs equal up
  to one colormap step per channel where a value lies within rounding of a
  bin edge.  The port runs these without matplotlib (``pyplot`` gives
  None): its warning names exactly the ``plots/`` figures the JAX package
  drew.
"""

import logging

import jax
import numpy as np
import pytest
import torch
from matplotlib import colormaps
from PIL import Image

import heatmaps_util
import stamp_tpu.heatmaps.generate as jax_gen
from stamp_tpu.modeling.tasks import LitTileClassifier as JaxClassifier
from stamp_tpu.modeling.tasks import LitTileRegressor as JaxRegressor
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu_torch.heatmaps import _colormaps
from stamp_tpu_torch.heatmaps import generate as gen
from stamp_tpu_torch.models import vision_transformer as torch_vit
from stamp_tpu_torch.ops import flash_attention

REL_TOL = 1e-4  # max |Δ| / max |JAX|, f32 on both sides


@pytest.mark.parametrize("name", ["Pastel1", "RdBu_r", "Reds", "magma"])
def test_colormaps_bitwise(name):
    rng = np.random.default_rng(0)
    inputs = (
        rng.random((40, 30)).astype(np.float32),
        rng.random(500) * 1.4 - 0.2,  # under and over
        np.linspace(0.0, 1.0, 4097, dtype=np.float32),  # every bin edge
        np.array([0.0, 1.0, -0.0, np.nan, 1 - 1e-12, 1e-12]),
        rng.integers(-3, 300, (20, 20)),  # integers index directly
    )
    for x in inputs:
        got, want = _colormaps.apply(name, x), colormaps[name](x)
        assert got.dtype == want.dtype and np.array_equal(got, want, equal_nan=True), x.dtype


# --- the per-slide functions against the JAX package --------------------------


def _pair(task: str, use_alibi: bool, n_tiles: int, *, dim_model=16, n_heads=4, categories=("a", "b", "c"), seed=0):
    """(JAX task model, its variables, the port's module with the same
    weights, feats, coords) of one seeded bag."""
    rng = np.random.default_rng(seed)
    feat_dim = 8
    side = int(np.ceil(np.sqrt(n_tiles)))
    cells = np.stack([np.arange(n_tiles) % side, np.arange(n_tiles) // side], axis=1)
    coords = (cells * 256.0).astype(np.float32)
    feats = rng.normal(size=(n_tiles, feat_dim)).astype(np.float32)
    dims = dict(dim_input=feat_dim, dim_model=dim_model, n_heads=n_heads, n_layers=2, dim_feedforward=16,
                use_alibi=use_alibi)  # fmt: skip
    if task == "classification":
        model = JaxClassifier(model_class=JaxViT, ground_truth_label="gt", categories=list(categories),
                              category_weights=np.ones(len(categories), np.float32), model_name="vit",
                              **dims)  # fmt: skip
        targets = np.zeros((1, len(categories)), np.float32)
    else:
        model = JaxRegressor(model_class=JaxViT, ground_truth_label="t", model_name="vit", **dims)
        targets = np.zeros((1, 1), np.float32)
    example = (feats[None, :4], coords[None, :4], np.array([4]), targets)
    variables = model.init_variables(jax.random.PRNGKey(seed), example)
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(variables)))
    if use_alibi:  # the running mean of a cohort of such slides: the bias is of the softmax's order
        for i in range(2):
            variables["alibi_stats"][f"block_{i}"]["mhsa"]["running_mean"] = np.full(n_heads, 256.0 * side, np.float32)
    module = torch_vit.VisionTransformer(dim_output=len(categories) if task == "classification" else 1, **dims)
    module.load_state_dict(torch_vit.variables_from_jax(variables))
    return model, variables, module.eval(), feats, coords


def _assert_close(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max() / np.abs(want).max())
    assert err <= REL_TOL, err
    return err


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_gradcam_per_category_and_tile_scores_match_jax(use_alibi):
    model, variables, module, feats, coords = _pair("classification", use_alibi, 37)
    _assert_close(gen._gradcam_per_category(module, feats, coords),
                  jax_gen._gradcam_per_category(model, variables, feats, coords))  # fmt: skip
    _assert_close(gen._per_tile_scores(module, feats, coords),
                  jax_gen._per_tile_scores(model, variables, feats, coords))  # fmt: skip
    logits, _ = gen._cams(module, feats, coords)
    want = jax_gen._forward_fn(model, variables)(jax.numpy.asarray(feats), jax.numpy.asarray(coords))
    _assert_close(logits, want)


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_gradcam_single_matches_jax(use_alibi):
    model, variables, module, feats, coords = _pair("regression", use_alibi, 37)
    _assert_close(gen._gradcam_single(module, feats, coords), jax_gen._gradcam_single(model, variables, feats, coords))


@pytest.mark.parametrize("streamed", [False, True], ids=["dense", "streamed"])
@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_rollout_matches_jax(use_alibi, streamed, monkeypatch):
    model, variables, module, feats, coords = _pair("classification", use_alibi, 37)
    if streamed:
        monkeypatch.setattr(jax_gen, "STREAMING_ROLLOUT_MIN_SEQ", 1)
        monkeypatch.setattr(gen, "STREAMING_ROLLOUT_MIN_SEQ", 1)
    got = gen._attention_rollout_single(module, feats, coords)
    _assert_close(got, jax_gen._attention_rollout_single(model, variables, feats, coords))
    assert got.min() == 0.0 and got.max() <= 1.0 + 1e-6


def test_whole_slide_gradcam_and_rollout_take_the_flash_path(monkeypatch):
    """4,096 tiles (T = 4,097, ragged, no key mask): the port's ALiBi flash
    wrapper, forward and backward, against the JAX package's einsum path."""
    model, variables, module, feats, coords = _pair("classification", True, 4096, dim_model=8, n_heads=2,
                                                    categories=("a", "b"))  # fmt: skip
    calls = []
    wrapper = flash_attention.flash_alibi_mha
    monkeypatch.setattr(flash_attention, "flash_alibi_mha", lambda *a: calls.append(a[0].shape) or wrapper(*a))
    cam = gen._gradcam_per_category(module, feats, coords)
    assert calls == [(2, 4097, 4)] * 2  # one forward: 2 layers of 2 heads
    _assert_close(cam, jax_gen._gradcam_per_category(model, variables, feats, coords))
    assert gen.STREAMING_ROLLOUT_MIN_SEQ <= 4096
    _assert_close(gen._attention_rollout_single(module, feats, coords),
                  jax_gen._attention_rollout_single(model, variables, feats, coords))  # fmt: skip


def test_retained_graph_gives_each_cam_alone():
    """The cam of one output after another's backward (the graph kept)
    equals it computed alone: the backward leaves its saved tensors as they
    were."""
    _, _, module, feats, coords = _pair("classification", True, 37)
    _, both = gen._cams(module, feats, coords, [0, 2])
    _, alone = gen._cams(module, feats, coords, [2])
    assert np.array_equal(both[1], alone[0])


# --- heatmaps_ end to end ----------------------------------------------------


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


_STEPS = {  # the largest change of a uint8 channel between neighbouring table entries
    name: int(np.abs(np.diff(np.uint8(colormaps[name](np.arange(colormaps[name].N)) * 255).astype(int), axis=0)).max())
    for name in ("Pastel1", "RdBu_r", "Reds", "magma")
}


@pytest.mark.parametrize(
    "task, use_alibi, cutoff, cmap",
    [("classification", False, None, "RdBu_r"), ("regression", True, None, "magma"),
     ("survival", False, 0.4, "RdBu_r")],
    ids=["classification", "regression", "survival_cutoff"],
)  # fmt: skip
def test_heatmaps_match_jax_package(task, use_alibi, cutoff, cmap, tmp_path, monkeypatch, caplog):
    wsi_dir, feat_dir = heatmaps_util.write_slide(tmp_path)
    ckpt = heatmaps_util.write_checkpoint(tmp_path / "model.ckpt", task, use_alibi=use_alibi, cutoff=cutoff)
    args = dict(feature_dir=feat_dir, wsi_dir=wsi_dir, checkpoint_path=ckpt, slide_paths=None,
                default_slide_mpp=heatmaps_util.SLIDE_MPP, opacity=0.6, topk=2, bottomk=1)  # fmt: skip
    jax_gen.heatmaps_(output_dir=tmp_path / "jax", **args)
    monkeypatch.setattr(gen, "pyplot", lambda: None)  # as on a machine without matplotlib
    with caplog.at_level(logging.WARNING, logger="stamp"):
        gen.heatmaps_(output_dir=tmp_path / "torch", device="cpu", **args)

    jax_files, torch_files = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    plots = [f for f in jax_files if "/plots/" in f]
    assert plots and torch_files == sorted(set(jax_files) - set(plots))
    (warning,) = [r.getMessage() for r in caplog.records if "matplotlib" in r.getMessage()]
    assert all(str(tmp_path / "torch" / f) in warning for f in plots)
    assert any("/tiles/" in f for f in torch_files)

    for name in (f for f in torch_files if "/raw/" in f):
        got = np.asarray(Image.open(tmp_path / "torch" / name), dtype=int)
        want = np.asarray(Image.open(tmp_path / "jax" / name), dtype=int)
        assert got.shape == want.shape, name
        step = 0 if "thumbnail" in name else _STEPS["Pastel1" if "classmap" in name else cmap]
        assert np.abs(got - want).max() <= step, name
        assert np.mean(got != want) < 0.05, name


def test_heatmaps_device_auto_without_a_card_raises(tmp_path):
    """No fallback: ``device: auto`` asks for a card, and there is none here."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    wsi_dir, feat_dir = heatmaps_util.write_slide(tmp_path)
    ckpt = heatmaps_util.write_checkpoint(tmp_path / "model.ckpt", "classification")
    with pytest.raises(RuntimeError, match="is_available"):
        gen.heatmaps_(feature_dir=feat_dir, wsi_dir=wsi_dir, checkpoint_path=ckpt, output_dir=tmp_path / "out",
                      slide_paths=None, device="auto", default_slide_mpp=heatmaps_util.SLIDE_MPP, opacity=0.6,
                      topk=0, bottomk=0)  # fmt: skip
    assert not (tmp_path / "out").exists()
