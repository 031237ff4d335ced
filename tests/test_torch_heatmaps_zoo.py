"""The port's ``heatmaps`` of a ``trans_mil`` and a multi-target ``barspoon``
checkpoint against the JAX package on the CPU (the weights written by the
JAX package, from its own initializers):

* ``heatmaps_`` end to end, its Grad-CAM per category (per target for
  barspoon, from one forward and one backward per (target, category)) and
  its per-tile scores recorded on both sides: max |Δ| ≤ 1e-4 of max |JAX|
  (f32; TransMIL's per-tile scores are each tile's own bag, its
  pseudo-inverse scaled within that bag);
* the same files as ``stamp_tpu``'s but the
  ``plots/`` figures (the port runs without matplotlib here), one set per
  target with the stem suffixed by ``sanitize(target)``, the ``raw/`` PNGs
  equal up to one colormap step per channel where a value lies within
  rounding of a bin edge (``test_torch_heatmaps._STEPS``).
"""

import jax
import numpy as np
import pytest
from PIL import Image

import heatmaps_util
import stamp_tpu.heatmaps.generate as jax_gen
from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.modeling.checkpoint import save_checkpoint
from stamp_tpu.models.trans_mil import TransMIL as JaxTransMIL
from stamp_tpu_torch.heatmaps import generate as gen
from test_torch_heatmaps import _STEPS, _tree

FEAT_DIM = 8
REL_TOL = 1e-4
_TARGETS = {"KRAS status": ["mut", "wt"], "grade": ["g1", "g2", "g3"]}


@pytest.fixture(autouse=True)
def jitted_jax_heatmaps(monkeypatch):
    """The JAX package's forward, ``jax.jacrev`` and ``jax.vmap`` compiled
    with ``jax.jit`` (the same functions; op by op they take half a minute
    a slide on the CPU)."""
    jacrev, vmap, forward_fn = jax.jacrev, jax.vmap, jax_gen._forward_fn
    monkeypatch.setattr(jax, "jacrev", lambda f, *a, **k: jax.jit(jacrev(f, *a, **k)))
    monkeypatch.setattr(jax, "vmap", lambda f, *a, **k: jax.jit(vmap(f, *a, **k)))
    monkeypatch.setattr(jax_gen, "_forward_fn", lambda *a, **k: jax.jit(forward_fn(*a, **k)))


def _checkpoint(path, kind: str) -> None:
    if kind == "trans_mil":
        model = jax_tasks.LitTileClassifier(
            model_class=JaxTransMIL, ground_truth_label="gt", categories=["neg", "pos", "other"],
            category_weights=np.ones(3, np.float32), dim_input=FEAT_DIM, model_name="trans_mil", dim_hidden=32,
        )  # fmt: skip
        targets = None
    else:
        model = jax_tasks.LitEncDecTransformer(
            dim_input=FEAT_DIM, ground_truth_label=list(_TARGETS), categories=_TARGETS, model_name="barspoon",
            category_weights={t: np.full(len(c), 1 / len(c), np.float32) for t, c in _TARGETS.items()},
            d_model=16, num_encoder_heads=2, num_decoder_heads=2, dim_feedforward=32,
        )  # fmt: skip
        targets = {t: np.zeros((1, len(c)), np.float32) for t, c in _TARGETS.items()}
    batch = (np.zeros((1, 4, FEAT_DIM), np.float32), np.zeros((1, 4, 2), np.float32), np.array([4]), targets)
    variables = jax.jit(lambda b: model.init_variables(jax.random.PRNGKey(3), b))(batch)
    save_checkpoint(path, hyper_parameters=model.checkpoint_hparams(), variables=variables)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.abs(got - want).max() / np.abs(want).max())


def _recording(monkeypatch, module, name: str) -> list:
    """Patch ``module.name`` to record the result of each call."""
    calls: list = []
    fn = getattr(module, name)

    def record(*args, **kwargs):
        calls.append(fn(*args, **kwargs))
        return calls[-1]

    monkeypatch.setattr(module, name, record)
    return calls


@pytest.mark.parametrize("kind", ["trans_mil", "barspoon"])
def test_heatmaps_match_jax_package(tmp_path, monkeypatch, kind):
    ckpt = tmp_path / "model.ckpt"
    _checkpoint(ckpt, kind)
    wsi_dir, feat_dir = heatmaps_util.write_slide(tmp_path, feat_dim=FEAT_DIM)
    args = dict(feature_dir=feat_dir, wsi_dir=wsi_dir, checkpoint_path=ckpt, slide_paths=None,
                default_slide_mpp=heatmaps_util.SLIDE_MPP, opacity=0.6, topk=2, bottomk=1)  # fmt: skip
    jax_cams = _recording(monkeypatch, jax_gen, "_gradcam_per_category")  # [tile, category], per target
    jax_scores = _recording(monkeypatch, jax_gen, "_per_tile_scores")
    jax_gen.heatmaps_(output_dir=tmp_path / "jax", **args)
    monkeypatch.setattr(gen, "pyplot", lambda: None)  # as on a machine without matplotlib
    cams = _recording(monkeypatch, gen, "_cams")
    scores = _recording(monkeypatch, gen, "_per_tile_scores")
    gen.heatmaps_(output_dir=tmp_path / "torch", device="cpu", **args)

    # one forward, and one set of per-tile scores, for every target
    assert len(cams) == len(scores) == 1
    (logits, cam), (score,) = cams[0], scores
    if kind == "barspoon":
        assert list(logits) == list(score) == list(_TARGETS)
        bounds = np.cumsum([0, *(len(c) for c in _TARGETS.values())])
        got_cams = [gen._softmax(cam[lo:hi]).T for lo, hi in zip(bounds[:-1], bounds[1:])]
        got_scores = list(score.values())
    else:
        got_cams, got_scores = [gen._softmax(cam).T], [score]
    assert len(jax_cams) == len(jax_scores) == len(got_cams)
    for got, want in (*zip(got_cams, jax_cams), *zip(got_scores, jax_scores)):
        assert _rel(got, want) <= REL_TOL

    jax_files, torch_files = _tree(tmp_path / "jax"), _tree(tmp_path / "torch")
    plots = [f for f in jax_files if "/plots/" in f]
    assert plots and torch_files == sorted(set(jax_files) - set(plots))
    stems = ["slide1-KRAS_status", "slide1-grade"] if kind == "barspoon" else ["slide1"]
    for stem in stems:
        assert f"slide1/raw/{stem}-classmap.png" in torch_files
    for name in (f for f in torch_files if "/raw/" in f):
        got = np.asarray(Image.open(tmp_path / "torch" / name), dtype=int)
        want = np.asarray(Image.open(tmp_path / "jax" / name), dtype=int)
        assert got.shape == want.shape, name
        step = 0 if "thumbnail" in name else _STEPS["Pastel1" if "classmap" in name else "RdBu_r"]
        assert np.abs(got - want).max() <= step, name
        assert np.mean(got != want) < 0.05, name
