"""The reference's Lightning ``.ckpt`` in the port (``modeling/interop.py``),
against the JAX package's interop on the CPU:

* a file written by the JAX package's ``save_reference_checkpoint`` for
  ``vit``, ALiBi, ``mlp``, ``linear``, ``trans_mil``, ``barspoon`` and a
  survival ``vit`` with a cut-off loads in the port with the JAX package's
  hyper-parameters and gives its outputs (1e-5 of max |JAX|, f32);
* a file the port writes loads in the JAX package with bitwise the same
  variables, and the two packages write the same state dict, bitwise;
* ``python -m stamp_tpu_torch export_ckpt`` round-trips an npz checkpoint
  through the Lightning format bitwise, in both directions of the command.
"""

import jax
import numpy as np
import pytest
import torch

from stamp_tpu.modeling import interop as jax_interop
from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.modeling.checkpoint import load_checkpoint as jax_load_checkpoint
from stamp_tpu.modeling.checkpoint import save_checkpoint as jax_save_checkpoint
from stamp_tpu.modeling.deploy import load_model_from_ckpt as jax_load_model
from stamp_tpu.models import mlp as jax_mlp
from stamp_tpu.models.trans_mil import TransMIL as JaxTransMIL
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu_torch.modeling import interop
from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
from stamp_tpu_torch.models import weights

FEAT_DIM = 12
REL_TOL = 1e-5
_CLASSES = dict(ground_truth_label="gt", categories=["neg", "pos"], category_weights=np.array([0.4, 0.6], np.float32))
_TARGETS = {"KRAS status": ["mut", "wt"], "grade": ["g1", "g2", "g3"]}
_KINDS = ["vit", "alibi", "mlp", "linear", "trans_mil", "barspoon", "survival"]


def _jax_model(kind: str):
    """(JAX task model, its variables, inputs: (bags, coords) or (feats,))."""
    common = dict(dim_input=FEAT_DIM, total_steps=8, train_patients=["p1"], valid_patients=["p2"])
    vit = dict(model_class=JaxViT, model_name="vit", dim_model=32, n_layers=2, n_heads=4, dim_feedforward=48)
    if kind in ("vit", "alibi"):
        model = jax_tasks.LitTileClassifier(use_alibi=kind == "alibi", **vit, **_CLASSES, **common)
    elif kind == "survival":
        model = jax_tasks.LitTileSurvival(time_label="day", status_label="status", train_pred_median=0.125,
                                          use_alibi=True, **vit, **common)  # fmt: skip
    elif kind == "trans_mil":
        model = jax_tasks.LitTileClassifier(model_class=JaxTransMIL, model_name="trans_mil", dim_hidden=32,
                                            **_CLASSES, **common)  # fmt: skip
    elif kind == "barspoon":
        model = jax_tasks.LitEncDecTransformer(
            ground_truth_label=list(_TARGETS), categories=_TARGETS, model_name="barspoon",
            category_weights={t: np.full(len(c), 1 / len(c), np.float32) for t, c in _TARGETS.items()},
            d_model=32, num_encoder_heads=4, num_decoder_heads=4, dim_feedforward=48, **common,
        )  # fmt: skip
    else:
        module_class = jax_mlp.MLP if kind == "mlp" else jax_mlp.Linear
        params = dict(dim_hidden=20, num_layers=3) if kind == "mlp" else {}
        model = jax_tasks.LitSlideClassifier(model_class=module_class, model_name=kind, **params, **_CLASSES, **common)
    rng = np.random.default_rng(_KINDS.index(kind))
    bags = rng.normal(size=(2, 15, FEAT_DIM)).astype(np.float32)
    coords = (rng.uniform(size=(2, 15, 2)) * 2000).astype(np.float32)
    inputs = (bags, coords) if model.supported_features[0] == "tile" else (bags[:, 0],)
    batch = (*inputs, np.array([15, 15]), None) if len(inputs) == 2 else (inputs[0], None)
    variables = jax.jit(lambda b: model.init_variables(jax.random.PRNGKey(_KINDS.index(kind)), b))(batch)
    variables = jax.tree_util.tree_map(np.asarray, dict(variables))
    if kind in ("alibi", "survival"):  # coordinates of a 2 mm region: the distance term weighs like the softmax
        for block in variables["alibi_stats"].values():
            block["mhsa"]["running_mean"] = np.full(4, 700.0, np.float32)
    return model, variables, inputs


def _jax_outputs(model, variables, inputs):
    module = model.module
    if len(inputs) == 2 and model.uses_coords:
        return jax.jit(lambda v, b, c: module.apply(v, b, coords=c, train=False))(variables, *inputs)
    return jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, inputs[0])


def _port_outputs(model, variables, inputs):
    module = weights.load_variables_(model.module, variables)
    tensors = [torch.from_numpy(a) for a in inputs]
    with torch.no_grad():
        if model.uses_coords:
            return module(tensors[0], coords=tensors[1])
        return module(tensors[0])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _assert_same_tree(got, want) -> None:
    got, want = weights.flatten(got), weights.flatten(want)
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype and np.array_equal(got[path], value), path


@pytest.mark.parametrize("kind", _KINDS)
def test_lightning_files_load_across_packages(tmp_path, kind):
    model, variables, inputs = _jax_model(kind)
    jax_file = tmp_path / "jax.ckpt"
    jax_interop.save_reference_checkpoint(jax_file, hyper_parameters=model.checkpoint_hparams(), variables=variables)
    assert interop.is_reference_checkpoint(jax_file)

    jax_model, jax_variables = jax_load_model(jax_file)
    port_model, port_variables = load_model_from_ckpt(jax_file)
    _assert_same_tree(port_variables, jax_variables)
    assert port_model.hparams.keys() == jax_model.hparams.keys()
    for key in ("task", "supported_features", "model_name", "categories", "train_patients", "train_pred_median"):
        assert port_model.hparams.get(key) == jax_model.hparams.get(key), key
    want = _jax_outputs(jax_model, jax_variables, inputs)
    got = _port_outputs(port_model, port_variables, inputs)
    if kind == "barspoon":
        assert list(got) == list(_TARGETS)
        for target in _TARGETS:
            assert _rel(got[target], want[target]) <= REL_TOL, target
    else:
        assert _rel(got, want) <= REL_TOL

    # the port writes what the JAX package writes, and the JAX package reads it
    port_file = tmp_path / "port.ckpt"
    interop.save_reference_checkpoint(port_file, hyper_parameters=port_model.checkpoint_hparams(),
                                      variables=port_variables)  # fmt: skip
    written = {name: torch.load(f, weights_only=False) for name, f in (("jax", jax_file), ("port", port_file))}
    assert written["port"]["state_dict"].keys() == written["jax"]["state_dict"].keys()
    for key, value in written["jax"]["state_dict"].items():
        assert torch.equal(written["port"]["state_dict"][key], value), key
    assert str(written["port"]["hyper_parameters"]["stamp_version"]) == "2.5.0"
    _assert_same_tree(jax_load_model(port_file)[1], jax_variables)


def test_version_gate_and_unknown_backbone(tmp_path):
    from packaging.version import Version

    model, variables, _ = _jax_model("linear")
    path = tmp_path / "old.ckpt"
    jax_interop.save_reference_checkpoint(
        path, hyper_parameters={**model.checkpoint_hparams(), "stamp_version": "2.4.0"}, variables=variables
    )
    ckpt = torch.load(path, weights_only=False)
    assert ckpt["hyper_parameters"]["stamp_version"] == Version("2.4.0")
    with pytest.raises(ValueError, match="incompatible"):
        load_model_from_ckpt(path)
    ckpt["hyper_parameters"] |= {"stamp_version": Version("2.5.0"), "model_name": "cobra"}
    torch.save(ckpt, path)
    with pytest.raises(ValueError, match="cobra"):
        load_model_from_ckpt(path)


@pytest.mark.parametrize("kind", ["trans_mil", "barspoon"])
def test_export_ckpt_round_trips_bitwise(tmp_path, kind):
    """npz (written by the JAX package) → ``export_ckpt`` → Lightning →
    ``export_ckpt`` → npz: the variables bitwise the original's, and the
    Lightning file bitwise the JAX package's export of the same npz."""
    from stamp_tpu_torch.__main__ import main

    model, variables, _ = _jax_model(kind)
    npz = tmp_path / "model.ckpt"
    jax_save_checkpoint(npz, hyper_parameters=model.checkpoint_hparams(), variables=variables)
    main(["export_ckpt", str(npz), str(tmp_path / "lightning.ckpt")])
    main(["export_ckpt", str(tmp_path / "lightning.ckpt"), str(tmp_path / "back.ckpt")])
    back = jax_load_checkpoint(tmp_path / "back.ckpt")
    _assert_same_tree(back["variables"], variables)
    assert back["hyper_parameters"]["model_name"] == kind

    jax_interop.export_reference_checkpoint(npz, tmp_path / "jax-lightning.ckpt")
    got = torch.load(tmp_path / "lightning.ckpt", weights_only=False)["state_dict"]
    want = torch.load(tmp_path / "jax-lightning.ckpt", weights_only=False)["state_dict"]
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)
