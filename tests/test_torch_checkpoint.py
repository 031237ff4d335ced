"""Checkpoints across the two packages: a ``model.ckpt`` the JAX package
writes loads in the port and predicts the same, and one the port writes
loads in the JAX package; the version gate and the pickle refusal hold in
the port as they do there."""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stamp_tpu.modeling import checkpoint as jax_ckpt
from stamp_tpu.modeling.tasks import LitTileClassifier as JaxClassifier
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu_torch.modeling import checkpoint as torch_ckpt
from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
from stamp_tpu_torch.models import vision_transformer as torch_vit

_PARAMS = dict(dim_model=32, n_layers=2, n_heads=4, dim_feedforward=32, dropout=0.0)


def _jax_model(use_alibi: bool):
    return JaxClassifier(
        model_class=JaxViT,
        ground_truth_label="isup",
        categories=["low", "high"],
        category_weights=[0.5, 1.5],
        dim_input=16,
        model_name="vit",
        train_patients=["p1", "p2"],
        valid_patients=["p3"],
        use_alibi=use_alibi,
        **_PARAMS,
    )


def _bag(seed: int = 0):
    rng = np.random.default_rng(seed)
    bags = rng.normal(size=(1, 25, 16)).astype(np.float32)
    coords = (rng.integers(0, 8, size=(1, 25, 2)) * 256.0).astype(np.float32)
    return bags, coords, np.arange(25)[None, :] < 20


def _jax_logits(model, variables, bags, coords, key_mask):
    out = model.module.apply(variables, jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    return np.asarray(out)


def _torch_logits(module, bags, coords, key_mask):
    with torch.inference_mode():
        return module(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask)).numpy()


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_jax_checkpoint_loads_in_the_port(tmp_path, use_alibi):
    bags, coords, key_mask = _bag()
    model = _jax_model(use_alibi)
    variables = model.module.init(jax.random.PRNGKey(1), jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    path = tmp_path / "model.ckpt"
    jax_ckpt.save_checkpoint(path, hyper_parameters=model.checkpoint_hparams(), variables=variables)

    payload = torch_ckpt.load_checkpoint(path)
    assert payload["format"] == "stamp-tpu-ckpt-v2"
    assert payload["hyper_parameters"] == jax_ckpt.load_checkpoint(path)["hyper_parameters"]

    task_model, loaded = load_model_from_ckpt(path)
    assert task_model.hparams["model_name"] == "vit" and task_model.categories == ["low", "high"]
    assert task_model.train_patients == ["p1", "p2"] and task_model.dim_output == 2
    task_model.module.load_state_dict(torch_vit.variables_from_jax(loaded))
    np.testing.assert_allclose(
        _torch_logits(task_model.module.eval(), bags, coords, key_mask),
        _jax_logits(model, variables, bags, coords, key_mask),
        atol=1e-5,
        rtol=0,
    )


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_port_checkpoint_loads_in_the_jax_package(tmp_path, use_alibi):
    bags, coords, key_mask = _bag(1)
    model = _jax_model(use_alibi)  # only for its hyper-parameter record
    module = torch_vit.init_random_weights_(
        torch_vit.VisionTransformer(dim_input=16, dim_output=2, use_alibi=use_alibi, **_PARAMS),
        torch.Generator().manual_seed(0),
    ).eval()
    path = tmp_path / "model.ckpt"
    torch_ckpt.save_checkpoint(
        path,
        hyper_parameters=model.checkpoint_hparams(),
        variables=torch_vit.variables_to_jax(module.state_dict()),
    )

    from stamp_tpu.modeling.deploy import load_model_from_ckpt as jax_load

    jax_model, variables = jax_load(path)
    np.testing.assert_allclose(
        _jax_logits(jax_model, variables, bags, coords, key_mask),
        _torch_logits(module, bags, coords, key_mask),
        atol=1e-5,
        rtol=0,
    )


@pytest.mark.parametrize("version", ["2.4.0", "9.9.9"])
def test_version_gate(tmp_path, version):
    with pytest.raises(ValueError, match="stamp version"):
        torch_ckpt.check_version_compatibility(version)
    torch_ckpt.check_version_compatibility("2.5.0")
    path = tmp_path / "model.ckpt"
    torch_ckpt.save_checkpoint(path, hyper_parameters={"stamp_version": version}, variables={})
    with pytest.raises(ValueError, match="stamp version"):
        torch_ckpt.load_checkpoint(path)


def test_pickle_and_foreign_files_are_refused(tmp_path):
    pickled = tmp_path / "legacy.ckpt"
    pickled.write_bytes(pickle.dumps({"state_dict": {}}))
    with pytest.raises(ValueError, match="pickle"):
        torch_ckpt.load_checkpoint(pickled)
    npz = tmp_path / "other.npz"
    np.savez(npz, a=np.zeros(3))
    with pytest.raises(ValueError, match="not a stamp-tpu checkpoint"):
        torch_ckpt.load_checkpoint(npz)
    # a torch zip that is no Lightning checkpoint is refused; the reference's
    # Lightning .ckpt (here written by the JAX package) loads
    foreign = tmp_path / "foreign.ckpt"
    torch.save({"state_dict": {}}, foreign)
    with pytest.raises(ValueError, match="not a Lightning checkpoint"):
        load_model_from_ckpt(foreign)
    from stamp_tpu.modeling.interop import save_reference_checkpoint

    model = JaxClassifier(model_class=JaxViT, ground_truth_label="gt", categories=["a", "b"],
                          category_weights=np.array([0.5, 0.5], np.float32), dim_input=8, model_name="vit",
                          dim_model=16, n_heads=2, n_layers=1, dim_feedforward=16)  # fmt: skip
    variables = model.module.init(jax.random.PRNGKey(0), jnp.zeros((1, 4, 8)), coords=jnp.zeros((1, 4, 2)))
    lightning = tmp_path / "lightning.ckpt"
    save_reference_checkpoint(lightning, hyper_parameters=model.checkpoint_hparams(), variables=variables)
    task_model, loaded = load_model_from_ckpt(lightning)
    task_model.module.load_state_dict(torch_vit.variables_from_jax(loaded))
    assert task_model.categories == ["a", "b"]
