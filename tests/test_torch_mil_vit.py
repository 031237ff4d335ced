"""The port's MIL ViT (stamp_tpu_torch.models.vision_transformer) against the
JAX module on the same masked bag and the same weights, carried across with
``variables_from_jax``; both attention variants, once on the einsum path and
once with the flash wrappers taken (their plain versions on the CPU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu_torch.models import vision_transformer as torch_vit
from stamp_tpu_torch.ops import flash_attention

_DIMS = dict(dim_output=3, dim_input=24, dim_model=32, n_layers=2, n_heads=4, dim_feedforward=48)
ATOL = 1e-5  # logits, f32 on both sides


def _bag(seed: int = 0, tiles: int = 40, valid: int = 29):
    rng = np.random.default_rng(seed)
    bags = rng.normal(size=(1, tiles, _DIMS["dim_input"])).astype(np.float32)
    coords = (rng.integers(0, 12, size=(1, tiles, 2)) * 256.0).astype(np.float32)
    key_mask = np.arange(tiles)[None, :] < valid
    return bags, coords, key_mask


def _jax_variables(use_alibi: bool, bags, coords, key_mask) -> dict:
    module = JaxViT(**_DIMS, use_alibi=use_alibi)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(variables)))
    if use_alibi:
        # running mean ≈ mean distance × tiles: the post-softmax bias is then
        # as large as the softmax weights, so neither branch hides the other
        for i in range(_DIMS["n_layers"]):
            variables["alibi_stats"][f"block_{i}"]["mhsa"]["running_mean"] = np.full(
                _DIMS["n_heads"], 1500.0 * 40, np.float32
            )
    return variables


def _jax_logits(use_alibi: bool, variables, bags, coords, key_mask) -> np.ndarray:
    module = JaxViT(**_DIMS, use_alibi=use_alibi)
    out = module.apply(variables, jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    return np.asarray(out)


def _torch_model(use_alibi: bool, variables) -> torch_vit.VisionTransformer:
    model = torch_vit.VisionTransformer(**_DIMS, use_alibi=use_alibi)
    model.load_state_dict(torch_vit.variables_from_jax(variables))
    return model.eval()


def _torch_logits(model, bags, coords, key_mask) -> np.ndarray:
    with torch.inference_mode():
        out = model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask))
    return out.numpy()


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_mil_vit_matches_jax(use_alibi, path, monkeypatch):
    bags, coords, key_mask = _bag()
    variables = _jax_variables(use_alibi, bags, coords, key_mask)
    want = _jax_logits(use_alibi, variables, bags, coords, key_mask)

    calls = []
    name = "flash_alibi_mha" if use_alibi else "flash_mha"
    wrapper = getattr(flash_attention, name)
    monkeypatch.setattr(flash_attention, name, lambda *a: calls.append(a[0].shape) or wrapper(*a))
    if path == "flash":
        monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    got = _torch_logits(_torch_model(use_alibi, variables), bags, coords, key_mask)

    # 41 tokens (CLS + 40 tiles) × 4 heads of one bag per layer
    assert calls == ([(4, 41, 8)] * 2 if path == "flash" else [])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_padding_keys_do_not_change_the_logits():
    """A bag padded with masked zero tiles gives the unpadded bag's logits."""
    bags, coords, key_mask = _bag(tiles=29, valid=29)
    variables = _jax_variables(True, bags, coords, key_mask)
    model = _torch_model(True, variables)
    pad = ((0, 0), (0, 11), (0, 0))
    padded = _torch_logits(model, np.pad(bags, pad), np.pad(coords, pad), np.arange(40)[None] < 29)
    np.testing.assert_allclose(padded, _torch_logits(model, bags, coords, key_mask), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_variables_round_trip_exactly(use_alibi):
    bags, coords, key_mask = _bag()
    variables = _jax_variables(use_alibi, bags, coords, key_mask)
    back = torch_vit.variables_to_jax(_torch_model(use_alibi, variables).state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    back_flat = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in back_flat]
    for (path, a), (_, b) in zip(flat, back_flat):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_collected_attention_matches_jax(use_alibi):
    """What the JAX module sows for heatmaps (per layer q, k and, with
    ``sow_weights``, the masked softmax maps) equals what the port collects
    into ``intermediates``, and the logits stay the JAX module's."""
    bags, coords, key_mask = _bag()
    variables = _jax_variables(use_alibi, bags, coords, key_mask)
    out, state = JaxViT(**_DIMS, use_alibi=use_alibi).apply(
        variables, jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask),
        sow_weights=True, mutable=["intermediates"],
    )  # fmt: skip
    model = _torch_model(use_alibi, variables)
    inter: dict = {}
    with torch.inference_mode():
        got = model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask),
                    sow_weights=True, intermediates=inter)  # fmt: skip
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL, rtol=0)
    assert sorted(inter) == [f"block_{i}" for i in range(_DIMS["n_layers"])]
    for block, collected in inter.items():
        sown = state["intermediates"][block]["mhsa"]
        assert sorted(collected) == ["attn_k", "attn_q", "attn_weights"]
        for name, value in collected.items():
            np.testing.assert_allclose(value.numpy(), np.asarray(sown[name][0]), atol=ATOL, rtol=0)
    # q and k alone without sow_weights
    inter = {}
    with torch.inference_mode():
        model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask),
              intermediates=inter)  # fmt: skip
    assert all(sorted(c) == ["attn_k", "attn_q"] for c in inter.values())


def test_inference_only():
    """Attention maps need a dict to go into (``sow_weights`` without one
    raises); the training forward runs (tests/test_torch_train.py holds it
    against the JAX module) and updates the ALiBi statistics once."""
    model = torch_vit.VisionTransformer(**_DIMS, use_alibi=True)
    bags, coords, key_mask = (torch.from_numpy(a) for a in _bag())
    with pytest.raises(ValueError, match="intermediates"):
        model(bags, coords=coords, key_mask=key_mask, sow_weights=True)
    out = model(bags, coords=coords, key_mask=key_mask, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all() and out.requires_grad
    assert float(model.block_0.mhsa.items_so_far[0]) == 2.0
    with pytest.raises(ValueError, match="generator"):  # dropout never silently off
        torch_vit.VisionTransformer(**_DIMS, dropout=0.1)(bags, coords=coords, key_mask=key_mask, train=True)


def test_init_random_weights_is_seeded():
    a, b = (
        torch_vit.init_random_weights_(torch_vit.VisionTransformer(**_DIMS, use_alibi=True), torch.Generator().manual_seed(7))
        for _ in range(2)
    )
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    assert float(a.block_0.mhsa.running_mean[0]) == 1.0
    bias_scale = a.block_0.mhsa.bias_scale.detach()
    assert 0.0 <= float(bias_scale.min()) and float(bias_scale.max()) < 1.0


def test_training_dropout_draws_from_the_generator():
    """With dropout, a training forward depends on the generator's draws
    (equal seeds give equal logits) and differs from the eval forward."""
    model = torch_vit.VisionTransformer(**_DIMS, dropout=0.5)
    bags, coords, key_mask = (torch.from_numpy(a) for a in _bag())

    def run(seed):
        return model(bags, coords=coords, key_mask=key_mask, train=True, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), model(bags, coords=coords, key_mask=key_mask))
