"""The port's ImageViT (stamp_tpu_torch.models.vit_image) against the JAX
package's, on the same weights (flax init → numpy → state_dict_from_jax)
and the same numpy images, in f32 on the CPU."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stamp_tpu.models import vit_image as jax_vit
from stamp_tpu_torch.models import vit_image as torch_vit

# the three configs of tests/test_extractor_parity.py
_PARITY_CONFIGS = {
    "uni-like": dict(
        img_size=64, patch_size=16, embed_dim=64, depth=3, num_heads=4,
        init_values=1e-5,
    ),
    "uni2-like": dict(
        img_size=56, patch_size=14, embed_dim=48, depth=2, num_heads=4,
        mlp_ratio=8 / 3, ffn="swiglu", num_reg_tokens=8, init_values=1e-5,
        act="silu",
    ),
    "virchow-full-like": dict(
        img_size=56, patch_size=14, embed_dim=32, depth=2, num_heads=4,
        mlp_ratio=5.0, ffn="swiglu", init_values=1e-5, pool="token_avg_concat",
    ),
}  # fmt: skip

# every LayerNorm→matmul site tiles the TPU kernel's grid at batch 16:
# 16 tokens a tile → M = 256; qkv N = 768, fc1 N = 1024, fc2 K = 512
_KERNEL_PATH_CONFIG = dict(
    img_size=42, patch_size=14, embed_dim=256, depth=2, num_heads=4,
    mlp_ratio=4.0, ffn="swiglu", num_reg_tokens=6, init_values=1e-5, act="silu",
)  # fmt: skip


def _jax_variables(cfg: jax_vit.ViTConfig) -> dict:
    variables = jax_vit.ImageViT(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, cfg.img_size, cfg.img_size, 3))
    )
    return jax.tree_util.tree_map(np.asarray, variables)


def _torch_model(kwargs: dict, variables: dict) -> torch_vit.ImageViT:
    cfg = torch_vit.ViTConfig(**kwargs)
    model = torch_vit.ImageViT(cfg).eval()
    model.load_state_dict(torch_vit.state_dict_from_jax(variables, cfg))  # strict
    return model


def _images(kwargs: dict, batch: int, seed: int = 0) -> np.ndarray:
    size = kwargs["img_size"]
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("name", sorted(jax_vit.VIT_CONFIGS))
def test_vit_configs_match_jax(name):
    assert name in torch_vit.VIT_CONFIGS
    assert dataclasses.asdict(torch_vit.VIT_CONFIGS[name]) == dataclasses.asdict(
        jax_vit.VIT_CONFIGS[name]
    )


def test_vit_config_fields_match_jax():
    assert [f.name for f in dataclasses.fields(torch_vit.ViTConfig)] == [
        f.name for f in dataclasses.fields(jax_vit.ViTConfig)
    ]
    assert set(torch_vit.VIT_CONFIGS) == set(jax_vit.VIT_CONFIGS)


@pytest.mark.parametrize("name", sorted(_PARITY_CONFIGS))
def test_state_dict_from_jax_round_trips(name):
    kwargs = _PARITY_CONFIGS[name]
    cfg = jax_vit.ViTConfig(**kwargs)
    variables = _jax_variables(cfg)
    sd = torch_vit.state_dict_from_jax(variables, torch_vit.ViTConfig(**kwargs))
    back = jax_vit.convert_torch_state_dict(sd, cfg)

    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))
    # and the timm names are exactly the port module's parameters
    model = torch_vit.ImageViT(torch_vit.ViTConfig(**kwargs))
    assert set(sd) == set(model.state_dict())


@pytest.mark.parametrize("name", sorted(_PARITY_CONFIGS))
def test_image_vit_matches_jax(name):
    kwargs = _PARITY_CONFIGS[name]
    cfg = jax_vit.ViTConfig(**kwargs)
    variables = _jax_variables(cfg)
    images = _images(kwargs, batch=2)

    ref = np.asarray(jax_vit.ImageViT(cfg).apply(variables, jnp.asarray(images)))
    with torch.inference_mode():
        out = _torch_model(kwargs, variables)(torch.from_numpy(images)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_image_vit_matches_jax_kernel_path(monkeypatch):
    """Against the JAX package's Pallas path (fused attention + fused
    LN→matmul at every site, interpret mode)."""
    kwargs = _KERNEL_PATH_CONFIG
    cfg = jax_vit.ViTConfig(**kwargs)
    variables = _jax_variables(cfg)
    images = _images(kwargs, batch=16, seed=1)

    monkeypatch.setattr(jax_vit, "_use_fused_attention", lambda: True)
    monkeypatch.setattr(jax_vit, "_use_fused_ln_dense", lambda: True)
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )
    from stamp_tpu.ops.ln_dense import _pick_tiles

    n_tokens = cfg.num_patches + cfg.num_prefix_tokens
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    for k, n in ((256, 768), (256, hidden), (hidden // 2, 256)):
        assert _pick_tiles(16 * n_tokens, k, n, 4) is not None

    ref = np.asarray(jax_vit.ImageViT(cfg).apply(variables, jnp.asarray(images)))
    with torch.inference_mode():
        out = _torch_model(kwargs, variables)(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)


def test_select_timm_state_dict_aliases_and_missing():
    kwargs = _PARITY_CONFIGS["uni2-like"]
    cfg = torch_vit.ViTConfig(**kwargs)
    sd = torch_vit.state_dict_from_jax(_jax_variables(jax_vit.ViTConfig(**kwargs)), cfg)
    # older spellings and extra checkpoint entries
    legacy = {
        k.replace("ls1.gamma", "gamma_1").replace("ls2.gamma", "gamma_2"): v
        for k, v in sd.items()
        if k != "reg_token"
    }
    legacy["register_tokens"] = sd["reg_token"]
    legacy["head.weight"] = torch.zeros(3)
    model = torch_vit.ImageViT(cfg)
    selected = torch_vit.select_timm_state_dict(legacy, model)
    assert set(selected) == set(sd)
    model.load_state_dict(selected)

    del legacy["norm.weight"]
    with pytest.raises(KeyError, match="norm.weight"):
        torch_vit.select_timm_state_dict(legacy, model)


def test_quantized_modes_raise():
    """Only the JAX package's three precisions exist: another raises.  The
    observe and int8 modes build, observe with the bf16 state and int8 with
    the quantized weights, their scales and the activation maxima."""
    with pytest.raises(ValueError, match="quant"):
        torch_vit.ImageViT(torch_vit.ViTConfig(depth=1, quant="fp8"))
    with pytest.raises(ValueError, match="mode"):
        torch_vit.QuantDense(4, 4, mode="int4")
    with torch.device("meta"):
        keys = {
            quant: set(torch_vit.ImageViT(torch_vit.ViTConfig(depth=1, quant=quant)).state_dict())
            for quant in ("off", "observe", "int8")
        }
    assert keys["observe"] == keys["off"]
    site = "blocks.0.attn.qkv"
    assert {f"{site}.weight_q", f"{site}.w_scale", f"{site}.amax", f"{site}.bias"} <= keys["int8"]
    assert f"{site}.weight" not in keys["int8"]
    assert keys["int8"] - keys["off"] == {
        f"blocks.0.{s}.{name}" for s in ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2")
        for name in ("weight_q", "w_scale", "amax")
    }


def test_random_init_is_seeded():
    cfg = torch_vit.ViTConfig(**_PARITY_CONFIGS["uni-like"])
    a, b = (
        torch_vit.init_random_weights_(torch_vit.ImageViT(cfg), torch.Generator().manual_seed(0))
        for _ in range(2)
    )
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    assert a.blocks[0].ls1.gamma[0].item() == pytest.approx(1e-5)
    assert a.blocks[0].attn.qkv.weight.std().item() == pytest.approx(64**-0.5, rel=0.1)


def test_plain_kernels_swaps_and_restores():
    """``plain_kernels`` puts rows 1–3's plain versions in the blocks' place
    for the block's duration and the kernel wrappers back after it, also
    when the block raises; on the CPU both give the same output."""
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd

    kernels = (torch_vit.ln_dense, torch_vit.ln_quant_dense, torch_vit.fused_qkv_mha)
    assert kernels == (lnd.ln_dense, lnd.ln_quant_dense, attn.fused_qkv_mha)
    cfg = torch_vit.ViTConfig(img_size=32, patch_size=16, embed_dim=32, depth=1, num_heads=2, init_values=1.0)
    model = torch_vit.init_random_weights_(torch_vit.ImageViT(cfg), torch.Generator().manual_seed(0)).eval()
    x = torch.randn(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError), torch_vit.plain_kernels():
        assert (torch_vit.ln_dense, torch_vit.ln_quant_dense, torch_vit.fused_qkv_mha) == (
            lnd.ln_dense_reference, lnd.ln_quant_dense_reference, attn.fused_qkv_mha_reference
        )
        with torch.inference_mode():
            plain = model(x)
        raise RuntimeError
    assert (torch_vit.ln_dense, torch_vit.ln_quant_dense, torch_vit.fused_qkv_mha) == kernels
    with torch.inference_mode():
        torch.testing.assert_close(model(x), plain, rtol=0, atol=0)
