"""The port's int8 (W8A8) extraction path against the JAX package's, on the
CPU: ``ln_quant_dense`` (against the Pallas kernel in interpret mode and the
plain reference), the weight quantization, the observe-mode calibration,
``ImageViT`` in int8 mode (against the JAX package's unfused and fused
branches), the int8 extractor against the bf16 one, and ``preprocess`` with
``extractor_precision: int8`` through the port's CLI."""

import dataclasses
import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from jax.experimental import pallas as pl
from PIL import Image

from stamp_tpu.models import vit_image as jax_vit
from stamp_tpu.ops import ln_dense as jax_lnd
from stamp_tpu_torch.models import vit_image as torch_vit
from stamp_tpu_torch.ops import ln_dense as torch_lnd

_DTYPES = {"float32": (np.float32, jnp.float32, torch.float32), "bfloat16": (None, jnp.bfloat16, torch.bfloat16)}


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


def _quant_case(m, k, n, dtype, seed):
    """The same inputs for both packages: numpy → (jax arrays, torch tensors).
    The weight is [K, N] for JAX and its transpose [N, K] for the port."""
    rng = np.random.default_rng(seed)
    _, jdt, tdt = _DTYPES[dtype]
    x = rng.normal(size=(m, k)).astype(np.float32)
    g = (1.0 + 0.2 * rng.normal(size=(k,))).astype(np.float32)
    b = (0.2 * rng.normal(size=(k,))).astype(np.float32)
    wq = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    ws = (rng.uniform(0.5, 2.0, size=(n,)) * 1e-3).astype(np.float32)
    d = rng.normal(size=(n,)).astype(np.float32)
    amax = np.float32(3.5)
    jx = [jnp.asarray(a).astype(jdt) for a in (x, g, b)]
    tx = [torch.from_numpy(a).to(tdt) for a in (x, g, b)]
    j_sx = jnp.maximum(jnp.asarray(amax), 1e-6) * 1.05  # as QuantDense forms it
    t_sx = torch.tensor(amax).clamp_min(1e-6) * 1.05
    assert np.float32(j_sx) == t_sx.item()
    jax_args = (*jx, j_sx, jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(d).astype(jdt))
    torch_args = (*tx, t_sx, torch.from_numpy(wq.T.copy()), torch.from_numpy(ws), torch.from_numpy(d).to(tdt))
    return jax_args, torch_args


def _quantized(jax_args, torch_args):
    """Both packages' int8 activations: LayerNorm, cast, static quantize."""
    jx, jg, jb, j_sx = jax_args[:4]
    y = jax_lnd._ln(jx, jg, jb, 1e-6).astype(jx.dtype)
    jq = jnp.clip(jnp.round(y.astype(jnp.float32) * (127.0 / j_sx)), -127, 127).astype(jnp.int8)
    tx, tg, tb, t_sx = torch_args[:4]
    tq = torch_lnd.quantize_activation(torch_lnd.layer_norm_f32(tx, tg, tb, 1e-6).to(tx.dtype), t_sx)
    return np.asarray(jq).astype(np.int32), tq.numpy().astype(np.int32)


def _assert_matches(got: torch.Tensor, ref, dtype: str, jax_args, torch_args):
    jq, tq = _quantized(jax_args, torch_args)
    # the CPU LayerNorm sums of the two packages may round a value lying on
    # a half-integer of the quantization grid either way
    assert np.abs(jq - tq).max() <= 1
    assert (jq == tq).mean() >= 0.999
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-4)
    else:  # one bf16 ulp (8 significant bits) of the larger magnitude
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(got), np.abs(ref)) + 1e-30)) - 7)
        assert (np.abs(got - ref) <= ulp).all(), np.abs(got - ref).max()


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("bias", [True, False])
def test_ln_quant_dense_matches_jax_kernel(interpret_pallas, dtype, bias):
    """Against the Pallas kernel in interpret mode at a shape its tile
    picker takes (M % 256 == 0; K, N % 128 == 0)."""
    m, k, n = 512, 128, 1024
    assert jax_lnd._pick_quant_tiles(m, k, n, 4) is not None
    jax_args, torch_args = _quant_case(m, k, n, dtype, seed=3)
    if not bias:
        jax_args, torch_args = jax_args[:-1], torch_args[:-1]
    ref = jax_lnd.ln_quant_dense(*jax_args)
    got = torch_lnd.ln_quant_dense(*torch_args)
    _assert_matches(got, ref, dtype, jax_args, torch_args)


@pytest.mark.parametrize("dtype", sorted(_DTYPES))
@pytest.mark.parametrize("bias", [True, False])
def test_ln_quant_dense_matches_jax_reference_ragged(dtype, bias):
    m, k, n = 197, 208, 300
    jax_args, torch_args = _quant_case(m, k, n, dtype, seed=4)
    if not bias:
        jax_args, torch_args = jax_args[:-1], torch_args[:-1]
    ref = jax_lnd.ln_quant_dense_reference(*jax_args)
    got = torch_lnd.ln_quant_dense(*torch_args)
    _assert_matches(got, ref, dtype, jax_args, torch_args)
    assert torch_lnd.QUANT_LAUNCHES == 0  # the CPU takes the plain version


def test_int8_products_are_exact():
    """At K = 4096 the i32 sums exceed 2²⁴: an f32 product would round."""
    rng = np.random.default_rng(0)
    a = rng.integers(-127, 128, size=(33, 4096)).astype(np.int8)
    w = rng.integers(-127, 128, size=(24, 4096)).astype(np.int8)
    a[0], w[0] = 127, 127
    a[0, 0], w[0, 0] = 1, 2  # Σ = 127²·4095 + 2: odd and above 2²⁴
    want = a.astype(np.int64) @ w.astype(np.int64).T
    assert want[0, 0] > 2**24 and np.float32(want[0, 0]) != want[0, 0]
    got = torch_lnd.int8_matmul_exact(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # the int8 sites without a LayerNorm (QuantDense) take torch._int_mm
    np.testing.assert_array_equal(torch._int_mm(torch.from_numpy(a), torch.from_numpy(w).t()).numpy(), want)


# --- ImageViT in observe and int8 mode ----------------------------------------

_SMALL = dict(
    img_size=56, patch_size=14, embed_dim=48, depth=2, num_heads=4, mlp_ratio=8 / 3,
    ffn="swiglu", num_reg_tokens=8, init_values=1e-5, act="silu",
)  # fmt: skip
_MLP = dict(img_size=64, patch_size=16, embed_dim=64, depth=2, num_heads=4, init_values=1.0)
# every LayerNorm-fed site tiles the TPU kernel's grid: 16 patches + CLS +
# 15 registers = 32 tokens, × batch 8 = 256 rows; K = 256, N = 768 and 1024
_FUSED = dict(img_size=64, patch_size=16, embed_dim=256, depth=1, num_heads=2, mlp_ratio=4.0, num_reg_tokens=15)


def _jax_variables(kwargs: dict) -> dict:
    cfg = jax_vit.ViTConfig(**kwargs)
    variables = jax_vit.ImageViT(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, cfg.img_size, cfg.img_size, 3)))
    return jax.tree_util.tree_map(np.asarray, variables)


def _images(kwargs: dict, batch: int, seed: int) -> np.ndarray:
    size = kwargs["img_size"]
    return np.random.default_rng(seed).normal(size=(batch, size, size, 3)).astype(np.float32)


def _torch_model(kwargs: dict, quant: str, variables: dict) -> torch_vit.ImageViT:
    cfg = torch_vit.ViTConfig(**kwargs, quant=quant)
    model = torch_vit.ImageViT(cfg).eval()
    model.load_state_dict(torch_vit.state_dict_from_jax(variables, cfg))  # strict
    return model


@pytest.mark.parametrize("kwargs", [_SMALL, _MLP], ids=["swiglu", "mlp"])
def test_quantize_vit_params_matches_jax(kwargs):
    variables = _jax_variables(kwargs)
    qparams = jax_vit.quantize_vit_params(variables["params"], jax_vit.ViTConfig(**kwargs))
    cfg = torch_vit.ViTConfig(**kwargs)
    state = torch_vit.state_dict_from_jax(variables, cfg)
    qstate = torch_vit.quantize_vit_params(state, cfg)
    assert set(qstate) == set(torch_vit.ImageViT(dataclasses.replace(cfg, quant="int8")).state_dict()) - {
        f"{site}.amax" for site in torch_vit.vit_quant_sites(cfg.depth)
    }
    for i in range(cfg.depth):
        for branch, site in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            leaf = qparams[f"block_{i}"][branch][site]
            prefix = f"blocks.{i}.{branch}.{site}"
            assert qstate[prefix + ".weight_q"].dtype == torch.int8
            np.testing.assert_array_equal(qstate[prefix + ".weight_q"].numpy(), np.asarray(leaf["kernel_q"]).T)
            np.testing.assert_allclose(qstate[prefix + ".w_scale"].numpy(), np.asarray(leaf["w_scale"]), rtol=0, atol=1e-7)


@pytest.mark.parametrize("kwargs", [_SMALL, _MLP], ids=["swiglu", "mlp"])
def test_observe_amax_matches_jax(kwargs):
    variables = _jax_variables(kwargs)
    images = _images(kwargs, batch=3, seed=1)
    act_stats = jax_vit.calibrate_act_stats(jax_vit.ViTConfig(**kwargs), variables, jnp.asarray(images))
    model = _torch_model(kwargs, "observe", variables)
    amax = torch_vit.calibrate_act_stats(model, torch.from_numpy(images))
    assert set(amax) == {f"{site}.amax" for site in torch_vit.vit_quant_sites(2)}
    for i in range(2):
        for branch, site in (("attn", "qkv"), ("attn", "proj"), ("mlp", "fc1"), ("mlp", "fc2")):
            want = float(act_stats[f"block_{i}"][branch][site]["amax"])
            got = amax[f"blocks.{i}.{branch}.{site}.amax"]
            assert got.dtype == torch.float32 and got.shape == ()
            assert got.item() == pytest.approx(want, rel=1e-6, abs=1e-6), (i, branch, site)


def _qvariables(kwargs: dict, images: np.ndarray) -> dict:
    """The JAX package's int8 variables: quantized params, act_stats from an
    observe pass on ``images``."""
    cfg = jax_vit.ViTConfig(**kwargs)
    variables = _jax_variables(kwargs)
    act_stats = jax_vit.calibrate_act_stats(cfg, variables, jnp.asarray(images))
    return {"params": jax_vit.quantize_vit_params(variables["params"], cfg), "act_stats": act_stats}


@pytest.mark.parametrize("kwargs", [_SMALL, _MLP], ids=["swiglu", "mlp"])
def test_int8_image_vit_matches_jax_unfused(kwargs):
    """Against the JAX package's int8 branch as it runs off the TPU (LN,
    quantize, int8 dot, dequantize, bias after the cast)."""
    qvars = _qvariables(kwargs, _images(kwargs, batch=3, seed=1))
    images = _images(kwargs, batch=2, seed=2)
    ref = np.asarray(jax_vit.ImageViT(jax_vit.ViTConfig(**kwargs, quant="int8")).apply(qvars, jnp.asarray(images)))
    model = _torch_model(kwargs, "int8", qvars)
    with torch.inference_mode():
        out = model(torch.from_numpy(images)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert torch_lnd.QUANT_LAUNCHES == 0


def test_int8_image_vit_matches_jax_fused(interpret_pallas, monkeypatch):
    """Against the JAX package's fused branch (``ln_quant_dense``'s Pallas
    kernel at every LayerNorm-fed site, interpret mode)."""
    monkeypatch.setattr(jax_vit, "_use_fused_ln_dense", lambda: True)
    kwargs = _FUSED
    cfg = jax_vit.ViTConfig(**kwargs)
    hidden = int(cfg.embed_dim * cfg.mlp_ratio)
    m = 8 * (cfg.num_patches + cfg.num_prefix_tokens)
    for k, n in ((cfg.embed_dim, 3 * cfg.embed_dim), (cfg.embed_dim, hidden)):
        assert jax_lnd._pick_quant_tiles(m, k, n, 4) is not None
    qvars = _qvariables(kwargs, _images(kwargs, batch=4, seed=5))
    # the packages' f32 pipelines agree to a few ulps before each quantize,
    # but an activation within those ulps of a half-integer of the int8 grid
    # rounds either way, and one step moves a CLS output by about 0.05: the
    # seed draws images with no such activation (seeds 7, 8, 10 and 26 of
    # 7-29 have one)
    images = _images(kwargs, batch=8, seed=12)
    ref = np.asarray(jax_vit.ImageViT(dataclasses.replace(cfg, quant="int8")).apply(qvars, jnp.asarray(images)))
    with torch.inference_mode():
        out = _torch_model(kwargs, "int8", qvars)(torch.from_numpy(images)).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-3)
    assert np.abs(out).max() > 0


def test_quant_state_round_trips_through_the_carry_over():
    """``state_dict_from_jax`` carries an int8 tree and its act_stats into
    exactly the int8 module's state."""
    qvars = _qvariables(_SMALL, _images(_SMALL, batch=2, seed=1))
    cfg = torch_vit.ViTConfig(**_SMALL, quant="int8")
    sd = torch_vit.state_dict_from_jax(qvars, cfg)
    assert set(sd) == set(torch_vit.ImageViT(cfg).state_dict())
    assert sd["blocks.0.attn.qkv.weight_q"].dtype == torch.int8
    assert sd["blocks.1.mlp.fc2.amax"].item() == pytest.approx(float(qvars["act_stats"]["block_1"]["mlp"]["fc2"]["amax"]))


# --- the extractor and the CLI ---------------------------------------------------


def _cos(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def test_int8_extractor_against_bf16(monkeypatch):
    """The W8A8 extractor stays directionally faithful to the bf16 one
    (cosine > 0.98 per tile, on random weights, on the calibration batch and
    a held-out one), and calibrates on its first batch padded to
    ``batch_floor()``, as the JAX package does."""
    from stamp_tpu_torch.preprocessing import extractor as ext

    monkeypatch.setenv("STAMP_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("STAMP_EXTRACT_BATCH", "8")
    monkeypatch.setitem(
        torch_vit.VIT_CONFIGS,
        "test-int8",
        torch_vit.ViTConfig(patch_size=32, embed_dim=64, depth=2, num_heads=2, ffn="swiglu", mlp_ratio=4.0),
    )
    seen = []

    def calibrate(model, images):
        seen.append(images.shape)
        return torch_vit.calibrate_act_stats(model, images)

    monkeypatch.setattr(ext, "calibrate_act_stats", calibrate)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 255, (4, 224, 224, 3), dtype=np.uint8) for _ in range(2)]
    cpu = torch.device("cpu")
    bf16 = ext.make_vit_extractor(identifier="t-bf16", arch="test-int8", device=cpu)
    monkeypatch.setenv("STAMP_INT8_EXTRACTION", "1")
    int8 = ext.make_vit_extractor(identifier="t-int8", arch="test-int8", device=cpu)
    assert (bf16.precision, int8.precision) == ("bfloat16", "int8")
    for batch in batches:  # the first calibrates, the second is held out
        ref, quant = bf16.forward(batch).numpy(), int8.forward(batch).numpy()
        assert quant.shape == ref.shape == (4, 64)
        assert (_cos(ref, quant) > 0.98).all(), _cos(ref, quant)
    assert seen == [(8, 224, 224, 3)]  # once, on the padded batch


def test_cli_preprocess_int8(tmp_path, monkeypatch, stamp_logger_handlers):
    """``preprocess`` with ``extractor_precision: int8`` through the port's
    CLI on the CPU (DinoBloom-S, the zoo's smallest): the ``-int8`` artifact
    directory and the ``precision`` attribute."""
    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.io.h5 import read_h5

    rng = np.random.default_rng(0)
    arr = np.full((1024, 1024, 3), 255, np.uint8)
    arr[:, :512] = rng.integers(60, 200, (1024, 512, 3), dtype=np.uint8)
    slides = tmp_path / "slides"
    slides.mkdir()
    Image.fromarray(arr).save(
        slides / "slide.tif", format="TIFF", compression="tiff_lzw", resolution=10000.0, resolution_unit=3
    )
    out = tmp_path / "features"
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump({"preprocessing": {
        "output_dir": str(out), "wsi_dir": str(slides), "extractor": "dino-bloom", "device": "cpu",
        "max_workers": 2, "extractor_precision": "int8",
    }}))  # fmt: skip
    monkeypatch.setenv("STAMP_RANDOM_WEIGHTS", "1")
    monkeypatch.setenv("STAMP_EXTRACT_BATCH", "8")
    monkeypatch.setenv("HOME", str(tmp_path))
    main(["-c", str(config), "preprocess"])  # exits non-zero on failure
    (h5_path,) = out.rglob("*.h5")
    directory = h5_path.parent.name
    assert directory.startswith("dino-bloom-int8-") and len(directory) == len("dino-bloom-int8-") + 8
    datasets, attrs = read_h5(h5_path)
    assert attrs["precision"] == "int8" and attrs["extractor"] == "dino-bloom"
    feats = datasets["feats"]
    assert feats.dtype == np.float16 and feats.shape == (8, 384)
    assert np.isfinite(feats).all() and np.abs(feats).max() > 0
