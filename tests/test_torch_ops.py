"""The port's kernel modules (stamp_tpu_torch.ops) against the JAX package's
Pallas kernels, run in interpret mode, on the same numpy inputs.

On the CPU each wrapper runs its plain PyTorch version; the CUDA kernels
themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stamp_tpu_torch.ops import flash_attention as torch_attn
from stamp_tpu_torch.ops import ln_dense as torch_ln_dense


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run Pallas kernels in interpreter mode (no TPU in CI)."""
    monkeypatch.setattr(
        pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True)
    )


# UNI2 (265, 64), Virchow / Virchow2 (257 and 261 tokens, heads of 80), and
# CONCH's 785 tokens (the port's two-pass kernel on the card): with 4 heads
# the Pallas kernel takes its phase-split body, with 12 (one batch item) its
# interleaved one, as at CONCH's shapes
@pytest.mark.parametrize(
    "n,head_dim,b,h",
    [
        pytest.param(21, 16, 2, 4, id="21-16"),
        pytest.param(21, 64, 2, 4, id="21-64"),
        pytest.param(265, 64, 2, 4, id="265-64"),
        pytest.param(257, 80, 2, 4, id="257-80"),
        pytest.param(261, 80, 2, 4, id="261-80"),
        pytest.param(785, 64, 2, 4, id="785-64-phase-split"),
        pytest.param(785, 64, 1, 12, id="785-64-interleaved"),
    ],
)
def test_fused_qkv_mha_matches_pallas(interpret_pallas, n, head_dim, b, h):
    from stamp_tpu.ops.flash_attention import fused_qkv_mha

    rng = np.random.default_rng(2)
    qkv = rng.normal(size=(b, n, 3 * h * head_dim)).astype(np.float32)

    ref = np.asarray(fused_qkv_mha(jnp.asarray(qkv), h))
    out = torch_attn.fused_qkv_mha(torch.from_numpy(qkv), h)
    assert out.shape == (b, n, h * head_dim)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
def test_ln_dense_matches_pallas(interpret_pallas, with_bias):
    from stamp_tpu.ops.ln_dense import _pick_tiles, ln_dense

    rng = np.random.default_rng(0)
    m, k, n = 256, 128, 256
    assert _pick_tiles(m, k, n, 4) is not None  # the JAX side runs its kernel
    x = rng.normal(size=(4, m // 4, k)).astype(np.float32)
    g = rng.normal(size=(k,)).astype(np.float32)
    b = rng.normal(size=(k,)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)  # JAX layout [K, N]
    d = rng.normal(size=(n,)).astype(np.float32) if with_bias else None

    ref = np.asarray(
        ln_dense(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(w),
            None if d is None else jnp.asarray(d),
        )
    )
    out = torch_ln_dense.ln_dense(
        torch.from_numpy(x),
        torch.from_numpy(g),
        torch.from_numpy(b),
        torch.from_numpy(np.ascontiguousarray(w.T)),  # nn.Linear layout [N, K]
        None if d is None else torch.from_numpy(d),
    )
    assert out.shape == (4, m // 4, n)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


def test_ln_dense_untileable_rows_match_reference():
    """M = 300 does not tile on the TPU (its ln_dense falls back to the
    unfused form); the port takes every M."""
    from stamp_tpu.ops.ln_dense import _pick_tiles, ln_dense_reference

    rng = np.random.default_rng(1)
    m, k, n = 300, 128, 256
    assert _pick_tiles(m, k, n, 4) is None
    x = rng.normal(size=(m, k)).astype(np.float32)
    g = rng.normal(size=(k,)).astype(np.float32)
    b = rng.normal(size=(k,)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    d = rng.normal(size=(n,)).astype(np.float32)

    ref = np.asarray(
        ln_dense_reference(
            jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), jnp.asarray(w), jnp.asarray(d)
        )
    )
    out = torch_ln_dense.ln_dense(
        torch.from_numpy(x),
        torch.from_numpy(g),
        torch.from_numpy(b),
        torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(d),
    )
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-4)


def test_cpu_calls_do_not_count_as_launches():
    before = (torch_attn.LAUNCHES, torch_ln_dense.LAUNCHES)
    torch_attn.fused_qkv_mha(torch.zeros(1, 5, 3 * 64), 1)
    torch_ln_dense.ln_dense(
        torch.zeros(5, 8), torch.ones(8), torch.zeros(8), torch.zeros(4, 8)
    )
    assert (torch_attn.LAUNCHES, torch_ln_dense.LAUNCHES) == before


def test_kernel_wrappers_refuse_other_devices():
    """Only CPU tensors take the plain version; anything else launches the
    kernel or raises — there is no quiet fallback."""
    meta = torch.empty(1, 5, 3 * 64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        torch_attn.fused_qkv_mha(meta, 1)
    with pytest.raises(ValueError, match="unsupported device"):
        torch_ln_dense.ln_dense(
            torch.empty(5, 8, device="meta"),
            torch.empty(8, device="meta"),
            torch.empty(8, device="meta"),
            torch.empty(4, 8, device="meta"),
        )


# --- MIL flash head widths: zero-padded to the kernels' instances ----------------

_MIL_48 = dict(dim_output=3, dim_input=24, dim_model=96, n_layers=2, n_heads=2, dim_feedforward=48)  # heads of 48


def _mil_bag(dims: dict, tiles: int = 40, valid: int = 29):
    rng = np.random.default_rng(5)
    bags = rng.normal(size=(1, tiles, dims["dim_input"])).astype(np.float32)
    coords = (rng.integers(0, 12, size=(1, tiles, 2)) * 256.0).astype(np.float32)
    return bags, coords, np.arange(tiles)[None, :] < valid


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_mil_vit_head_width_48_matches_jax(use_alibi, monkeypatch):
    """Heads of 48 run on the flash path, zero-padded to the kernels' 64
    (scaled by 48^-1/2), and give the JAX module's logits and parameter
    gradients (its einsum path on the CPU) on the same weights."""
    import jax

    from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
    from stamp_tpu_torch.models import vision_transformer as torch_vit

    bags, coords, key_mask = _mil_bag(_MIL_48)
    module = JaxViT(**_MIL_48, use_alibi=use_alibi)
    inputs = (jnp.asarray(bags),)
    kwargs = dict(coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    variables = jax.tree_util.tree_map(np.asarray, dict(module.init(jax.random.PRNGKey(0), *inputs, **kwargs)))
    if use_alibi:  # the post-softmax bias as large as the softmax weights
        for i in range(_MIL_48["n_layers"]):
            variables["alibi_stats"][f"block_{i}"]["mhsa"]["running_mean"] = np.full(2, 1500.0 * 40, np.float32)
    weights = np.random.default_rng(6).normal(size=(1, _MIL_48["dim_output"])).astype(np.float32)

    def loss(params):
        return (module.apply({**variables, "params": params}, *inputs, **kwargs) * weights).sum()

    want_logits = np.asarray(module.apply(variables, *inputs, **kwargs))
    want_grads = jax.tree_util.tree_map(np.asarray, jax.grad(loss)(variables["params"]))

    widths = []
    name = "_flash_alibi_forward" if use_alibi else "_flash_forward"
    forward = getattr(torch_attn, name)
    monkeypatch.setattr(torch_attn, name, lambda q, *a: widths.append(q.shape[-1]) or forward(q, *a))
    monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    model = torch_vit.VisionTransformer(**_MIL_48, use_alibi=use_alibi)
    model.load_state_dict(torch_vit.variables_from_jax(variables))
    logits = model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask))
    (logits * torch.from_numpy(weights)).sum().backward()
    got_grads = torch_vit.variables_to_jax({n: p.grad for n, p in model.named_parameters()})["params"]

    assert widths == [64, 64]  # both layers on the flash path, padded from 48
    np.testing.assert_allclose(logits.detach().numpy(), want_logits, atol=1e-5, rtol=0)
    flat_want = jax.tree_util.tree_leaves_with_path(want_grads)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_grads))
    assert set(flat_got) == {path for path, _ in flat_want}
    largest = max(np.abs(want).max() for _, want in flat_want)
    for path, want in flat_want:
        # ALiBi's key bias has an exact gradient of 0 (softmax ignores a
        # shift shared by all keys): both sides are rounding there, held
        # against the largest gradient
        key_bias = "k_proj" in str(path) and "bias" in str(path)
        scale = largest if key_bias else max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(flat_got[path], want, atol=1e-5 * scale, rtol=1e-5, err_msg=str(path))


def test_mil_vit_refuses_heads_wider_than_the_flash_kernels(monkeypatch):
    """Heads of 160 have no kernel instance: a bag on the flash path raises
    before the first block, naming the JAX package; the einsum path runs."""
    from stamp_tpu_torch.models import vision_transformer as torch_vit

    dims = dict(_MIL_48, dim_model=320)  # 2 heads of 160
    bags, coords, key_mask = (torch.from_numpy(a) for a in _mil_bag(dims))
    model = torch_vit.VisionTransformer(**dims)
    assert torch.isfinite(model(bags, coords=coords, key_mask=key_mask)).all()
    monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    with pytest.raises(ValueError, match="python -m stamp_tpu"):
        model(bags, coords=coords, key_mask=key_mask)
    q = torch.zeros(2, 5, 160)
    with pytest.raises(ValueError, match="python -m stamp_tpu"):
        torch_attn.flash_mha(q, q, q, torch.ones(2, 5, dtype=torch.bool))
