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


@pytest.mark.parametrize("n,head_dim", [(21, 16), (21, 64), (265, 64)])
def test_fused_qkv_mha_matches_pallas(interpret_pallas, n, head_dim):
    from stamp_tpu.ops.flash_attention import fused_qkv_mha

    rng = np.random.default_rng(2)
    b, h = 2, 4
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
