"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from stamp_tpu_torch.ops import flash_attention as attn
from stamp_tpu_torch.ops import ln_dense as lnd

pytestmark = pytest.mark.cuda

# max |kernel − plain| / max |plain| on bf16 outputs (see chip_smoke.py)
TOL = 1e-2


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (scale * torch.randn(*shape, device="cuda", generator=gen)).bfloat16()


def _rel_err(got, want):
    return ((got.float() - want.float()).abs().max() / want.float().abs().max()).item()


@pytest.mark.parametrize(
    "b,n,h,d",
    [(1, 1, 1, 64), (3, 21, 4, 64), (2, 64, 2, 64), (2, 129, 3, 80), (4, 265, 24, 64), (2, 1030, 2, 64)],
)
def test_fused_qkv_mha_kernel(gen, b, n, h, d):
    qkv = _randn(gen, b, n, 3 * h * d)
    before = attn.LAUNCHES
    got = attn.fused_qkv_mha(qkv, h)
    assert attn.LAUNCHES == before + 1
    assert got.shape == (b, n, h * d) and got.dtype == torch.bfloat16
    assert _rel_err(got, attn.fused_qkv_mha_reference(qkv, h)) <= TOL


@pytest.mark.parametrize(
    "m,k,n,bias", [(1, 8, 1, True), (300, 136, 200, True), (256, 512, 256, False), (1000, 1536, 4608, True)]
)
def test_ln_dense_kernel(gen, m, k, n, bias):
    x = _randn(gen, m, k)
    g, b = _randn(gen, k), _randn(gen, k)
    w = _randn(gen, n, k, scale=k**-0.5)
    d = _randn(gen, n) if bias else None
    before = lnd.LAUNCHES
    got = lnd.ln_dense(x, g, b, w, d)
    assert lnd.LAUNCHES == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel_err(got, lnd.ln_dense_reference(x, g, b, w, d)) <= TOL


def test_kernels_raise_on_what_they_do_not_take(gen):
    qkv = _randn(gen, 2, 10, 3 * 2 * 64)
    with pytest.raises(TypeError):
        attn.fused_qkv_mha(qkv.float(), 2)
    with pytest.raises(ValueError, match="head_dim"):
        attn.fused_qkv_mha(_randn(gen, 2, 10, 3 * 2 * 48), 2)
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_qkv_mha(qkv.transpose(0, 1).contiguous().transpose(0, 1), 2)
    x, g, b, w = _randn(gen, 4, 16), _randn(gen, 16), _randn(gen, 16), _randn(gen, 8, 16)
    with pytest.raises(TypeError):
        lnd.ln_dense(x.float(), g, b, w)
    with pytest.raises(ValueError, match="contiguous"):
        lnd.ln_dense(x, g, b, _randn(gen, 16, 8).t())
    with pytest.raises(ValueError, match="unsupported shape"):
        lnd.ln_dense(_randn(gen, 4, 12), _randn(gen, 12), _randn(gen, 12), _randn(gen, 8, 12))
