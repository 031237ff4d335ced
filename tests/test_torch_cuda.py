"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from flash_bwd_util import holes, skip_case_inputs
from stamp_tpu_torch.ops import flash_attention as attn
from stamp_tpu_torch.ops import ln_dense as lnd

pytestmark = pytest.mark.cuda

# max |kernel − plain| / max |plain| on bf16 outputs (see chip_smoke.py)
TOL = 1e-2
# the same on the f32 flash kernels, whose q·kᵀ and P·V run in TF32
# (10-bit mantissa, relative step 2^-11 per operand; see chip_smoke.py)
FLASH_TOL = 5e-3
# ALiBi's D·V runs in a 3×TF32 split (22 of f32's 24 mantissa bits per
# operand), summed per 64-key tile and across tiles in rounded f32.  The
# plain version's own f32 GEMM rounds too, and more: against an f64 D·V
# (chip_smoke.py phase 3b) the kernel stays near 1e-6 of max |ref| and the
# plain version near 1e-5 at T = 16,385.  1e-4 holds both and refuses plain
# TF32, whose error is of order 1e-3.
DACC_TOL = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (scale * torch.randn(*shape, device="cuda", generator=gen)).bfloat16()


def _rel_err(got, want):
    diff = (got.float() - want.float()).abs().max().item()
    return diff / max(want.float().abs().max().item(), 1e-30)


# N = 272 is the one-pass kernel's limit (attn.ONE_PASS_MAX_N); 273 (a last
# key tile of 17 keys), 320 (whole key tiles only), 785, 1,030 and 4,097 run
# the two-pass kernel (csrc/fused_qkv_long.cu), 1,030 also at d = 80; 257 and
# 261 with d = 80 are Virchow's and Virchow2's; 785 with 12 and 16 heads
# CONCH's and CONCH1.5's
@pytest.mark.parametrize(
    "b,n,h,d",
    [(1, 1, 1, 64), (3, 21, 4, 64), (2, 64, 2, 64), (2, 129, 3, 80), (4, 265, 24, 64), (2, 1030, 2, 64),
     (2, 272, 2, 64), (2, 273, 2, 64), (2, 257, 16, 80), (2, 261, 16, 80), (2, 785, 12, 64), (2, 785, 16, 64),
     (3, 320, 2, 64), (2, 1030, 2, 80), (2, 4097, 2, 64)],
)  # fmt: skip
def test_fused_qkv_mha_kernel(gen, b, n, h, d):
    qkv = _randn(gen, b, n, 3 * h * d)
    before = attn.LAUNCHES, attn.LONG_LAUNCHES
    got = attn.fused_qkv_mha(qkv, h)
    assert (attn.LAUNCHES, attn.LONG_LAUNCHES) == (before[0] + 1, before[1] + (n > attn.ONE_PASS_MAX_N))
    assert got.shape == (b, n, h * d) and got.dtype == torch.bfloat16
    assert _rel_err(got, attn.fused_qkv_mha_reference(qkv, h)) <= TOL


@pytest.mark.parametrize("n", [265, 785, 1030], ids=["one-pass", "two-pass-785", "two-pass"])
def test_fused_qkv_mha_kernel_is_deterministic(gen, n):
    """No atomics and a fixed order of keys: two calls are bitwise equal."""
    qkv = _randn(gen, 4, n, 3 * 8 * 64)
    assert torch.equal(attn.fused_qkv_mha(qkv, 8), attn.fused_qkv_mha(qkv, 8))


@pytest.mark.parametrize("n,d", [(785, 64), (273, 80)])
def test_fused_qkv_mha_two_pass_keeps_batch_items_apart(gen, n, d):
    """The two-pass kernel's tensor map zero-fills the rows past N of each
    batch item: with item 1's keys 100× larger, a key tile that read into
    the next item's rows would swamp items 0 and 2."""
    b, h = 3, 4
    qkv = torch.randn(b, n, 3 * h * d, device="cuda", generator=gen)
    qkv[1, :, h * d : 2 * h * d] *= 100
    qkv = qkv.bfloat16()
    got, want = attn.fused_qkv_mha(qkv, h), attn.fused_qkv_mha_reference(qkv, h)
    for item in range(b):
        assert _rel_err(got[item], want[item]) <= TOL


# the edges of the kernels' tiles: M off 64 and 128 (1,000; 16,960 = 64·265),
# K with a tail under one 64-wide box (136, 264), N under 8 and off the tile
# (1, 7, 200), the UNI2 sites, ViT-L (K = 1024, M = 8·257), Virchow (1280)
# and CONCH's qkv and fc1 (K = 768, M = 2·785)
LN_DENSE_SHAPES = [
    (1, 8, 1, True), (300, 136, 200, True), (256, 512, 256, False), (1000, 1536, 4608, True),
    (1000, 264, 200, True), (1000, 264, 7, True), (16960, 1536, 1, False), (16960, 4096, 1536, True),
    (2056, 1024, 3072, True), (2056, 1280, 3840, True), (1570, 768, 2304, True), (1570, 768, 3072, True),
]  # fmt: skip


@pytest.mark.parametrize("m,k,n,bias", LN_DENSE_SHAPES)
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


def test_ln_dense_kernels_are_deterministic(gen):
    """No atomics and a fixed order of K: two calls are bitwise equal."""
    x, g, b = _randn(gen, 1000, 1536), _randn(gen, 1536), _randn(gen, 1536)
    w, d = _randn(gen, 4608, 1536, scale=1536**-0.5), _randn(gen, 4608)
    assert torch.equal(lnd.ln_dense(x, g, b, w, d), lnd.ln_dense(x, g, b, w, d))
    x, g, b, s_x, wq, ws, d = _quant_inputs(gen, 1000, 1536, 4608, 4.0, True)
    args = (x, g, b, s_x, wq, ws, d)
    assert torch.equal(lnd.ln_quant_dense(*args), lnd.ln_quant_dense(*args))


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


def _flash_inputs(gen, bh, t, d, heads=8):
    """q, k, v ~ N(0, 1), the last 40% of keys masked (bucket padding),
    coordinates on a 256 µm grid shared by the heads of a batch element,
    dist_scale = 1 / mean pairwise distance of the valid tiles."""
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=gen) for _ in range(3))
    n_valid = max(1, t - (2 * t) // 5)
    key_mask = (torch.arange(t, device="cuda") < n_valid).expand(bh, t).contiguous()
    side = max(1, int(n_valid**0.5))
    idx = torch.arange(t, device="cuda")
    grid = torch.stack([idx % side, idx // side], dim=-1).float() * 256.0
    coords = grid.expand(bh, t, 2).contiguous()
    valid = grid[:n_valid]
    mean = torch.cdist(valid.double(), valid.double()).mean().clamp_min(1.0)
    dist_scale = torch.rand(bh, device="cuda", generator=gen) / mean.float()
    return q, k, v, key_mask, coords, dist_scale


@pytest.mark.parametrize(
    "bh,t,d", [(3, 1, 64), (3, 300, 64), (2, 130, 32), (2, 200, 128), (8, 4097, 64)]
)
def test_flash_mha_kernel(gen, bh, t, d):
    q, k, v, key_mask, _, _ = _flash_inputs(gen, bh, t, d)
    before = attn.FLASH_MHA_LAUNCHES
    out, lse = attn._flash_forward(q, k, v, key_mask)
    assert attn.FLASH_MHA_LAUNCHES == before + 1
    want, want_lse = attn._flash_forward_reference(q, k, v, key_mask)
    assert out.shape == (bh, t, d) and out.dtype == torch.float32
    assert _rel_err(out, want) <= FLASH_TOL
    assert _rel_err(lse, want_lse) <= FLASH_TOL


@pytest.mark.parametrize(
    "bh,t,d", [(3, 1, 64), (3, 300, 64), (2, 130, 32), (2, 200, 128), (8, 4097, 64)]
)
def test_flash_alibi_mha_kernel(gen, bh, t, d):
    q, k, v, key_mask, coords, dist_scale = _flash_inputs(gen, bh, t, d)
    before = attn.FLASH_ALIBI_MHA_LAUNCHES
    out, out_sm, dacc, lse = attn._flash_alibi_forward(q, k, v, coords, coords, dist_scale, key_mask)
    assert attn.FLASH_ALIBI_MHA_LAUNCHES == before + 1
    want_sm, want_dacc, want_lse = attn._flash_alibi_forward_reference(q, k, v, coords, coords, key_mask)
    want = want_sm - dist_scale[:, None, None] * want_dacc
    assert _rel_err(out, want) <= FLASH_TOL
    assert _rel_err(out_sm, want_sm) <= FLASH_TOL
    assert _rel_err(lse, want_lse) <= FLASH_TOL
    assert _rel_err(dacc, want_dacc) <= DACC_TOL


def test_flash_kernels_raise_on_what_they_do_not_take(gen):
    q, k, v, key_mask, coords, dist_scale = _flash_inputs(gen, 2, 10, 64)
    with pytest.raises(TypeError):
        attn.flash_mha(q.double(), k.double(), v.double(), key_mask)
    wide = torch.randn(2, 10, 160, device="cuda", generator=gen)  # no instance holds it; 48 is padded to 64
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_mha(wide, wide, wide, key_mask)
    with pytest.raises(ValueError, match="key_mask"):
        attn.flash_mha(q, k, v, key_mask.float())
    with pytest.raises(ValueError, match="contiguous"):
        attn.flash_alibi_mha(q, k, v, coords.transpose(0, 1).contiguous().transpose(0, 1), coords, dist_scale, key_mask)


# The forward's tile skipping (inputs: tests/flash_bwd_util.py): whole masked
# 64- and 128-key tiles between valid keys and scattered masked keys in the
# tiles it keeps, a sequence with no valid key (it keeps every tile),
# ragged and unequal Tq, Tk, one query and one key, d = 32, 128.
FWD_CASES = {
    "holes": (3, 700, 700, 64, "holes"),
    "no-valid-key": (3, 300, 300, 64, "one-empty"),
    "ragged-holes": (3, 333, 700, 64, "holes"),
    "ragged-keys": (3, 700, 517, 64, "holes"),
    "one-key": (3, 1, 1, 64, "suffix"),
    "one-query": (2, 1, 300, 64, "holes"),
    "d32-holes": (2, 700, 700, 32, "holes"),
    "d32-no-valid-key": (3, 200, 300, 32, "one-empty"),
    "d128-holes": (2, 517, 700, 128, "holes"),
    "d128-no-valid-key": (3, 700, 700, 128, "one-empty"),
}


def _grouped_errs(got, want, has_valid):
    """max |Δ| / max |ref| over the sequences with a valid key and over
    those without: a sequence with no valid key has lse ≈ −1e30 and would
    set the scale of the others."""
    return [_rel_err(got[rows], want[rows]) for rows in (has_valid, ~has_valid) if rows.any()]


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
@pytest.mark.parametrize("case", list(FWD_CASES))
def test_flash_forward_skips_only_empty_tiles(gen, case, use_alibi):
    bh, tq, tk, d, mask_kind = FWD_CASES[case]
    q, k, v, key_mask, _, coords_q, coords_k, dist_scale = skip_case_inputs(gen, bh, tq, tk, d, mask_kind, "dense")
    before = (attn.FLASH_MHA_LAUNCHES, attn.FLASH_ALIBI_MHA_LAUNCHES, attn.DIST_WEIGHTED_SUM_LAUNCHES)
    if use_alibi:
        args = (q, k, v, coords_q, coords_k, dist_scale, key_mask)
        got, again = attn._flash_alibi_forward(*args), attn._flash_alibi_forward(*args)
        want_sm, want_dacc, want_lse = attn._flash_alibi_forward_reference(q, k, v, coords_q, coords_k, key_mask)
        want = (want_sm - dist_scale[:, None, None] * want_dacc, want_sm, want_dacc, want_lse)
        tols = (FLASH_TOL, FLASH_TOL, DACC_TOL, FLASH_TOL)
        counts = (before[0], before[1] + 2, before[2])  # the distance-weighted sum inside counts no launch of its own
    else:
        got, again = attn._flash_forward(q, k, v, key_mask), attn._flash_forward(q, k, v, key_mask)
        want = attn._flash_forward_reference(q, k, v, key_mask)
        tols = (FLASH_TOL, FLASH_TOL)
        counts = (before[0] + 2, before[1], before[2])
    assert (attn.FLASH_MHA_LAUNCHES, attn.FLASH_ALIBI_MHA_LAUNCHES, attn.DIST_WEIGHTED_SUM_LAUNCHES) == counts
    has_valid = key_mask.any(dim=1)
    for a, b, tol in zip(got, want, tols):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert max(_grouped_errs(a, b, has_valid)) <= tol, _grouped_errs(a, b, has_valid)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # O, lse (and dacc, out) bitwise repeatable


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
@pytest.mark.parametrize("t,d", [(333, 64), (517, 32), (70, 128)])
def test_flash_forward_with_every_key_masked(gen, t, d, use_alibi):
    """No valid key at a ragged T: every key in range weighs 1 (score
    −1e30 against a max of −1e30), the keys past T weigh 0, so O is the
    mean of V over the T keys and lse = −1e30 + log T, as in the plain
    version."""
    q, k, v = (torch.randn(2, t, d, device="cuda", generator=gen) for _ in range(3))
    key_mask = torch.zeros(2, t, dtype=torch.bool, device="cuda")
    coords = (torch.randint(0, 40, (2, t, 2), device="cuda", generator=gen) * 256.0).float()
    if use_alibi:
        out, out_sm, dacc, lse = attn._flash_alibi_forward(q, k, v, coords, coords, torch.ones(2, device="cuda"), key_mask)
        assert not dacc.any() and torch.equal(out, out_sm)  # D is 0 on masked keys
    else:
        out_sm, lse = attn._flash_forward(q, k, v, key_mask)
    want, want_lse = attn._flash_forward_reference(q, k, v, key_mask)
    assert _rel_err(want, v.mean(dim=1, keepdim=True).expand_as(want)) <= 1e-5
    assert _rel_err(out_sm, want) <= FLASH_TOL
    assert _rel_err(lse, want_lse) <= FLASH_TOL


@pytest.mark.parametrize("d", [32, 48, 64, 128])
def test_flash_forward_head_widths(gen, d):
    """The public wrappers at every instance's width and at 48 (zero-padded
    to 64), with whole masked tiles, against the plain versions at the true
    width."""
    q, k, v, key_mask, _, coords_q, coords_k, dist_scale = skip_case_inputs(gen, 3, 1000, 1000, d, "holes", "dense")
    got = attn.flash_mha(q, k, v, key_mask)
    assert got.shape == (3, 1000, d)
    assert _rel_err(got, attn.flash_mha_reference(q, k, v, key_mask)) <= FLASH_TOL
    args = (q, k, v, coords_q, coords_k, dist_scale, key_mask)
    assert _rel_err(attn.flash_alibi_mha(*args), attn.flash_alibi_mha_reference(*args)) <= FLASH_TOL


# backward: the TF32 products (five of them) against the plain f32 backward
BWD_TOL = 5e-3


def _bwd_rel_errs(got, want):
    """max |Δ| / max |ref| of each gradient.  With one key per sequence
    softmax is constant, dS = 0 and the reference dq and dk are exactly 0
    while the kernel's TF32 dP − D leaves rounding: there the scale of dq and
    dk is taken from dv, the gradient that does not cancel."""
    floor = want[2].abs().max().item() if want[0].shape[1] == 1 and len(want) == 3 else 1e-30
    return [
        (a.float() - b.float()).abs().max().item() / max(b.float().abs().max().item(), floor)
        for a, b in zip(got, want)
    ]


@pytest.mark.parametrize(
    "bh,t,d", [(3, 1, 64), (3, 300, 64), (2, 130, 32), (2, 200, 128), (8, 4097, 64)]
)
def test_flash_mha_backward_kernels(gen, bh, t, d):
    q, k, v, key_mask, _, _ = _flash_inputs(gen, bh, t, d)
    do = torch.randn(bh, t, d, device="cuda", generator=gen)
    out, lse = attn._flash_forward_reference(q, k, v, key_mask)
    before = attn.FLASH_MHA_BWD_LAUNCHES
    got = attn._flash_backward(q, k, v, key_mask, out, lse, do)
    assert attn.FLASH_MHA_BWD_LAUNCHES == before + 1
    want = attn._flash_backward_reference(q, k, v, key_mask, out, lse, do)
    assert max(_bwd_rel_errs(got, want)) <= BWD_TOL
    masked = ~key_mask
    assert not got[1][masked].any() and not got[2][masked].any()  # dk, dv of masked keys
    again = attn._flash_backward(q, k, v, key_mask, out, lse, do)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bitwise equal


@pytest.mark.parametrize("bh,t,d", [(3, 300, 64), (2, 200, 128), (8, 4097, 64)])
def test_flash_alibi_mha_backward_kernels(gen, bh, t, d):
    q, k, v, key_mask, coords, dist_scale = _flash_inputs(gen, bh, t, d)
    do = torch.randn(bh, t, d, device="cuda", generator=gen)
    out_sm, dacc, lse = attn._flash_alibi_forward_reference(q, k, v, coords, coords, key_mask)
    args = (q, k, v, coords, coords, dist_scale, key_mask, out_sm, dacc, lse, do)
    before = (attn.FLASH_ALIBI_MHA_BWD_LAUNCHES, attn.DIST_WEIGHTED_SUM_LAUNCHES)
    got = attn._flash_alibi_backward(*args)
    assert (attn.FLASH_ALIBI_MHA_BWD_LAUNCHES, attn.DIST_WEIGHTED_SUM_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want = attn._flash_alibi_backward_reference(*args)
    assert max(_bwd_rel_errs(got, want)) <= BWD_TOL
    masked = ~key_mask
    assert not got[1][masked].any() and not got[2][masked].any()
    again = attn._flash_alibi_backward(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("bh,ta,tb,d", [(3, 1, 1, 64), (3, 300, 200, 64), (2, 130, 70, 32), (2, 90, 200, 128)])
def test_dist_weighted_sum_kernel(gen, bh, ta, tb, d):
    side = 40
    ca = (torch.randint(0, side, (bh, ta, 2), device="cuda", generator=gen) * 256.0).float()
    cb = (torch.randint(0, side, (bh, tb, 2), device="cuda", generator=gen) * 256.0).float()
    val = torch.randn(bh, tb, d, device="cuda", generator=gen)
    b_mask = torch.rand(bh, tb, device="cuda", generator=gen) < 0.8
    before = attn.DIST_WEIGHTED_SUM_LAUNCHES
    for mask in (b_mask, None):
        got = attn._dist_weighted_sum(ca, cb, val, mask)
        assert _rel_err(got, attn._dist_weighted_sum_reference(ca, cb, val, mask)) <= DACC_TOL
    assert attn.DIST_WEIGHTED_SUM_LAUNCHES == before + 2


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_flash_head_width_48(gen, use_alibi):
    """A head width without an instance: q, k, v zero-padded to 64 through
    the autograd Functions, forward and gradients against the plain
    versions at the true width."""
    q, k, v, key_mask, coords, dist_scale = _flash_inputs(gen, 8, 4097, 48)
    do = torch.randn(8, 4097, 48, device="cuda", generator=gen)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, dist_scale)]
    before = (attn.FLASH_ALIBI_MHA_LAUNCHES, attn.FLASH_ALIBI_MHA_BWD_LAUNCHES) if use_alibi else (
        attn.FLASH_MHA_LAUNCHES, attn.FLASH_MHA_BWD_LAUNCHES)  # fmt: skip
    if use_alibi:
        out = attn.flash_alibi_mha(*leaves[:3], coords, coords, leaves[3], key_mask)
        got = torch.autograd.grad(out, leaves, do)
        out_sm, dacc, lse = attn._flash_alibi_forward_reference(q, k, v, coords, coords, key_mask)
        want_out = out_sm - dist_scale[:, None, None] * dacc
        want = attn._flash_alibi_backward_reference(q, k, v, coords, coords, dist_scale, key_mask, out_sm, dacc, lse, do)
        after = (attn.FLASH_ALIBI_MHA_LAUNCHES, attn.FLASH_ALIBI_MHA_BWD_LAUNCHES)
    else:
        out = attn.flash_mha(*leaves[:3], key_mask)
        got = torch.autograd.grad(out, leaves[:3], do)
        want_out, lse = attn._flash_forward_reference(q, k, v, key_mask)
        want = attn._flash_backward_reference(q, k, v, key_mask, want_out, lse, do)
        after = (attn.FLASH_MHA_LAUNCHES, attn.FLASH_MHA_BWD_LAUNCHES)
    assert after == (before[0] + 1, before[1] + 1)
    assert out.shape == (8, 4097, 48)
    assert _rel_err(out, want_out) <= FLASH_TOL
    assert max(_bwd_rel_errs(got, want)) <= BWD_TOL


def test_flash_autograd_functions_launch_the_backward_kernels(gen):
    q, k, v, key_mask, coords, dist_scale = _flash_inputs(gen, 2, 300, 64)
    leaves = [t.clone().requires_grad_() for t in (q, k, v, dist_scale)]
    before = (attn.FLASH_MHA_BWD_LAUNCHES, attn.FLASH_ALIBI_MHA_BWD_LAUNCHES)
    attn.flash_mha(*leaves[:3], key_mask).sum().backward()
    attn.flash_alibi_mha(*leaves[:3], coords, coords, leaves[3], key_mask).sum().backward()
    assert (attn.FLASH_MHA_BWD_LAUNCHES, attn.FLASH_ALIBI_MHA_BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    assert all(torch.isfinite(leaf.grad).all() for leaf in leaves)


# The backward's tile-skipping cases (their inputs: tests/flash_bwd_util.py):
# whole masked 64- and 128-key tiles between valid keys, a sequence with no
# valid key, the last and first MIL layers' dO, ragged and unequal Tq, Tk,
# d = 32, 128.
SKIP_CASES = {
    "holes": (3, 700, 700, 64, "holes", "dense"),
    "no-valid-key": (3, 300, 300, 64, "one-empty", "dense"),
    "last-layer": (4, 700, 700, 64, "suffix", "row0"),
    "first-layer": (4, 700, 700, 64, "suffix", "padded-rows-zero"),
    "ragged-holes": (3, 333, 700, 64, "holes", "dense"),
    "ragged-last-layer": (3, 700, 517, 64, "holes", "row0"),
    "d32-holes-first-layer": (2, 700, 700, 32, "holes", "padded-rows-zero"),
    "d32-no-valid-key": (3, 200, 300, 32, "one-empty", "row0"),
    "d128-holes": (2, 517, 700, 128, "holes", "dense"),
    "d128-no-valid-key-first-layer": (3, 700, 700, 128, "one-empty", "padded-rows-zero"),
}


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_flash_backward_skips_only_zero_tiles(gen, case, use_alibi):
    bh, tq, tk, d, mask_kind, do_kind = SKIP_CASES[case]
    q, k, v, key_mask, do, coords_q, coords_k, dist_scale = skip_case_inputs(gen, bh, tq, tk, d, mask_kind, do_kind)
    if use_alibi:
        out_sm, dacc, lse = attn._flash_alibi_forward_reference(q, k, v, coords_q, coords_k, key_mask)
        args = (q, k, v, coords_q, coords_k, dist_scale, key_mask, out_sm, dacc, lse, do)
        got, again = attn._flash_alibi_backward(*args), attn._flash_alibi_backward(*args)
        want = attn._flash_alibi_backward_reference(*args)
    else:
        out, lse = attn._flash_forward_reference(q, k, v, key_mask)
        args = (q, k, v, key_mask, out, lse, do)
        got, again = attn._flash_backward(*args), attn._flash_backward(*args)
        want = attn._flash_backward_reference(*args)
    # per sequence, so that a sequence with no valid key (P = 1 on every
    # key, large gradients) does not set the scale of the others
    for i in range(bh):
        errs = _bwd_rel_errs([g[i : i + 1] for g in got[:3]], [w[i : i + 1] for w in want[:3]])
        assert max(errs) <= BWD_TOL, (i, errs)
    if use_alibi:
        assert _rel_err(got[3], want[3]) <= BWD_TOL
    has_valid = key_mask.any(dim=1)
    masked = ~key_mask & has_valid[:, None]  # exactly zero dk and dv where P = 0
    assert not got[1][masked].any() and not got[2][masked].any()
    zero_do = (do == 0).all(dim=-1)  # exactly zero dq where dO is zero
    assert zero_do.any() == (do_kind != "dense")
    assert not got[0][zero_do].any()
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics: bitwise equal


# --- row 8 alone: the distance-weighted sum with its a-mask ------------------------


def _dws_case(gen, bh, ta, tb, d, a_kind, b_kind):
    """Coordinates (µm), values and the a-mask of one distance-weighted-sum
    case.  ``a_kind``: "holes" (whole masked 64- and 128-row tiles, 30% of
    the other rows, row 0 kept), "one-empty" (the last 40% masked, and
    every row of sequence 1) or "none".  ``b_kind``: "dense", "zero-tiles"
    (values zero on the same whole tiles of b) or "row0" (zero but on row
    0, the last MIL layer's dO)."""
    side = 40
    ca = (torch.randint(0, side, (bh, ta, 2), device="cuda", generator=gen) * 256.0).float()
    cb = (torch.randint(0, side, (bh, tb, 2), device="cuda", generator=gen) * 256.0).float()
    val = torch.randn(bh, tb, d, device="cuda", generator=gen) / (side * 256.0)
    if b_kind == "zero-tiles":
        val[:, holes(tb, "cuda")] = 0.0
    elif b_kind == "row0":
        val[:, 1:] = 0.0
    a_mask = None
    if a_kind == "holes":
        scattered = torch.rand(bh, ta, device="cuda", generator=gen) < 0.3
        a_mask = ~holes(ta, "cuda") & (~scattered | (torch.arange(ta, device="cuda") == 0))
    elif a_kind == "one-empty":
        a_mask = (torch.arange(ta, device="cuda") < ta - (2 * ta) // 5).expand(bh, ta).clone()
        a_mask[1] = False
    return ca, cb, val, a_mask


# (bh, ta, tb, d, a-mask, values): the skipped a tiles (whole masked 64- and
# 128-row tiles, a sequence whose rows are all masked) and b tiles (values
# zero on whole tiles, the last layer's dO), ragged and unequal A and B
DWS_CASES = {
    "holes": (3, 700, 700, 64, "holes", "dense"),
    "zero-b-tiles": (3, 700, 700, 64, "none", "zero-tiles"),
    "holes-zero-b-tiles": (2, 700, 517, 64, "holes", "zero-tiles"),
    "last-layer": (4, 700, 700, 64, "one-empty", "row0"),
    "every-row-masked": (3, 300, 300, 64, "one-empty", "dense"),
    "ragged": (3, 333, 700, 64, "holes", "dense"),
    "d32-holes-last-layer": (2, 700, 300, 32, "holes", "row0"),
    "d128-holes": (2, 517, 700, 128, "holes", "zero-tiles"),
    "d128-every-row-masked": (3, 700, 333, 128, "one-empty", "dense"),
}


@pytest.mark.parametrize("case", list(DWS_CASES))
def test_dist_weighted_sum_skips_only_zero_tiles(gen, case):
    """Row 8 with an a-mask and zero values: within DACC_TOL of the plain
    version, rows the a-mask drops exactly zero, bitwise repeatable."""
    bh, ta, tb, d, a_kind, b_kind = DWS_CASES[case]
    ca, cb, val, a_mask = _dws_case(gen, bh, ta, tb, d, a_kind, b_kind)
    before = attn.DIST_WEIGHTED_SUM_LAUNCHES
    got, again = attn._dist_weighted_sum(ca, cb, val, None, a_mask), attn._dist_weighted_sum(ca, cb, val, None, a_mask)
    assert attn.DIST_WEIGHTED_SUM_LAUNCHES == before + 2
    want = attn._dist_weighted_sum_reference(ca, cb, val, None, a_mask)
    for i in range(bh):  # per sequence: one whose rows are all masked is all zero
        if want[i].any():
            assert _rel_err(got[i], want[i]) <= DACC_TOL, i
    if a_mask is not None:
        assert not got[~a_mask].any()
        assert got[a_mask].any()
    assert torch.equal(got, again)  # no atomics: bitwise equal


@pytest.mark.parametrize("case", list(SKIP_CASES))
def test_dist_weighted_sum_as_the_alibi_backward_calls_it(gen, case):
    """The backward's skip cases (tests/flash_bwd_util.py) through row 8
    alone: a = keys with the key mask as the a-mask, b = queries with
    dist_scale·dO as the values."""
    bh, tq, tk, d, mask_kind, do_kind = SKIP_CASES[case]
    _, _, _, key_mask, do, coords_q, coords_k, dist_scale = skip_case_inputs(gen, bh, tq, tk, d, mask_kind, do_kind)
    val = do * dist_scale[:, None, None]
    got = attn._dist_weighted_sum(coords_k, coords_q, val, None, key_mask)
    want = attn._dist_weighted_sum_reference(coords_k, coords_q, val, None, key_mask)
    for i in range(bh):
        if want[i].any():
            assert _rel_err(got[i], want[i]) <= DACC_TOL, i
    assert not got[~key_mask].any()
    assert torch.equal(got, attn._dist_weighted_sum(coords_k, coords_q, val, None, key_mask))


# --- row 3: ln_quant_dense (W8A8) -----------------------------------------------


def _quant_inputs(gen, m, k, n, amax, bias):
    """bf16 x, γ, β; int8 W_q [n, k] with per-channel f32 scales; the dense
    bias; s_x from ``amax`` as the port's QuantDense forms it on the device."""
    x = _randn(gen, m, k)
    g = (1.0 + 0.1 * torch.randn(k, device="cuda", generator=gen)).bfloat16()
    b = _randn(gen, k, scale=0.1)
    wq = torch.randint(-127, 128, (n, k), device="cuda", generator=gen, dtype=torch.int8)
    ws = 1e-3 * (0.5 + torch.rand(n, device="cuda", generator=gen))
    d = _randn(gen, n, scale=0.1) if bias else None
    s_x = torch.tensor(amax, device="cuda").clamp_min(1e-6) * 1.05
    return x, g, b, s_x, wq, ws, d


def _quant_steps(x, g, b, s_x):
    """|kernel − plain| of the int8 activations, in quantization steps: the
    kernel's read back through an identity weight (w_scale 1, no bias;
    out = q·s_x/127 in bf16, whose 8-bit mantissa holds |q| ≤ 127 to within
    0.25 of a step)."""
    k = x.shape[1]
    eye = torch.eye(k, device=x.device, dtype=torch.int8)
    out = lnd.ln_quant_dense(x, g, b, s_x, eye, torch.ones(k, device=x.device))
    got = torch.round(out.float() / (s_x / 127.0)).to(torch.int32)
    want = lnd.quantize_activation(lnd.layer_norm_f32(x, g, b, 1e-6).to(torch.bfloat16), s_x).int()
    return (got - want).abs()


@pytest.mark.parametrize(
    "m,k,n,amax,bias",
    [
        (1, 16, 1, 4.0, True),
        (300, 208, 200, 4.0, True),  # ragged M, N; K = 1⅝ blocks of 128
        (256, 512, 256, 4.0, False),
        (1000, 1536, 4608, 4.0, True),
        (130, 96, 72, 1e-9, True),  # s_x clamps at 1e-6·1.05: every nonzero value saturates
        (1000, 272, 200, 4.0, True),  # K tail of 16 past two blocks: one raw x box wholly past K
        (1000, 272, 7, 4.0, True),
        (16960, 1536, 1, 4.0, False),
        (2056, 1024, 3072, 4.0, True),  # ViT-L
        (2056, 3416, 1280, 4.0, True),  # Virchow's fc2: K = 8 mod 16, W_q padded to 16-byte rows
        (2056, 3416, 1280, 4.0, False),
        (1570, 768, 2304, 4.0, True),  # CONCH's qkv and fc1
        (1570, 768, 3072, 4.0, True),
    ],
)
def test_ln_quant_dense_kernel(gen, m, k, n, amax, bias):
    x, g, b, s_x, wq, ws, d = _quant_inputs(gen, m, k, n, amax, bias)
    before = lnd.QUANT_LAUNCHES
    got = lnd.ln_quant_dense(x, g, b, s_x, wq, ws, d)
    assert lnd.QUANT_LAUNCHES == before + 1
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _rel_err(got, lnd.ln_quant_dense_reference(x, g, b, s_x, wq, ws, d)) <= TOL
    assert _quant_steps(x, g, b, s_x).max().item() <= 1


def test_ln_quant_dense_raises_on_what_it_does_not_take(gen):
    x, g, b, s_x, wq, ws, d = _quant_inputs(gen, 4, 32, 8, 4.0, True)
    with pytest.raises(TypeError):
        lnd.ln_quant_dense(x.float(), g, b, s_x, wq, ws, d)
    with pytest.raises(TypeError):
        lnd.ln_quant_dense(x, g, b, s_x, wq.float(), ws, d)
    with pytest.raises(ValueError, match="unsupported shape"):  # K = 12: x rows of 24 bytes
        lnd.ln_quant_dense(x[:, :12].contiguous(), g[:12].contiguous(), b[:12].contiguous(), s_x,
                           wq[:, :12].contiguous(), ws, d)  # fmt: skip
    with pytest.raises(ValueError, match="contiguous"):
        lnd.ln_quant_dense(x, g, b, s_x, wq.t().contiguous().t(), ws, d)


def test_int8_virchow_forward(gen):
    """An int8 Virchow (full width, depth 2; LayerScale γ = 1 so that the
    blocks move the residual stream) calibrated on the card: its forward on
    the kernel path (fc2 at K = 3,416 included) against its plain path."""
    import dataclasses

    from stamp_tpu_torch.models import vit_image

    cfg = dataclasses.replace(vit_image.VIT_CONFIGS["virchow"], depth=2)
    with torch.device("meta"):
        model = vit_image.ImageViT(dataclasses.replace(cfg, quant="observe"))
    model.to_empty(device="cpu")
    vit_image.init_random_weights_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for block in model.blocks:
            block.ls1.gamma.fill_(1.0)
            block.ls2.gamma.fill_(1.0)
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    images = torch.randn(4, 224, 224, 3, device="cuda", generator=gen).bfloat16()
    act_stats = vit_image.calibrate_act_stats(model, images)
    with torch.no_grad():
        qstate = vit_image.quantize_vit_params(model.state_dict(), cfg)
    with torch.device("meta"):
        qmodel = vit_image.ImageViT(dataclasses.replace(cfg, quant="int8"))
    qmodel.load_state_dict({**qstate, **act_stats}, assign=True)
    qmodel.eval()
    assert qmodel.blocks[0].mlp.fc2.weight_q.shape == (1280, 3416)

    before = lnd.QUANT_LAUNCHES
    with torch.inference_mode():
        got = qmodel(images).float()
    assert lnd.QUANT_LAUNCHES == before + 3 * cfg.depth  # qkv, fc1, fc2 of each block
    with vit_image.plain_kernels(), torch.inference_mode():
        want = qmodel(images).float()
    assert torch.isfinite(got).all()
    assert torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1).min().item() >= 0.99


@pytest.mark.parametrize("quant", ["off", "int8"])
def test_conch_tower_kernel_path(gen, quant):
    """A CoCa tower at CONCH's width and 448 px (785 tokens: the two-pass
    attention kernel, csrc/fused_qkv_long.cu), depth 2, on the kernel path
    against its plain path; int8 calibrated on the card as the extractor
    does."""
    import dataclasses

    from stamp_tpu_torch.models import coca, vit_image
    from stamp_tpu_torch.models.vit_image import calibrate_act_stats, quantize_sites

    cfg = dataclasses.replace(coca.COCA_CONFIGS["conch"], depth=2)
    with torch.device("meta"):
        model = coca.CoCaVisionTower(dataclasses.replace(cfg, quant="observe" if quant == "int8" else "off"))
    model.to_empty(device="cpu")
    coca.init_random_weights_(model, torch.Generator().manual_seed(0))
    model = model.to(device="cuda", dtype=torch.bfloat16).eval()
    images = torch.randn(2, 448, 448, 3, device="cuda", generator=gen).bfloat16()
    if quant == "int8":
        act_stats = calibrate_act_stats(model, images)
        with torch.no_grad():
            qstate = quantize_sites(model.state_dict(), coca.coca_quant_sites(cfg.depth))
        with torch.device("meta"):
            model = coca.CoCaVisionTower(dataclasses.replace(cfg, quant="int8"))
        model.load_state_dict({**qstate, **act_stats}, assign=True)
        model.eval()
    before = attn.LAUNCHES, attn.LONG_LAUNCHES, lnd.LAUNCHES, lnd.QUANT_LAUNCHES
    with torch.inference_mode():
        got = model(images).float()
    fused = 2 * cfg.depth  # qkv and fc1 of each block
    assert (attn.LAUNCHES, attn.LONG_LAUNCHES, lnd.LAUNCHES, lnd.QUANT_LAUNCHES) == (
        before[0] + cfg.depth,
        before[1] + cfg.depth,
        before[2] + (fused if quant == "off" else 0),
        before[3] + (fused if quant == "int8" else 0),
    )
    with vit_image.plain_kernels(), torch.inference_mode():
        want = model(images).float()
    assert torch.isfinite(got).all() and got.shape == (2, cfg.pooled_dim)
    assert torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1).min().item() >= 0.99


# --- row 9: flash_alibi2d_mha (TITAN) --------------------------------------------


def _alibi2d_inputs(gen, bh, n, d):
    """q, k, v ~ N(0, 1); integer grid coordinates of a tissue region with
    the CLS slot at (0, 0); TITAN's geometric slopes for bh heads."""
    q, k, v = (torch.randn(bh, n, d, device="cuda", generator=gen) for _ in range(3))
    side = max(1, int(n**0.5))
    idx = torch.arange(n, device="cuda")
    grid = torch.stack([idx % side + 3, idx // side + 5], dim=-1).float()
    grid[0] = 0.0
    coords = grid.expand(bh, n, 2).contiguous()
    slopes = torch.tensor([2.0 ** (-8.0 * (i + 1) / bh) for i in range(bh)], device="cuda")
    return q, k, v, coords, slopes


@pytest.mark.parametrize(
    "bh,n,d", [(3, 1, 64), (12, 37, 64), (12, 300, 64), (2, 130, 32), (2, 200, 128), (12, 4097, 64)]
)
def test_flash_alibi2d_mha_kernel(gen, bh, n, d):
    q, k, v, coords, slopes = _alibi2d_inputs(gen, bh, n, d)
    for exempt in (True, False):
        before = attn.FLASH_ALIBI2D_LAUNCHES
        got = attn.flash_alibi2d_mha(q, k, v, coords, slopes, exempt_first=exempt)
        assert attn.FLASH_ALIBI2D_LAUNCHES == before + 1
        want = attn.flash_alibi2d_mha_reference(q, k, v, coords, slopes, exempt_first=exempt)
        assert got.shape == (bh, n, d) and got.dtype == torch.float32
        assert _rel_err(got, want) <= FLASH_TOL


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("n", [1, 37, 300, 4097])
def test_flash_alibi2d_mha_kernel_per_sequence_coords(gen, n, d):
    """Coordinates that differ between the (batch·head) sequences (each its
    own grid cells, CLS at (0, 0)), both ways of the CLS exemption."""
    bh = 2 if n == 4097 else 3
    q, k, v = (torch.randn(bh, n, d, device="cuda", generator=gen) for _ in range(3))
    coords = torch.randint(0, 150, (bh, n, 2), device="cuda", generator=gen).float()
    coords[:, 0] = 0.0
    slopes = torch.tensor([0.5, 0.0625, 0.0078125][:bh], device="cuda")
    for exempt in (True, False):
        got = attn.flash_alibi2d_mha(q, k, v, coords, slopes, exempt_first=exempt)
        want = attn.flash_alibi2d_mha_reference(q, k, v, coords, slopes, exempt_first=exempt)
        assert _rel_err(got, want) <= FLASH_TOL, exempt
    assert torch.equal(got, attn.flash_alibi2d_mha(q, k, v, coords, slopes, exempt_first=False))


def test_flash_alibi2d_mha_raises_on_what_it_does_not_take(gen):
    q, k, v, coords, slopes = _alibi2d_inputs(gen, 2, 10, 64)
    with pytest.raises(TypeError):
        attn.flash_alibi2d_mha(q.double(), k.double(), v.double(), coords, slopes)
    with pytest.raises(ValueError, match="head_dim"):
        attn.flash_alibi2d_mha(q[..., :48].contiguous(), k[..., :48].contiguous(), v[..., :48].contiguous(), coords, slopes)
    with pytest.raises(ValueError, match="coords"):
        attn.flash_alibi2d_mha(q, k, v, coords[:, :5].contiguous(), slopes)


# the slide encoders without a kernel, small: (module factory, input width)
_ENCODERS = {
    "chief": ("stamp_tpu_torch.encoding.encoder.chief", "ChiefAttentionNet", {}, 768),
    "madeleine": ("stamp_tpu_torch.models.slide_encoders", "MadeleineNet", dict(dim=64, num_heads=4, input_dim=96), 96),
    "prism": ("stamp_tpu_torch.models.slide_encoders", "PrismPerceiver",
              dict(dim=64, input_dim=96, num_latents=16, depth=2, num_heads=4), 96),
    "gigapath": ("stamp_tpu_torch.models.slide_encoders_longnet", "LongNetViT",
                 dict(dim=64, depth=2, num_heads=4, input_dim=96), 96),
    "cobra": ("stamp_tpu_torch.models.slide_encoders_cobra", "CobraNet", dict(d_model=64, input_dims=(96,)), 96),
}  # fmt: skip


@pytest.mark.parametrize("name", list(_ENCODERS))
def test_slide_encoder_on_the_card_matches_the_cpu(gen, name):
    """Each slide encoder's forward on the card against the CPU's on the
    same random weights and 3,000 tiles (GigaPath's largest segment pads,
    COBRA's scan spans 47 chunks), TF32 off: within 1e-4 of max |CPU|.
    No kernel of rows 1–9 is launched."""
    import importlib

    from stamp_tpu_torch.models.slide_encoders import init_random_weights_

    module_name, cls, kwargs, width = _ENCODERS[name]
    model = getattr(importlib.import_module(module_name), cls)(**kwargs)
    init_random_weights_(model, torch.Generator().manual_seed(0)).eval()
    cpu_gen = torch.Generator().manual_seed(1)
    inputs = [torch.randn(3000, width, generator=cpu_gen)]
    if name == "gigapath":
        inputs.append(torch.rand(3000, 2, generator=cpu_gen) * 60)
    counts = attn.FLASH_ALIBI2D_LAUNCHES, attn.LAUNCHES, lnd.LAUNCHES
    with torch.inference_mode():
        want = model(*inputs)
        got = model.to("cuda")(*(t.cuda() for t in inputs))
    if name == "chief":  # (scores, pooled feature)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=0, atol=1e-4 * want[0].abs().max().item())
        got, want = got[1], want[1]
    assert _rel_err(got.cpu(), want) <= 1e-4
    assert (attn.FLASH_ALIBI2D_LAUNCHES, attn.LAUNCHES, lnd.LAUNCHES) == counts


# --- parallel: a process group of one on the card; the prefetching feed -------


def test_nccl_group_of_one(gen):
    """A one-rank fleet with a card takes NCCL; its collectives run."""
    from stamp_tpu_torch.parallel import distributed
    from stamp_tpu_torch.parallel._fleet_launch import free_port

    distributed.init_distributed(
        coordinator_address=f"localhost:{free_port()}", num_processes=1, process_id=0, use_cuda=True
    )
    try:
        assert distributed.backend() == "nccl" and distributed.process_count() == 1
        t = torch.randn(1000, device="cuda", generator=gen)
        summed = t.clone()
        torch.distributed.all_reduce(summed)  # the flat-gradient all-reduce of a one-rank mesh
        assert torch.equal(summed, t)
        distributed.barrier()
    finally:
        distributed.shutdown_distributed()


def test_prefetch_copies_on_a_side_stream(gen, monkeypatch):
    """The tensors equal a synchronous copy; each copy was issued on a
    stream other than the consumer's."""
    import numpy as np

    from stamp_tpu_torch.parallel import prefetch

    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(8, 512, 64)).astype(np.float32), {"t": np.arange(i, i + 8)}, None) for i in range(6)]
    copy_streams = []
    as_tensor = prefetch._as_tensor

    def recording(x):
        copy_streams.append(torch.cuda.current_stream())
        return as_tensor(x)

    monkeypatch.setattr(prefetch, "_as_tensor", recording)
    consumer = torch.cuda.current_stream()
    got = list(prefetch.prefetch_to_device(iter(batches), size=2, device="cuda:0"))
    torch.cuda.synchronize()
    assert copy_streams and all(s != consumer for s in copy_streams)
    for (x, d, _), (gx, gd, gnone) in zip(batches, got, strict=True):
        assert gx.is_cuda and torch.equal(gx, torch.from_numpy(x).cuda())
        assert torch.equal(gd["t"], torch.from_numpy(d["t"]).cuda()) and gnone is None
