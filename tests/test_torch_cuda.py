"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  This file
imports no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from flash_bwd_util import holes, skip_case_inputs
from stamp_tpu_torch.ops import _build
from stamp_tpu_torch.ops import attention as attn_ops
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


def _fma_f32(a, b, c):
    """fmaf(a, b, c) of f32 tensors, rounded once as the kernel's FMAs: a·b
    is exact in f64, and TwoSum recovers the f64 sum's rounding error
    exactly, which settles the one case where rounding that sum to f32
    rounds twice: a sum that lands exactly halfway between two f32 values."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    r = s.float()
    inf = torch.tensor(float("inf"), device=r.device)
    below = torch.where(r.double() <= s, r, torch.nextafter(r, -inf))
    above = torch.where(r.double() >= s, r, torch.nextafter(r, inf))
    tie = (s == (below.double() + above.double()) / 2) & (err != 0)
    return torch.where(tie, torch.where(err > 0, above, below), r)


# UNI2's K (qkv and fc1; fc2), and tails of 8 and 16 past the last 64-wide box
@pytest.mark.parametrize("m,k", [(16960, 1536), (1000, 4096), (1000, 264), (300, 272)])
def test_ln_dense_identity_readback(gen, m, k):
    """The bf16 A the kernel normalizes, read back through an identity weight
    (no bias): each output sums one A element times 1 with zeros, so it is
    exact in f32 and in the cast, and equals bitwise
    bf16(fma(fma(x, 1/σ, −μ·(1/σ)), γ, β)) with the μ and 1/σ that the
    normalization pass wrote to the scratch."""
    x, g, b = _randn(gen, m, k), _randn(gen, k), _randn(gen, k)
    eye = torch.eye(k, device="cuda", dtype=torch.bfloat16)
    scratch = lnd._scratch(m, 2 * k, x.device)
    out = torch.empty(m, k, device="cuda", dtype=torch.bfloat16)
    err = _build.load_library().stamp_ln_dense(
        x.data_ptr(), g.data_ptr(), b.data_ptr(), eye.data_ptr(), None, None, scratch.data_ptr(), out.data_ptr(),
        0, m, k, k, 1e-6, x.device.index, torch.cuda.current_stream().cuda_stream,
    )  # fmt: skip
    _build.check(err, "ln_dense")
    mean, rstd = scratch[:m], scratch[m : 2 * m]
    y = _fma_f32(_fma_f32(x.float(), rstd[:, None], (-mean * rstd)[:, None]), g.float(), b.float())
    assert torch.equal(out, y.bfloat16())
    assert torch.equal(lnd.ln_dense(x, g, b, eye), out)


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


# Attention dropout on rows 4–5: the keep bits from the einsum path's own
# draws.  Every product is f32-accurate (three TF32 products), so the flash
# layer holds the einsum layer in full f32 to f32's rounding over the keys.
DROPOUT_RATE = 0.25
DROPOUT_TOL = 1e-5


@pytest.mark.parametrize("tq,tk", [(5, 33), (70, 1000), (129, 4097), (3, 16385)])
def test_keep_pack_kernel_is_the_plain_pack(gen, tq, tk):
    """The pack against ``draw < 1 − rate`` on the valid keys, bitwise, at
    ragged K, with holes in the mask and a sequence with no valid key."""
    draws = torch.rand((3, tq, tk), device="cuda", generator=gen)
    key_mask = torch.rand((3, tk), device="cuda", generator=gen) < 0.7
    key_mask[1] = False
    bits = attn._pack_keep(draws, DROPOUT_RATE, key_mask)
    assert bits.shape == (3, tq, -(-tk // 32)) and bits.dtype == torch.int32
    assert torch.equal(bits, attn._pack_keep_reference(draws, DROPOUT_RATE, key_mask))
    assert torch.equal(attn._unpack_keep(bits, tk), (draws < 1.0 - DROPOUT_RATE) & key_mask[:, None, :])


def _dropout_layer(q, k, v, key_mask, do, path):
    """One attention layer with dropout over [8, T, 64] as one bag of 8
    heads, its draws from a generator seeded alike on both paths: the
    output and (dq, dk, dv)."""
    leaves = [x[None].clone().requires_grad_() for x in (q, k, v)]
    g = torch.Generator(device="cuda").manual_seed(7)
    if path == "flash":
        draws = attn_ops.dropout_draws((1, *q.shape[:2], k.shape[1]), g, q.device)
        keep = attn.AttentionDropout(draws[0], DROPOUT_RATE)
        del draws
        out = attn.flash_mha(*(x[0] for x in leaves), key_mask, keep=keep)[None]
    else:
        out = attn_ops.multi_head_attention(*leaves, key_mask=key_mask[:1], dropout_rate=DROPOUT_RATE, generator=g)
    out.backward(do[None])
    return out.detach()[0], [x.grad[0] for x in leaves]


@pytest.mark.parametrize("masked", ["valid-60", "every-key-masked"])
@pytest.mark.parametrize("t", [4097, 16385])
def test_flash_dropout_against_the_einsum_path(gen, t, masked):
    """Rows 4–5 with keep bits against the einsum path (``ops.attention``,
    f32 with TF32 off) on the same draws, at [8, T, 64]: the output and dq,
    dk, dv to 1e-5 of each one's largest.  With every key masked the einsum
    path's weights are all 0 and so are the keep bits: everything is 0 on
    both.  Each launch counts once in the dropout counters alone."""
    q, k, v, key_mask, _, _ = _flash_inputs(gen, 8, t, 64)
    if masked == "every-key-masked":
        key_mask = torch.zeros_like(key_mask)
    do = torch.randn(8, t, 64, device="cuda", generator=gen)
    counts = (attn.FLASH_MHA_LAUNCHES, attn.FLASH_MHA_BWD_LAUNCHES, attn.FLASH_MHA_DROPOUT_LAUNCHES,
              attn.FLASH_MHA_DROPOUT_BWD_LAUNCHES)  # fmt: skip
    got = _dropout_layer(q, k, v, key_mask, do, "flash")
    assert (attn.FLASH_MHA_LAUNCHES, attn.FLASH_MHA_BWD_LAUNCHES, attn.FLASH_MHA_DROPOUT_LAUNCHES,
            attn.FLASH_MHA_DROPOUT_BWD_LAUNCHES) == (counts[0], counts[1], counts[2] + 1, counts[3] + 1)  # fmt: skip
    torch.cuda.empty_cache()
    want = _dropout_layer(q, k, v, key_mask, do, "einsum")
    torch.cuda.empty_cache()
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        if masked == "every-key-masked":
            assert not a.any() and not b.any()
        else:
            assert _rel_err(a, b) <= DROPOUT_TOL


def test_flash_dropout_raises_on_what_it_does_not_take(gen):
    q, k, v, key_mask, _, _ = _flash_inputs(gen, 2, 300, 64)
    draws = torch.rand((2, 300, 300), device="cuda", generator=gen)
    with pytest.raises(ValueError, match="head widths"):
        attn.flash_mha(*(torch.randn(2, 300, 128, device="cuda") for _ in range(3)), key_mask,
                       keep=attn.AttentionDropout(draws, DROPOUT_RATE))  # fmt: skip
    with pytest.raises(ValueError, match="draws"):
        attn._flash_forward(q, k, v, key_mask, keep=attn.AttentionDropout(draws[:, :, :299], DROPOUT_RATE))
    with pytest.raises(ValueError, match="rate"):
        attn._flash_forward(q, k, v, key_mask, keep=attn.AttentionDropout(draws, 1.0))


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


# the two entry forms tensor parallelism uses at SwiGLU's fc2 (K sharded,
# the inner LayerNorm's statistics all-reduced): UNI2's at tp = 2 and 4
# (M = 64·265, K = 2,048 and 1,024, N = 1,536), ragged M, K and N, odd N
ENTRY_FORM_SHAPES = [(16960, 2048, 1536), (16960, 1024, 1536), (300, 136, 200), (1000, 264, 7)]


@pytest.mark.parametrize("m,k,n", ENTRY_FORM_SHAPES)
def test_ln_dense_entry_forms(gen, m, k, n):
    """The caller's statistics in place of the kernel's, and the partial-sum
    epilogue: the f32 accumulators against the plain version's, and with
    the bias added and the cast done in PyTorch, bitwise the kernel's own
    epilogue (the same two f32 operations)."""
    x, g, b = _randn(gen, m, k), _randn(gen, k), _randn(gen, k)
    w, d = _randn(gen, n, k, scale=k**-0.5), _randn(gen, n)
    stats = lnd.row_stats(x, 1e-6)
    before, partial_before = lnd.LAUNCHES, lnd.PARTIAL_LAUNCHES
    full = lnd.ln_dense(x, g, b, w, d, stats=stats)
    acc = lnd.ln_dense(x, g, b, w, stats=stats, partial=True)
    assert (lnd.LAUNCHES, lnd.PARTIAL_LAUNCHES) == (before + 2, partial_before + 1)
    assert acc.dtype == torch.float32 and acc.shape == (m, n)
    assert _rel_err(full, lnd.ln_dense_reference(x, g, b, w, d, stats=stats)) <= TOL
    assert _rel_err(acc, lnd.ln_dense_reference(x, g, b, w, stats=stats, partial=True)) <= TOL
    assert torch.equal((acc + d.float()).bfloat16(), full)
    # the caller's statistics equal to the kernel's own: the same output within the bf16 cast
    assert _rel_err(full, lnd.ln_dense(x, g, b, w, d)) <= TOL


@pytest.mark.parametrize("m,k,n", ENTRY_FORM_SHAPES)
def test_ln_quant_dense_entry_forms(gen, m, k, n):
    """int8: with the caller's statistics the normalized activation is the
    plain version's bit for bit, so the partial-sum form's i32 sums equal
    the plain ones exactly, and dequantized in PyTorch they are the
    kernel's own epilogue bitwise."""
    x, g, b, s_x, wq, ws, d = _quant_inputs(gen, m, k, n, 4.0, True)
    stats = lnd.row_stats(x, 1e-6)
    before = lnd.QUANT_PARTIAL_LAUNCHES
    acc = lnd.ln_quant_dense(x, g, b, s_x, wq, ws, stats=stats, partial=True)
    assert lnd.QUANT_PARTIAL_LAUNCHES == before + 1
    assert acc.dtype == torch.int32
    assert torch.equal(acc, lnd.ln_quant_dense_reference(x, g, b, s_x, wq, ws, stats=stats, partial=True))
    full = lnd.ln_quant_dense(x, g, b, s_x, wq, ws, d, stats=stats)
    assert torch.equal((acc.float() * (s_x / 127.0) * ws + d.float()).bfloat16(), full)
    assert _rel_err(full, lnd.ln_quant_dense_reference(x, g, b, s_x, wq, ws, d)) <= TOL


def test_entry_forms_raise_on_what_they_do_not_take(gen):
    x, g, b = _randn(gen, 64, 64), _randn(gen, 64), _randn(gen, 64)
    w, d = _randn(gen, 32, 64), _randn(gen, 32)
    with pytest.raises(ValueError, match="no dense bias"):
        lnd.ln_dense(x, g, b, w, d, partial=True)
    with pytest.raises(ValueError, match="stats must be"):
        lnd.ln_dense(x, g, b, w, stats=lnd.row_stats(x, 1e-6).double())
    with pytest.raises(ValueError, match="stats must be"):
        lnd.ln_dense(x, g, b, w, stats=lnd.row_stats(x[:8], 1e-6))


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


# --- the program's spans on the card ---------------------------------------------


def _conv_extractor():
    """A ``tower_extractor`` around a small convolutional tower (no kernel
    of the port's to build), batches of 64 tiles of 224 px on the card."""
    from stamp_tpu_torch.preprocessing.extractor import tower_extractor

    def build(quant: str) -> torch.nn.Module:
        return torch.nn.Sequential(torch.nn.Conv2d(3, 256, 3, padding=1), torch.nn.Conv2d(256, 256, 3, padding=1),
                                   torch.nn.AdaptiveAvgPool2d(1), torch.nn.Flatten())  # fmt: skip

    def load(model: torch.nn.Module) -> torch.nn.Module:
        model.to_empty(device="cpu")
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for p in model.parameters():
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
        return model

    return tower_extractor(identifier="test-conv", build=build, load=load, sites=[], device=torch.device("cuda"),
                           input_px=224, feat_dim=256, mean=(0.5, 0.5, 0.5), std=(0.25, 0.25, 0.25),
                           apply=lambda tower, x: tower(x.permute(0, 3, 1, 2)))  # fmt: skip


def test_the_upload_span_ends_at_its_copy(gen, monkeypatch):
    """Under a CUDA trace, each ``extract/upload`` span (a blocking copy of
    a pinned batch) holds the CUDA runtime call that waits for its copy,
    queued behind the previous batch's tower, and ends within 200 µs after
    that call returns: the span lies on the trace's host clock.  (The
    profiler maps device times onto the host clock with a drift of up to
    milliseconds in some traces, so the device copy itself is only
    counted.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from stamp_tpu_torch.utils import profiling

    monkeypatch.setenv("STAMP_EXTRACT_BATCH", "64")
    monkeypatch.delenv("STAMP_INT8_EXTRACTION", raising=False)
    extractor = _conv_extractor()
    g = torch.Generator().manual_seed(0)
    batches = [torch.randint(0, 256, (64, 224, 224, 3), generator=g, dtype=torch.uint8).pin_memory() for _ in range(8)]
    extractor.forward(batches[0])  # cuDNN's choice of algorithms, outside the trace
    torch.cuda.synchronize()
    profiling.timer.reset()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            extractor.forward(batch)
        torch.cuda.synchronize()
    uploads = [r for r in profiling.records() if isinstance(r, profiling.Span) and r.name == "extract/upload"]
    events = prof.profiler.kineto_results.events()
    copies = [e for e in events if e.device_type() == DeviceType.CUDA and "HtoD" in e.name()]
    runtime = [(e.start_ns(), e.end_ns()) for e in events
               if e.device_type() == DeviceType.CPU and e.name().startswith("cuda")]  # fmt: skip
    assert len(uploads) == len(copies) == 8
    for i, span in enumerate(uploads):
        start, end = max(((s, e) for s, e in runtime if span.start_ns <= s and e <= span.end_ns), key=lambda se: se[1])
        assert 0 <= span.end_ns - end <= 200_000, (i, span, start, end)
        if i:  # behind the previous batch's tower: the wait is most of the span
            assert end - start > (span.end_ns - span.start_ns) / 2, (i, span, start, end)
    profiling.timer.reset()


class _Batches:
    """A re-iterable feed of host tile batches (bags, coords, sizes, targets)."""

    def __init__(self, batches: list) -> None:
        self.batches = batches

    def __iter__(self):
        yield from self.batches


def test_profile_adds_no_sync_to_training(gen, monkeypatch, tmp_path):
    """``train_model_`` on the card calls ``torch.cuda.synchronize`` as
    often with the stage timer on (``--profile``) as without it, and the
    timer sees every step."""
    import contextlib

    import numpy as np

    from stamp_tpu_torch.modeling.tasks import LitTileClassifier
    from stamp_tpu_torch.modeling.train import train_model_
    from stamp_tpu_torch.models.vision_transformer import VisionTransformer
    from stamp_tpu_torch.utils import profiling

    rng = np.random.default_rng(0)

    def batches(n: int) -> _Batches:
        return _Batches([(rng.normal(size=(2, 16, 8)).astype(np.float32), np.zeros((2, 16, 2), np.float32),
                          np.array([16, 16]), np.eye(2, dtype=np.float32)) for _ in range(n)])  # fmt: skip

    train, valid = batches(4), batches(1)
    synced = []
    synchronize = torch.cuda.synchronize

    def counted(*args, **kwargs):
        synced.append(1)
        return synchronize(*args, **kwargs)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    syncs = {}
    for profiled in (False, True):
        synced.clear()
        task = LitTileClassifier(
            model_class=VisionTransformer, ground_truth_label="label", categories=["a", "b"],
            category_weights=np.array([0.5, 0.5], dtype=np.float32), dim_input=8, total_steps=8, max_lr=1e-4,
            div_factor=25.0, dim_model=16, dim_feedforward=16, n_heads=2, n_layers=1, dropout=0.0, use_alibi=False,
        )  # fmt: skip
        with profiling.stage_table() if profiled else contextlib.nullcontext():
            train_model_(output_dir=tmp_path / str(profiled), model=task, train_dl=train, valid_dl=valid,
                         max_epochs=1, patience=1, device=torch.device("cuda", 0))  # fmt: skip
            if profiled:
                assert profiling.timer.calls["train/step"] == 4 and profiling.timer.calls["train/feed_wait"] == 5
        syncs[profiled] = len(synced)
    assert syncs[True] == syncs[False], syncs


# --- the ALiBi statistic's kernel and rows 6–8 at a 20× whole slide's length ---


def _slide_coords(n_valid: int, t: int, bags: int = 1) -> torch.Tensor:
    """[bags, t, 2]: the class token at (0, 0), then tiles 224 µm apart, 128
    to a row (the benchmark's grid), zeros past ``n_valid``."""
    idx = torch.arange(t - 1, device="cuda")
    grid = torch.stack([idx % 128, idx // 128], dim=-1).float() * 224.0
    coords = torch.cat([torch.zeros(1, 2, device="cuda"), grid])
    coords[n_valid:] = 0.0
    return coords.expand(bags, t, 2).contiguous()


def _f64_pair_sums(coords, mask, coords_k, key_mask, block=1024):
    """The statistic summed in float64 on the card, in row blocks."""
    total, c, ck = 0.0, coords.double(), coords_k.double()
    kw = key_mask.double()
    for s in range(0, c.shape[1], block):
        d = torch.cdist(c[:, s : s + block], ck)  # f64
        total += float((d * mask[:, s : s + block, None].double() * kw[:, None, :]).sum())
    return total, int((mask.sum(1).double() * key_mask.sum(1).double()).sum())


# Each thread sums ≤ 4,096 distances in f32 (a relative error of order
# √4096·2⁻²⁴ ≈ 4e-6 a thread, of either sign, so ~1e-7 over thousands of
# threads), the square root is sqrt.approx (relative error ≤ 2⁻²³), blocks
# add in f64: 1e-5 of the float64 sum holds that with room and refuses a
# sum of f32 partials by a single running f32 total (≈ 1e-3 at 4.3·10⁹ pairs).
PAIR_SUMS_RTOL = 1e-5


@pytest.mark.parametrize("case", ["slide-65537", "holes", "sp-share", "one-row"])
def test_alibi_pair_sums_kernel_against_float64(gen, case):
    if case == "slide-65537":  # the longest bucket with a 48,000-tile slide and its CLS
        coords = _slide_coords(48_001, 65_537)
        mask = (torch.arange(65_537, device="cuda") < 48_001)[None]
        rows = dict(coords=coords, mask=mask)
        keys = dict(coords_k=coords, key_mask=mask)
    elif case == "holes":  # three bags, scattered invalid tiles, ragged block edges
        coords = _slide_coords(2_999, 3_001, bags=3) + torch.rand(3, 3_001, 2, device="cuda", generator=gen) * 50.0
        mask = torch.rand(3, 3_001, device="cuda", generator=gen) < 0.7
        rows, keys = dict(coords=coords, mask=mask), dict(coords_k=coords, key_mask=mask)
    elif case == "sp-share":  # a rank's rows against the whole sequence's keys
        whole = _slide_coords(9_000, 10_241, bags=2)
        key_mask = (torch.arange(10_241, device="cuda") < 9_000).expand(2, -1).contiguous()
        rows = dict(coords=whole[:, 2_000:5_000].contiguous(), mask=key_mask[:, 2_000:5_000].contiguous())
        keys = dict(coords_k=whole, key_mask=key_mask)
    else:  # one row, no masks
        coords = torch.rand(1, 1, 2, device="cuda", generator=gen) * 1000.0
        rows = dict(coords=coords, mask=torch.ones(1, 1, dtype=torch.bool, device="cuda"))
        keys = dict(coords_k=_slide_coords(5, 5), key_mask=torch.ones(1, 5, dtype=torch.bool, device="cuda"))
    before = attn_ops.ALIBI_PAIR_SUMS_LAUNCHES
    if case == "one-row":  # no masks: every row and key counts
        total, n_pairs = attn_ops.pairwise_distance_sums(rows["coords"], coords_k=keys["coords_k"])
    else:
        total, n_pairs = attn_ops.pairwise_distance_sums(rows["coords"], mask=rows["mask"], **keys)
    assert attn_ops.ALIBI_PAIR_SUMS_LAUNCHES == before + 1 and total.dtype == torch.float64
    want_total, want_pairs = _f64_pair_sums(rows["coords"], rows["mask"], keys["coords_k"], keys["key_mask"])
    assert int(n_pairs) == want_pairs
    assert abs(float(total) - want_total) <= PAIR_SUMS_RTOL * want_total


def test_rows_6_to_8_at_65537_against_the_blocked_reference(gen):
    """One ALiBi layer's attention at the longest bucket of 20× whole slides
    ([8, 65,537, 64], a 48,000-tile slide, the bucket padding masked) through
    the flash forward and backward (rows 6–8), against the benchmark's
    blocked float32 reference on the unpadded tokens (TF32 off): the output,
    its softmax part, dq, dk, dv over the valid rows and keys, and
    d dist_scale.  dO is zero on the padded rows, as in the model."""
    from benchmark.reference.mil_vit_alibi import attention

    h, t, n, d = 8, 65_537, 48_001, 64
    q, k, v = (torch.randn(h, t, d, device="cuda", generator=gen) for _ in range(3))
    coords = _slide_coords(n, t)[0]
    key_mask = (torch.arange(t, device="cuda") < n).expand(h, t).contiguous()
    ref_mean = torch.cdist(coords[:n].double()[::16], coords[:n].double()[::16]).mean().float()
    dist_scale = torch.rand(h, device="cuda", generator=gen) / ref_mean
    do = torch.randn(h, t, d, device="cuda", generator=gen) * key_mask[..., None]
    cq = coords.expand(h, t, 2).contiguous()
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v, dist_scale)]
    out = attn.flash_alibi_mha(leaves[0], leaves[1], leaves[2], cq, cq, leaves[3], key_mask)
    got = [out.detach(), *torch.autograd.grad(out, leaves, do)]
    out_sm = attn._flash_alibi_forward(q, k, v, cq, cq, dist_scale, key_mask)[1]

    ref_leaves = [x[:, :n].clone().requires_grad_(True) for x in (q, k, v)] + [dist_scale.clone().requires_grad_(True)]
    ref_out = attention(*ref_leaves[:3], coords[:n], ref_leaves[3])
    want = [ref_out.detach(), *torch.autograd.grad(ref_out, ref_leaves, do[:, :n])]
    with torch.no_grad():
        want_sm = attention(q[:, :n], k[:, :n], v[:, :n], coords[:n], torch.zeros_like(dist_scale))
    # the output and dv are dominated by D·V and its transpose (f32-accurate in
    # the kernels); the softmax part, dq and dk by the TF32 products
    assert _rel_err(got[0][:, :n], want[0]) <= DACC_TOL
    assert _rel_err(out_sm[:, :n], want_sm) <= FLASH_TOL
    for g_, w_ in zip(got[1:3], want[1:3]):
        assert _rel_err(g_[:, :n], w_) <= FLASH_TOL
    assert _rel_err(got[3][:, :n], want[3]) <= DACC_TOL
    assert not got[2][:, n:].any() and not got[1][:, n:].any()
    assert _rel_err(got[4], want[4]) <= DACC_TOL
