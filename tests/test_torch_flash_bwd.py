"""The backward of the port's ``flash_mha`` and ``flash_alibi_mha`` (and the
distance-weighted sum alone) against ``jax.vjp`` of the JAX package's Pallas
kernels, run in interpret mode, on the same numpy inputs and upstream
gradient.

On the CPU the autograd Functions run their plain PyTorch backward; the CUDA
kernels are held against those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.  Shapes are ragged against the
Pallas block of 128 (T = 300), with a random key mask and µm coordinates."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from stamp_tpu_torch.ops import flash_attention as torch_attn

BLOCK = 128
RTOL = 1e-5  # f32 on both sides; only the summation order differs


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run Pallas kernels in interpreter mode (no TPU in CI)."""
    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


def _inputs(seed: int, bh: int = 3, t: int = 300, d: int = 64) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.normal(size=(bh, t, d)).astype(np.float32) for _ in range(4))
    key_mask = rng.random((bh, t)) < 0.7
    key_mask[:, 0] = True  # every query has a valid key
    coords = (rng.integers(0, 40, size=(bh, t, 2)) * 256.0).astype(np.float32)
    # about 1 / (mean distance · T): the bias and the softmax weigh alike
    dist_scale = (rng.random(bh) / (5000.0 * t)).astype(np.float32)
    return dict(q=q, k=k, v=v, do=do, key_mask=key_mask, coords=coords, dist_scale=dist_scale)


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    # relative to each element, with a floor of RTOL·max|ref| for elements
    # that cancel to near zero
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def _torch_grads(fn, x: dict[str, np.ndarray], names: tuple[str, ...], *rest):
    leaves = {n: torch.from_numpy(x[n]).requires_grad_() for n in names}
    out = fn(*leaves.values(), *rest)
    out.backward(torch.from_numpy(x["do"]))
    return out, {n: leaf.grad for n, leaf in leaves.items()}


def test_flash_mha_backward_matches_pallas_vjp(interpret_pallas):
    from stamp_tpu.ops.flash_attention import flash_mha

    x = _inputs(0)
    mask = jnp.asarray(x["key_mask"])
    ref_out, vjp = jax.vjp(
        lambda q, k, v: flash_mha(q, k, v, mask, block_q=BLOCK, block_k=BLOCK),
        *(jnp.asarray(x[n]) for n in ("q", "k", "v")),
    )
    ref = dict(zip(("q", "k", "v"), vjp(jnp.asarray(x["do"]))))

    out, grads = _torch_grads(torch_attn.flash_mha, x, ("q", "k", "v"), torch.from_numpy(x["key_mask"]))
    _close(out, ref_out)
    for name in ("q", "k", "v"):
        _close(grads[name], ref[name])
    # a masked key gets exactly zero dk and dv
    masked = ~x["key_mask"]
    assert not grads["k"].numpy()[masked].any() and not grads["v"].numpy()[masked].any()


def test_flash_alibi_mha_backward_matches_pallas_vjp(interpret_pallas):
    from stamp_tpu.ops.flash_attention import flash_alibi_mha

    x = _inputs(1)
    coords, mask = jnp.asarray(x["coords"]), jnp.asarray(x["key_mask"])
    ref_out, vjp = jax.vjp(
        lambda q, k, v, ds: flash_alibi_mha(q, k, v, coords, coords, ds, mask, block_q=BLOCK, block_k=BLOCK),
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "dist_scale")),
    )
    ref = dict(zip(("q", "k", "v", "dist_scale"), vjp(jnp.asarray(x["do"]))))

    coords_t = torch.from_numpy(x["coords"])

    def port(q, k, v, ds):
        return torch_attn.flash_alibi_mha(q, k, v, coords_t, coords_t, ds, torch.from_numpy(x["key_mask"]))

    out, grads = _torch_grads(port, x, ("q", "k", "v", "dist_scale"))
    _close(out, ref_out)
    for name in ("q", "k", "v", "dist_scale"):
        _close(grads[name], ref[name])
    masked = ~x["key_mask"]
    assert not grads["k"].numpy()[masked].any() and not grads["v"].numpy()[masked].any()


def test_dist_weighted_sum_matches_pallas(interpret_pallas):
    """The bias branch's kernel alone: a = keys (300), b = queries (200,
    ragged, with a b-mask), against ``_dist_weighted_sum`` on padded inputs."""
    from stamp_tpu.ops.flash_attention import _dist_weighted_sum

    rng = np.random.default_rng(2)
    ca = (rng.integers(0, 40, size=(2, 300, 2)) * 256.0).astype(np.float32)
    cb = (rng.integers(0, 40, size=(2, 200, 2)) * 256.0 + 13.0).astype(np.float32)
    val = rng.normal(size=(2, 200, 64)).astype(np.float32)
    b_mask = rng.random((2, 200)) < 0.8

    def lanes(c, to):  # coordinates into 128 lanes, rows padded to the block
        return np.pad(c, ((0, 0), (0, to - c.shape[1]), (0, 126)))

    mask_f = np.broadcast_to(np.pad(b_mask, ((0, 0), (0, 56))).astype(np.float32)[:, None, :], (2, 8, 256))
    ref = _dist_weighted_sum(
        jnp.asarray(lanes(ca, 384)),
        jnp.asarray(lanes(cb, 256)),
        jnp.asarray(np.pad(val, ((0, 0), (0, 56), (0, 0)))),
        jnp.asarray(mask_f),
        block_a=BLOCK,
        block_b=BLOCK,
    )
    got = torch_attn._dist_weighted_sum(
        torch.from_numpy(ca), torch.from_numpy(cb), torch.from_numpy(val), torch.from_numpy(b_mask)
    )
    _close(got, np.asarray(ref)[:, :300])
    # no b-mask: every b counts
    all_b = torch_attn._dist_weighted_sum(torch.from_numpy(ca), torch.from_numpy(cb), torch.from_numpy(val), None)
    ones = torch.ones(2, 200, dtype=torch.bool)
    want = torch_attn._dist_weighted_sum(torch.from_numpy(ca), torch.from_numpy(cb), torch.from_numpy(val), ones)
    torch.testing.assert_close(all_b, want, rtol=0, atol=0)


def test_dist_weighted_sum_a_mask_matches_pallas(interpret_pallas):
    """The a-mask the ALiBi backward passes (its key mask): the rows it
    drops are zero, the others equal the Pallas kernel's, which computes
    every row (whole masked 64- and 128-row tiles, ragged A ≠ B)."""
    from stamp_tpu.ops.flash_attention import _dist_weighted_sum

    rng = np.random.default_rng(7)
    ca = (rng.integers(0, 40, size=(2, 300, 2)) * 256.0).astype(np.float32)
    cb = (rng.integers(0, 40, size=(2, 200, 2)) * 256.0 + 13.0).astype(np.float32)
    val = rng.normal(size=(2, 200, 64)).astype(np.float32)
    val[:, 64:192] = 0.0  # whole zero b tiles
    idx = np.arange(300)
    a_mask = ~(((idx >= 64) & (idx < 192)) | (idx >= 256))[None, :] & (rng.random((2, 300)) < 0.7)

    def lanes(c, to):  # coordinates into 128 lanes, rows padded to the block
        return np.pad(c, ((0, 0), (0, to - c.shape[1]), (0, 126)))

    ref = _dist_weighted_sum(
        jnp.asarray(lanes(ca, 384)),
        jnp.asarray(lanes(cb, 256)),
        jnp.asarray(np.pad(val, ((0, 0), (0, 56), (0, 0)))),
        jnp.ones((2, 8, 256), jnp.float32),
        block_a=BLOCK,
        block_b=BLOCK,
    )
    ref = np.where(a_mask[:, :, None], np.asarray(ref)[:, :300], 0.0)
    got = torch_attn._dist_weighted_sum(
        torch.from_numpy(ca), torch.from_numpy(cb), torch.from_numpy(val), None, torch.from_numpy(a_mask)
    )
    _close(got, ref)
    assert not got.numpy()[~a_mask].any()


@pytest.mark.parametrize("do_kind", ["dense", "last-layer"])
def test_flash_alibi_mha_backward_with_holes_matches_pallas_vjp(interpret_pallas, do_kind):
    """The ALiBi backward with the key mask as the distance-weighted sum's
    a-mask, against the Pallas VJP: a key mask with whole masked 64- and
    128-key tiles, and the last MIL layer's dO (zero but on row 0)."""
    from stamp_tpu.ops.flash_attention import flash_alibi_mha

    x = _inputs(8, t=700)
    idx = np.arange(700)
    holes = ((idx >= 64) & (idx < 192)) | ((idx >= 320) & (idx < 384)) | ((idx >= 512) & (idx < 640))
    x["key_mask"] = x["key_mask"] & ~holes
    if do_kind == "last-layer":
        x["do"][:, 1:] = 0.0
    coords, mask = jnp.asarray(x["coords"]), jnp.asarray(x["key_mask"])
    _, vjp = jax.vjp(
        lambda q, k, v, ds: flash_alibi_mha(q, k, v, coords, coords, ds, mask, block_q=BLOCK, block_k=BLOCK),
        *(jnp.asarray(x[n]) for n in ("q", "k", "v", "dist_scale")),
    )
    ref = dict(zip(("q", "k", "v", "dist_scale"), vjp(jnp.asarray(x["do"]))))

    coords_t = torch.from_numpy(x["coords"])

    def port(q, k, v, ds):
        return torch_attn.flash_alibi_mha(q, k, v, coords_t, coords_t, ds, torch.from_numpy(x["key_mask"]))

    _, grads = _torch_grads(port, x, ("q", "k", "v", "dist_scale"))
    for name in ("q", "k", "v", "dist_scale"):
        _close(grads[name], ref[name])
    assert not grads["k"].numpy()[:, holes].any() and not grads["v"].numpy()[:, holes].any()


@pytest.mark.parametrize("use_alibi", [False, True])
def test_backward_on_the_cpu_launches_no_kernel(use_alibi):
    x = _inputs(3, bh=2, t=17)
    names = ("q", "k", "v", "dist_scale") if use_alibi else ("q", "k", "v")
    coords = torch.from_numpy(x["coords"])
    mask = torch.from_numpy(x["key_mask"])

    def fn(*leaves):
        if use_alibi:
            q, k, v, ds = leaves
            return torch_attn.flash_alibi_mha(q, k, v, coords, coords, ds, mask)
        return torch_attn.flash_mha(*leaves, mask)

    counters = ("FLASH_MHA_BWD_LAUNCHES", "FLASH_ALIBI_MHA_BWD_LAUNCHES", "DIST_WEIGHTED_SUM_LAUNCHES")
    before = [getattr(torch_attn, c) for c in counters]
    _, grads = _torch_grads(fn, x, names)
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert [getattr(torch_attn, c) for c in counters] == before == [0, 0, 0]


def test_backward_wrappers_refuse_other_devices():
    meta = torch.empty(2, 5, 64, device="meta")
    mask = torch.ones(2, 5, dtype=torch.bool, device="meta")
    lse = torch.empty(2, 5, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        torch_attn._flash_backward(meta, meta, meta, mask, meta, lse, meta)
    coords = torch.empty(2, 5, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        torch_attn._dist_weighted_sum(coords, coords, meta, None)


# --- the facts the CUDA backward's tile skipping rests on --------------------
#
# The kernels skip a key tile with no valid key and a query tile whose dO
# rows are all zero, whose contributions are exactly zero.  These tests pin
# those facts on the port's plain backward and on the Pallas VJP, and show
# that the MIL model's two layers produce such dO rows.


def _backward(impl: str, q, k, v, key_mask, do) -> list[np.ndarray]:
    """(dq, dk, dv) of ``flash_mha`` for ``do``: the port's autograd Function
    on the CPU (its plain backward), or ``jax.vjp`` of the Pallas kernels."""
    if impl == "pallas":
        from stamp_tpu.ops.flash_attention import flash_mha

        mask = jnp.asarray(key_mask)
        _, vjp = jax.vjp(
            lambda q, k, v: flash_mha(q, k, v, mask, block_q=BLOCK, block_k=BLOCK), *map(jnp.asarray, (q, k, v))
        )
        return [np.asarray(g) for g in vjp(jnp.asarray(do))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    torch_attn.flash_mha(*leaves, torch.from_numpy(key_mask)).backward(torch.from_numpy(do))
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("impl", ["plain", "pallas"])
def test_zero_do_rows_contribute_exactly_nothing(impl, interpret_pallas):
    x = _inputs(4)
    zero = np.ones(300, dtype=bool)  # dO is zero on every row but these
    zero[[0, 1, 7, 150]] = False
    zero[200:230] = False
    do = np.where(zero[None, :, None], 0.0, x["do"]).astype(np.float32)
    dq, dk, dv = _backward(impl, x["q"], x["k"], x["v"], x["key_mask"], do)
    assert not dq[:, zero].any() and dq[:, ~zero].any()
    # the rows with a nonzero dO alone give the same dk and dv
    _, dk_live, dv_live = _backward(impl, x["q"][:, ~zero], x["k"], x["v"], x["key_mask"], do[:, ~zero])
    _close(torch.from_numpy(dk_live), dk)
    _close(torch.from_numpy(dv_live), dv)


@pytest.mark.parametrize("impl", ["plain", "pallas"])
def test_whole_masked_tiles_get_exactly_zero_dk_dv(impl, interpret_pallas):
    x = _inputs(5, t=700)
    idx = np.arange(700)  # whole masked 64- and 128-key tiles between valid ones
    holes = ((idx >= 64) & (idx < 192)) | ((idx >= 320) & (idx < 384)) | ((idx >= 512) & (idx < 640))
    key_mask = x["key_mask"] & ~holes
    _, dk, dv = _backward(impl, x["q"], x["k"], x["v"], key_mask, x["do"])
    assert not dk[:, holes].any() and not dv[:, holes].any()
    assert not dk[~key_mask].any() and not dv[~key_mask].any()
    assert dk[key_mask].any() and dv[key_mask].any()


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_mil_vit_flash_dO_is_zero_where_the_kernels_skip(monkeypatch, use_alibi):
    """A 2-layer MIL ViT through the flash autograd Functions: the last
    layer's dO is zero on every row but the CLS row (the head reads only
    it), the first layer's on the padded rows (masked keys of the last
    layer, which get exactly zero dK and dV there)."""
    from stamp_tpu_torch.models import vision_transformer as vit

    monkeypatch.setattr(vit, "FLASH_ATTENTION_MIN_SEQ", 8)
    name = "_flash_alibi_backward" if use_alibi else "_flash_backward"
    inner, recorded = getattr(torch_attn, name), []

    def recording(*args):
        recorded.append(args[-2].clone())  # (…, do, scale)
        return inner(*args)

    monkeypatch.setattr(torch_attn, name, recording)
    model = vit.VisionTransformer(dim_output=2, dim_input=16, dim_model=32, n_layers=2, n_heads=2,
                                  dim_feedforward=32, use_alibi=use_alibi)  # fmt: skip
    vit.init_random_weights_(model, torch.Generator().manual_seed(0))
    rng = np.random.default_rng(6)
    bags = torch.from_numpy(rng.normal(size=(2, 20, 16)).astype(np.float32))
    coords = torch.from_numpy((rng.integers(0, 10, size=(2, 20, 2)) * 256.0).astype(np.float32))
    key_mask = torch.arange(20)[None, :] < torch.tensor([[13], [17]])  # 7 and 3 padded tiles
    model(bags, coords=coords, key_mask=key_mask, train=True).logsumexp(dim=-1).sum().backward()

    assert len(recorded) == 2  # the last layer's backward runs first
    last, first = recorded
    assert last.shape == (2 * 2, 21, 32)  # heads of 16, padded to the 32 instance
    assert not last[:, 1:].any() and last[:, 0].abs().amax(dim=-1).gt(0).all()
    valid = torch.cat([torch.ones(2, 1, dtype=torch.bool), key_mask], dim=1).repeat_interleave(2, dim=0)
    assert not first[~valid].any() and first[valid].abs().amax(dim=-1).gt(0).all()
