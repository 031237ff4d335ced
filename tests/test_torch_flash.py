"""The port's masked flash attention (``flash_mha``, ``flash_alibi_mha``)
against the JAX package's Pallas kernels, run in interpret mode, on the same
numpy inputs.

On the CPU the wrappers run their plain PyTorch versions; the CUDA kernel
itself is held against those plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.  Shapes are ragged against the
Pallas block of 128 (T = 300), with a random key mask and µm coordinates."""

import functools

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
    q, k, v = (rng.normal(size=(bh, t, d)).astype(np.float32) for _ in range(3))
    key_mask = rng.random((bh, t)) < 0.7
    key_mask[:, 0] = True  # every query has a valid key
    coords_q = (rng.integers(0, 40, size=(bh, t, 2)) * 256.0).astype(np.float32)
    coords_k = (rng.integers(0, 40, size=(bh, t, 2)) * 256.0).astype(np.float32)
    # about 1 / (mean distance · T): the bias and the softmax weigh alike
    dist_scale = (rng.random(bh) / (5000.0 * t)).astype(np.float32)
    return dict(q=q, k=k, v=v, key_mask=key_mask, coords_q=coords_q, coords_k=coords_k, dist_scale=dist_scale)


def _torch(x: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    return {name: torch.from_numpy(a) for name, a in x.items()}


def _pad(a: np.ndarray, to: int) -> np.ndarray:
    return np.pad(a, [(0, 0), (0, to - a.shape[1])] + [(0, 0)] * (a.ndim - 2))


def _close(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    # relative to each element, with a floor of RTOL·max|ref| for elements
    # that cancel to near zero
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=RTOL * np.abs(want).max())


def test_flash_mha_matches_pallas(interpret_pallas):
    from stamp_tpu.ops.flash_attention import flash_mha

    x = _inputs(0)
    ref = flash_mha(*(jnp.asarray(x[n]) for n in ("q", "k", "v", "key_mask")), block_q=BLOCK, block_k=BLOCK)
    t = _torch(x)
    _close(torch_attn.flash_mha(t["q"], t["k"], t["v"], t["key_mask"]), ref)


def test_flash_forward_lse_matches_pallas(interpret_pallas):
    from stamp_tpu.ops.flash_attention import _flash_forward

    x = _inputs(1)
    t_pad = 384  # 300 rounded up to the block
    mask_f = np.broadcast_to(_pad(x["key_mask"], t_pad).astype(np.float32)[:, None, :], (3, 8, t_pad))
    out, lse = _flash_forward(
        *(jnp.asarray(_pad(x[n], t_pad)) for n in ("q", "k", "v")),
        jnp.asarray(mask_f),
        scale=64**-0.5,
        block_q=BLOCK,
        block_k=BLOCK,
    )
    t = _torch(x)
    got_out, got_lse = torch_attn._flash_forward(t["q"], t["k"], t["v"], t["key_mask"])
    _close(got_out, np.asarray(out)[:, :300])
    _close(got_lse, np.asarray(lse)[:, 0, :300])


def test_flash_alibi_mha_matches_pallas(interpret_pallas):
    from stamp_tpu.ops.flash_attention import flash_alibi_mha

    x = _inputs(2)
    names = ("q", "k", "v", "coords_q", "coords_k", "dist_scale", "key_mask")
    ref = flash_alibi_mha(*(jnp.asarray(x[n]) for n in names), block_q=BLOCK, block_k=BLOCK)
    t = _torch(x)
    _close(torch_attn.flash_alibi_mha(*(t[n] for n in names)), ref)


def test_flash_alibi_forward_parts_match_pallas(interpret_pallas):
    """Softmax output, dacc = D·V and lse, each against the Pallas pass."""
    from stamp_tpu.ops.flash_attention import _flash_alibi_forward

    x = _inputs(3)
    t_pad = 384
    mask_f = np.broadcast_to(_pad(x["key_mask"], t_pad).astype(np.float32)[:, None, :], (3, 8, t_pad))
    cq, ck = (np.pad(_pad(x[n], t_pad), ((0, 0), (0, 0), (0, 126))) for n in ("coords_q", "coords_k"))
    out_sm, dacc, lse = _flash_alibi_forward(
        *(jnp.asarray(_pad(x[n], t_pad)) for n in ("q", "k", "v")),
        jnp.asarray(cq),
        jnp.asarray(ck),
        jnp.asarray(mask_f),
        scale=64**-0.5,
        block_q=BLOCK,
        block_k=BLOCK,
    )
    t = _torch(x)
    out, got_sm, got_dacc, got_lse = torch_attn._flash_alibi_forward(
        *(t[n] for n in ("q", "k", "v", "coords_q", "coords_k", "dist_scale", "key_mask"))
    )
    _close(got_sm, np.asarray(out_sm)[:, :300])
    _close(got_dacc, np.asarray(dacc)[:, :300])
    _close(got_lse, np.asarray(lse)[:, 0, :300])
    want = np.asarray(out_sm)[:, :300] - x["dist_scale"][:, None, None] * np.asarray(dacc)[:, :300]
    _close(out, want)


@pytest.mark.parametrize("d", [32, 64, 128])
def test_alibi_dacc_is_the_distance_weighted_sum(interpret_pallas, d):
    """The identity the card's ALiBi forward rests on: the Pallas pass's
    dacc = D·V under the key mask is the distance-weighted sum with the
    queries as rows a, the keys as b and the key mask as the b-mask (no
    a-mask), and out = O − dist_scale·dacc built from those parts is
    ``flash_alibi_mha``'s output.  The key mask drops whole 64-key tiles."""
    from stamp_tpu.ops.flash_attention import _flash_alibi_forward, flash_alibi_mha

    x = _inputs(6, d=d)
    tiles = (np.arange(300) // 64)[None, :]
    x["key_mask"] &= (tiles != 1) & (tiles != 3)  # keys 64–127 and 192–255 masked
    t_pad = 384
    mask_f = np.broadcast_to(_pad(x["key_mask"], t_pad).astype(np.float32)[:, None, :], (3, 8, t_pad))
    cq, ck = (np.pad(_pad(x[n], t_pad), ((0, 0), (0, 0), (0, 126))) for n in ("coords_q", "coords_k"))
    out_sm, dacc, _ = _flash_alibi_forward(
        *(jnp.asarray(_pad(x[n], t_pad)) for n in ("q", "k", "v")),
        jnp.asarray(cq),
        jnp.asarray(ck),
        jnp.asarray(mask_f),
        scale=d**-0.5,
        block_q=BLOCK,
        block_k=BLOCK,
    )
    t = _torch(x)
    got = torch_attn._dist_weighted_sum_reference(t["coords_q"], t["coords_k"], t["v"], t["key_mask"], None)
    _close(got, np.asarray(dacc)[:, :300])

    out = torch.from_numpy(np.array(out_sm)[:, :300]) - t["dist_scale"][:, None, None] * got
    names = ("q", "k", "v", "coords_q", "coords_k", "dist_scale", "key_mask")
    _close(out, torch_attn.flash_alibi_mha(*(t[n] for n in names)).numpy())
    _close(out, flash_alibi_mha(*(jnp.asarray(x[n]) for n in names), block_q=BLOCK, block_k=BLOCK))


@pytest.mark.parametrize("d", [32, 128])
def test_flash_head_widths_match_the_einsum_path(d):
    """Other head widths of the kernel's instances, against the MIL ViT's
    einsum path (stamp_tpu_torch.ops.attention) on the same inputs."""
    from stamp_tpu_torch.ops.attention import alibi_attention, multi_head_attention, pairwise_distances

    t = _torch(_inputs(4, bh=2, t=70, d=d))
    q, k, v = (t[n][:, None] for n in ("q", "k", "v"))  # [B, H=1, T, d]
    mask = t["key_mask"]
    _close(torch_attn.flash_mha(t["q"], t["k"], t["v"], mask), multi_head_attention(q, k, v, key_mask=mask)[:, 0])
    scaled = pairwise_distances(t["coords_q"], t["coords_k"])[:, None] * t["dist_scale"][:, None, None, None]
    want = alibi_attention(q, k, v, scaled_distances=scaled, key_mask=mask)[:, 0]
    names = ("q", "k", "v", "coords_q", "coords_k", "dist_scale", "key_mask")
    _close(torch_attn.flash_alibi_mha(*(t[n] for n in names)), want)


def test_cpu_flash_calls_do_not_count_as_launches():
    x = _torch(_inputs(5, bh=1, t=9))
    before = (torch_attn.FLASH_MHA_LAUNCHES, torch_attn.FLASH_ALIBI_MHA_LAUNCHES)
    torch_attn.flash_mha(x["q"], x["k"], x["v"], x["key_mask"])
    torch_attn.flash_alibi_mha(*(x[n] for n in ("q", "k", "v", "coords_q", "coords_k", "dist_scale", "key_mask")))
    assert (torch_attn.FLASH_MHA_LAUNCHES, torch_attn.FLASH_ALIBI_MHA_LAUNCHES) == before == (0, 0)


def test_flash_wrappers_refuse_other_devices():
    meta = {n: torch.empty(2, 5, 64, device="meta") for n in ("q", "k", "v")}
    mask = torch.ones(2, 5, dtype=torch.bool, device="meta")
    coords = torch.empty(2, 5, 2, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        torch_attn.flash_mha(meta["q"], meta["k"], meta["v"], mask)
    with pytest.raises(ValueError, match="unsupported device"):
        torch_attn.flash_alibi_mha(meta["q"], meta["k"], meta["v"], coords, coords, torch.empty(2, device="meta"), mask)
