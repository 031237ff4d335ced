"""Inputs of the flash backward's tile-skipping cases, shared by the card
tests (``tests/test_torch_cuda.py``) and ``chip_smoke.py`` phase 3c.

The backward skips key tiles with no valid key and query tiles whose dO
rows are all zero (their contribution is exactly zero).  Each case makes
such tiles: key masks with whole masked 64- and 128-key tiles between valid
ones (every kernel tile size: 32, 64, 128), a sequence with no valid key
beside normal ones (it keeps every tile: P = 1 there, as in the plain
version), the last MIL layer's dO (zero but on row 0) and the first layer's
(zero on the padded rows).
"""

from __future__ import annotations

import torch


def holes(t: int, device) -> torch.Tensor:
    """Keys in whole masked 64- and 128-key tiles: [64, 192), [320, 384),
    [512, 640)."""
    idx = torch.arange(t, device=device)
    return ((idx >= 64) & (idx < 192)) | ((idx >= 320) & (idx < 384)) | ((idx >= 512) & (idx < 640))


def skip_case_inputs(gen: torch.Generator, bh: int, tq: int, tk: int, d: int, mask_kind: str, do_kind: str):
    """q, k, v, the key mask, dO, query and key coordinates (µm) and the
    ALiBi distance scale of one case, on the generator's device.

    ``mask_kind``: "holes" (the holes above plus 30% of the other keys
    masked at random, key 0 valid), "suffix" (the last 40% masked, as bucket
    padding does) or "one-empty" (the suffix, and every key of sequence 1).
    ``do_kind``: "dense", "row0" (the last layer: only the CLS row is read)
    or "padded-rows-zero" (the first layer, tq == tk: nothing flows to the
    padded rows)."""
    dev = gen.device
    q = torch.randn(bh, tq, d, device=dev, generator=gen)
    k, v = (torch.randn(bh, tk, d, device=dev, generator=gen) for _ in range(2))
    idx = torch.arange(tk, device=dev)
    if mask_kind == "holes":
        scattered = torch.rand(bh, tk, device=dev, generator=gen) < 0.3
        key_mask = ~holes(tk, dev) & (~scattered | (idx == 0))
    else:
        key_mask = (idx < tk - (2 * tk) // 5).expand(bh, tk).clone()
        if mask_kind == "one-empty":
            key_mask[1] = False
    do = torch.randn(bh, tq, d, device=dev, generator=gen)
    if do_kind == "row0":
        do[:, 1:] = 0.0
    elif do_kind == "padded-rows-zero":
        do[~key_mask] = 0.0
    side = 40
    coords_q = (torch.randint(0, side, (bh, tq, 2), device=dev, generator=gen) * 256.0).float()
    coords_k = (torch.randint(0, side, (bh, tk, 2), device=dev, generator=gen) * 256.0).float()
    dist_scale = torch.rand(bh, device=dev, generator=gen) / (side * 256.0)
    return q, k, v, key_mask.contiguous(), do.contiguous(), coords_q, coords_k, dist_scale
