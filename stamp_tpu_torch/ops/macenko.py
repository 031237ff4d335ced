"""Macenko stain normalization over a tile batch, in plain PyTorch.

Counterpart of ``stamp_tpu.ops.macenko`` (Macenko et al., ISBI 2009),
vectorized over the batch and run where the tiles lie (on the card during
extraction):

  1. optical density  OD = −ln((I+1)/240)
  2. tissue mask      every channel's OD > β
  3. top-2 eigenvectors of the masked OD covariance (batched 3×3 ``eigh``),
     each oriented so that its first coordinate is non-negative — the sign
     an ``eigh`` returns does not matter
  4. robust angular extremes (α and 100−α percentiles of the tissue pixels'
     angles, linear interpolation as ``jnp.nanpercentile``) → stain vectors
     H, E
  5. concentrations by least squares over all pixels (the pseudo-inverse,
     as ``jnp.linalg.lstsq``), 99th-percentile scaled to the reference maxima
  6. reconstruction ``Io·exp(−HE_ref·C)``

A tile with too little tissue (or a non-finite result) passes through
unchanged.
"""

from __future__ import annotations

import torch

# Canonical reference stain matrix and max concentrations (Macenko 2009 /
# staintools convention).
HE_REF = ((0.5626, 0.2159), (0.7201, 0.8012), (0.4062, 0.5581))
MAX_C_REF = (1.9705, 1.0308)

_IO = 240.0  # transmitted-light intensity
_BETA = 0.15  # OD threshold for tissue
_ALPHA = 1.0  # percentile for robust angles
_MIN_TISSUE = 100  # pixels; below this the tile passes through unchanged


def macenko_normalize(images: torch.Tensor, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 [B, H, W, 3] → Macenko-normalized uint8 [B, H, W, 3], computed
    in ``dtype`` (f32, as the JAX package; f64 to see what rounding moves)
    on ``images``' device."""
    b, h, w, _ = images.shape
    dev = images.device
    he_ref = torch.tensor(HE_REF, dtype=dtype, device=dev)
    max_c_ref = torch.tensor(MAX_C_REF, dtype=dtype, device=dev)
    pixels = images.reshape(b, -1, 3).to(dtype)

    od = -torch.log((pixels + 1.0) / _IO)  # [B, N, 3], natural-log OD
    tissue = (od > _BETA).all(dim=-1)  # [B, N]
    n_tissue = tissue.sum(dim=1)  # [B]
    mask = tissue[..., None]
    mean = torch.where(mask, od, 0.0).sum(dim=1) / n_tissue.clamp_min(1)[:, None]
    centered = torch.where(mask, od - mean[:, None], 0.0)
    cov = centered.transpose(1, 2) @ centered / (n_tissue - 1).clamp_min(1)[:, None, None]

    v = torch.linalg.eigh(cov).eigenvectors[:, :, 1:3]  # ascending: the top-2 plane [B, 3, 2]
    v = v * torch.where(v[:, :1] < 0, -1.0, 1.0)  # orient each eigenvector

    proj = od @ v  # [B, N, 2]
    phi = torch.where(tissue, torch.atan2(proj[..., 1], proj[..., 0]), torch.nan)
    extremes = torch.nanquantile(
        phi, torch.tensor([_ALPHA / 100, 1 - _ALPHA / 100], dtype=dtype, device=dev), dim=1, interpolation="linear"
    )  # [2, B]: min and max angle
    v1, v2 = (v @ torch.stack([torch.cos(a), torch.sin(a)], dim=-1)[..., None] for a in extremes)  # [B, 3, 1]
    # H first (larger first coordinate), E second — Macenko convention
    he = torch.where((v1[:, 0] > v2[:, 0])[:, None], torch.cat([v1, v2], -1), torch.cat([v2, v1], -1))

    enough = n_tissue >= _MIN_TISSUE
    usable = enough & he.isfinite().all(dim=2).all(dim=1)
    # a tile that passes through unchanged still takes the product below:
    # give it the reference matrix instead of its NaN stain vectors
    he = torch.where(usable[:, None, None], he, he_ref)
    conc = torch.linalg.pinv(he) @ od.transpose(1, 2)  # least squares he · C = ODᵀ, [B, 2, N]
    max_c = torch.quantile(conc, 0.99, dim=2, interpolation="linear")  # over ALL pixels
    conc = conc * (max_c_ref / max_c.clamp_min(1e-6))[..., None]

    normalized = (_IO * torch.exp(-(he_ref @ conc))).clamp(0.0, 255.0).transpose(1, 2)  # [B, N, 3]
    ok = usable & normalized.isfinite().all(dim=2).all(dim=1)
    out = torch.where(ok[:, None, None], normalized, pixels)
    return out.to(torch.uint8).reshape(b, h, w, 3)
