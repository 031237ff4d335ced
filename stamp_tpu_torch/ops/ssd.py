"""The Mamba2 state-space duality (SSD) scan and mixer block (COBRA), in
plain PyTorch.

Counterpart of ``stamp_tpu/ops/ssd.py`` (plain JAX there too: no Pallas
kernel).  The recurrence

    h_t = exp(Δ_t·A) · h_{t-1} + Δ_t · B_t ⊗ x_t,    y_t = C_tᵀ h_t

is computed in chunks of 64 steps: inside a chunk as dense masked products,
across chunks through the chunk-boundary states.  ``ssd_reference`` is the
naive recurrence the tests hold it to.

Three choices differ in form, not in value, from the JAX package:

* The causal decay ``exp(a_cum[t] − a_cum[s])`` is masked in the exponent
  (−inf above the diagonal) before the ``exp``.  Above the diagonal the
  exponent is positive and, with COBRA's A down to −24 and a large Δ,
  overflows to inf; the JAX package's ``where`` after the ``exp`` drops it,
  a 0/1 mask would turn it into NaN.
* The three- and four-operand einsums are written as batched matmuls whose
  operands are at most [chunks, heads, 64, 64] or [chunks, heads, P, N]:
  none materialises [chunks, t, s, heads, P] (6.4 GB at 16,384 tiles).
* The inter-chunk scan (``jax.lax.associative_scan`` there) is its closed
  form, one [H, c, c] × [H, c, P·N] product with the decays
  ``exp(Σ_{j<k≤i} a_k)`` taken as masked cumulative sums (Mamba2's
  ``segsum``), not differences of a running sum.  A loop over chunks would
  be 256 dependent launches at 16,384 tiles; the product is 26 GFLOP there
  (COBRA: 24 heads, P = 64, N = 128), one launch.  Both add in another
  order than the JAX package's tree.

``causal_conv1d`` is the K = 4 depthwise convolution as K shifted
multiply-adds in f32, not a cuDNN call, so ``torch.backends.cudnn.
allow_tf32`` (on by default) cannot reach it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def ssd_reference(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """The sequential recurrence on x [L, H, P], dt [L, H], A [H], B and
    C [L, N] → y [L, H, P] (the test oracle)."""
    L, H, P = x.shape
    h = x.new_zeros(H, P, B.shape[-1])
    ys = []
    for t in range(L):
        decay = torch.exp(dt[t] * A)
        h = h * decay[:, None, None] + (dt[t][:, None, None] * x[t][:, :, None]) * B[t][None, None, :]
        ys.append(torch.einsum("hpn,n->hp", h, C[t]))
    return torch.stack(ys)


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """[..., c] → [..., c, c]: Σ_{j<k≤i} a_k for j ≤ i, −inf above the
    diagonal; each entry a cumulative sum of its own terms."""
    c = a.shape[-1]
    strict = torch.ones(c, c, dtype=torch.bool, device=a.device).tril(-1)
    sums = torch.cumsum(a[..., :, None].expand(*a.shape, c).masked_fill(~strict, 0.0), dim=-2)
    return sums.masked_fill(~strict.logical_or(torch.eye(c, dtype=torch.bool, device=a.device)), -math.inf)


def ssd_chunked(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor, C: torch.Tensor, *, chunk: int = 64
) -> torch.Tensor:
    """Chunked SSD on x [L, H, P], dt [L, H], A [H] (negative), B and C
    [L, N] → y [L, H, P]: O(L·chunk) work, L padded to a multiple of
    ``chunk`` with zeros."""
    L, H, P = x.shape
    N = B.shape[-1]
    pad = (-L) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt, B, C = (F.pad(t, (0, 0, 0, pad)) for t in (dt, B, C))
    nc = x.shape[0] // chunk
    xc = x.reshape(nc, chunk, H, P)
    dtc = dt.reshape(nc, chunk, H)
    Bc = B.reshape(nc, chunk, N)
    Cc = C.reshape(nc, chunk, N)

    a = dtc * A  # [c, t, H] log-decays, negative
    a_cum = torch.cumsum(a, dim=1)
    a_total = a_cum[:, -1]  # [c, H]

    # intra-chunk: y[t] = Σ_{s≤t} (C_t·B_s) · exp(a_cum[t] − a_cum[s]) · dt_s · x_s
    causal = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    seg = (a_cum[:, :, None, :] - a_cum[:, None, :, :]).permute(0, 3, 1, 2)  # [c, H, t, s]
    decay = torch.exp(seg.masked_fill(~causal, -math.inf))
    G = torch.matmul(Cc, Bc.transpose(1, 2))  # [c, t, s]
    W = G[:, None] * decay * dtc.permute(0, 2, 1)[:, :, None, :]  # [c, H, t, s]
    y_intra = torch.matmul(W, xc.permute(0, 2, 1, 3))  # [c, H, t, P]

    # each chunk's own end state: S_c = Σ_s exp(a_total − a_cum[s]) · dt_s · x_s ⊗ B_s
    to_end = torch.exp(a_total[:, None, :] - a_cum) * dtc  # [c, s, H]
    S = torch.matmul((xc * to_end[..., None]).permute(0, 2, 3, 1), Bc[:, None])  # [c, H, P, N]

    # the state entering chunk c: Σ_{j<c} exp(Σ_{j<k<c} a_total_k) · S_j
    carry = torch.exp(_segsum(a_total.T))  # [H, c, c]
    S_scan = torch.matmul(carry, S.permute(1, 0, 2, 3).reshape(H, nc, P * N)).reshape(H, nc, P, N)
    S_prev = torch.cat([S_scan.new_zeros(H, 1, P, N), S_scan[:, :-1]], dim=1).permute(1, 0, 2, 3)  # [c, H, P, N]

    # inter-chunk: y[t] = exp(a_cum[t]) · (C_t · S_prev)
    y_inter = torch.matmul(Cc[:, None], S_prev.transpose(-1, -2)) * torch.exp(a_cum).permute(0, 2, 1)[..., None]
    y = (y_intra + y_inter).permute(0, 2, 1, 3).reshape(nc * chunk, H, P)
    return y[:L]


def causal_conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    """Depthwise causal convolution: x [L, D], weight [K, D] → [L, D],
    out[t] = Σ_i x[t − K + 1 + i] · weight[i] (zeros before the start)."""
    k, L = weight.shape[0], x.shape[0]
    x_pad = F.pad(x, (0, 0, k - 1, 0))
    out = x_pad[:L] * weight[0]
    for i in range(1, k):
        out = torch.addcmul(out, x_pad[i : i + L], weight[i])
    return out if bias is None else out + bias


class Mamba2Block(nn.Module):
    """A Mamba2 mixer in mamba-ssm's ``Mamba2`` layout: in_proj → [z, x, B,
    C, dt], the causal depthwise conv and SiLU on (x, B, C), the SSD scan
    plus D·x, the gated RMSNorm (gate before the norm), out_proj.  Parameter
    names follow the JAX module's flax tree."""

    def __init__(
        self, d_model: int, d_state: int = 128, d_conv: int = 4, expand: int = 2, headdim: int = 64, chunk: int = 64
    ) -> None:
        super().__init__()
        self.d_inner = expand * d_model
        self.d_state, self.headdim, self.chunk = d_state, headdim, chunk
        self.nheads = self.d_inner // headdim
        conv_dim = self.d_inner + 2 * d_state
        self.in_proj = nn.Linear(d_model, 2 * self.d_inner + 2 * d_state + self.nheads, bias=False)
        self.conv1d_weight = nn.Parameter(torch.zeros(d_conv, conv_dim))
        self.conv1d_bias = nn.Parameter(torch.zeros(conv_dim))
        self.A_log = nn.Parameter(torch.log(torch.arange(1, self.nheads + 1, dtype=torch.float32)))
        self.D = nn.Parameter(torch.ones(self.nheads))
        self.dt_bias = nn.Parameter(torch.zeros(self.nheads))
        self.norm_weight = nn.Parameter(torch.ones(self.d_inner))
        self.out_proj = nn.Linear(self.d_inner, d_model, bias=False)

    def forward(self, u: torch.Tensor) -> torch.Tensor:  # [L, d_model]
        z, xbc, dt = torch.split(self.in_proj(u), [self.d_inner, self.d_inner + 2 * self.d_state, self.nheads], dim=-1)
        xbc = F.silu(causal_conv1d(xbc, self.conv1d_weight, self.conv1d_bias))
        x, B, C = torch.split(xbc, [self.d_inner, self.d_state, self.d_state], dim=-1)
        dt = F.softplus(dt + self.dt_bias)
        A = -torch.exp(self.A_log)
        x_heads = x.reshape(-1, self.nheads, self.headdim)
        y = ssd_chunked(x_heads, dt, A, B, C, chunk=self.chunk) + self.D[None, :, None] * x_heads
        y = y.reshape(-1, self.d_inner) * F.silu(z)
        y = y * torch.rsqrt(torch.mean(y * y, dim=-1, keepdim=True) + 1e-5) * self.norm_weight
        return self.out_proj(y)
