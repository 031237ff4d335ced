"""Tensor parallelism for the extractor ViTs.

Counterpart of ``stamp_tpu/parallel/tp_extractor.py``.  The weights of an
``ImageViT`` are cut over the ranks of a group in the Megatron layout of the
JAX package's ``_spec_for``: attention qkv and the feed-forward fc1 are
column-sharded, proj and fc2 row-sharded, norms, embeddings and LayerScale
replicated.  The JAX package leaves the collectives to XLA SPMD; here each
rank is a process (``distributed.py``) and the forward writes them out:

* qkv is cut by whole heads of each of q, k and v (rank r takes heads
  [r·H/tp, (r+1)·H/tp) of each), so its local packed [B, N, 3·(H/tp)·d]
  goes to ``fused_qkv_mha`` unchanged with H/tp heads;
* SwiGLU's fc1 emits x1 ‖ x2; rank r takes the r-th slice of each half, so
  its local chunks still pair up;
* a row-sharded site (proj, fc2; ``_RowSharded``, the block's own
  forward calls it) gives partial sums of its K slice
  (``QuantDense.partial``: f32 in bf16 mode, exact i32 in int8), which are
  all-reduced before its epilogue runs once (``QuantDense.finish``): the
  bias is counted once and the sums are rounded once;
* SwiGLU's inner LayerNorm runs over fc2's K, which is sharded: its row
  statistics are two all-reduced passes (Σh → μ, then Σ(h − μ)² → 1/σ,
  ``ops.ln_dense.row_stats``), handed to the LayerNorm GEMM kernel, which
  then skips its own.  The inner norm's γ and β, which the JAX layout
  replicates, are cut like fc2's K: a rank reads its slice only.

``amax``, the row-sharded sites' ``w_scale`` and every bias of a
row-sharded site are replicated, as ``_spec_for`` gives 1-D leaves ``P()``.
Calibration ("observe") is not sharded: calibrate on one rank, quantize,
then shard.
"""

from __future__ import annotations

import torch
from torch import nn

from stamp_tpu_torch.models.vit_image import ImageViT, QuantDense, ViTConfig, _SwiGLU
from stamp_tpu_torch.ops.ln_dense import row_stats
from stamp_tpu_torch.parallel import distributed

_SHARDED_SITES = ("attn.qkv", "attn.proj", "mlp.fc1", "mlp.fc2", "mlp.norm")


def _split(key: str) -> tuple[str, str] | None:
    """(site, leaf) of a block entry ``blocks.<i>.<site>.<leaf>`` whose site
    is sharded, else None."""
    if not key.startswith("blocks."):
        return None
    site, _, leaf = key.split(".", 2)[2].rpartition(".")
    return (site, leaf) if site in _SHARDED_SITES else None


def _spec_for(key: str, tensor: torch.Tensor, cfg: ViTConfig) -> tuple[int, int] | None:
    """How ``key`` of an ImageViT state dict (``nn.Linear`` layout, [N, K])
    is cut: (dim, groups) — the tensor is cut along ``dim``, viewed as
    ``groups`` equal blocks each cut into tp slices (qkv: 3 groups, q k v;
    SwiGLU fc1: 2 groups, x1 x2) — or None when replicated."""
    split = _split(key)
    if split is None or tensor.ndim == 0:
        return None  # norms, embeddings, LayerScale, amax: replicated
    site, leaf = split
    if site in ("attn.qkv", "mlp.fc1"):  # column-sharded: output rows and their 1-D leaves
        return 0, 3 if site == "attn.qkv" else 2 if cfg.ffn == "swiglu" else 1
    if site == "mlp.norm":  # SwiGLU's inner LayerNorm: fc2's K
        return 0, 1
    if leaf in ("weight", "weight_q"):  # row-sharded: K
        return 1, 1
    return None  # the row-sharded sites' bias and w_scale


def _shard(tensor: torch.Tensor, dim: int, groups: int, index: int, count: int) -> torch.Tensor:
    """Slice ``index`` of ``count`` of each of ``groups`` equal blocks of
    ``tensor`` along ``dim``, concatenated (a contiguous copy)."""
    size = tensor.shape[dim]
    if size % (groups * count):
        raise ValueError(f"a dimension of {size} does not split into {groups} × {count} shards")
    blocks = tensor.unflatten(dim, (groups, count, size // (groups * count)))
    return blocks.select(dim + 1, index).flatten(dim, dim + 1).contiguous()


def shard_vit_params_tp(
    state_dict: dict[str, torch.Tensor], cfg: ViTConfig, index: int, count: int
) -> dict[str, torch.Tensor]:
    """Share ``index`` of ``count`` ranks of an ``ImageViT(cfg)`` state dict
    (the port's names; ``models.vit_image.state_dict_from_jax`` for a JAX
    variable tree) in the layout of the module docstring."""
    if cfg.num_heads % count:
        raise ValueError(f"{cfg.num_heads} heads do not split over {count} ranks")
    out = {}
    for key, tensor in state_dict.items():
        spec = _spec_for(key, tensor, cfg)
        out[key] = tensor if spec is None else _shard(tensor, *spec, index, count)
    return out


class _RowSharded(QuantDense):
    """A row-sharded site (proj, fc2) of one rank, K its slice: ``forward``
    all-reduces this rank's partial sums over ``ranks`` (f32 or i32) and
    applies the site's epilogue once; with ``norm`` (SwiGLU's inner
    LayerNorm, this rank's slice of γ and β) it first takes the row
    statistics over the whole K in two all-reduced passes."""

    def __init__(self, in_features: int, out_features: int, mode: str, ranks) -> None:
        super().__init__(in_features, out_features, mode=mode)
        self.ranks = ranks

    def forward(self, x: torch.Tensor, norm: nn.LayerNorm | None = None) -> torch.Tensor:
        stats = None
        if norm is not None:
            k = norm.normalized_shape[0] * distributed.group_size(self.ranks)
            stats = row_stats(x.reshape(-1, x.shape[-1]), norm.eps, k=k, reduce=self._all_reduce)
        acc = self._all_reduce(self.partial(x, norm, stats))
        return self.finish(acc, x.dtype, fused=norm is not None)

    def _all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.all_reduce_(t, ranks=self.ranks)


def _local_module(cfg: ViTConfig, count: int, ranks) -> ImageViT:
    """An ImageViT on the meta device whose block sites have one rank's
    shapes, proj and fc2 ``_RowSharded`` over ``ranks``, for
    ``load_state_dict(..., assign=True)`` of a share."""
    with torch.device("meta"):
        module = ImageViT(cfg)
        dim = cfg.embed_dim
        for block in module.blocks:
            attn, mlp = block.attn, block.mlp
            attn.num_heads = cfg.num_heads // count
            attn.qkv = QuantDense(dim, 3 * dim // count, bias=cfg.qkv_bias, mode=cfg.quant)
            attn.proj = _RowSharded(dim // count, dim, cfg.quant, ranks)
            hidden = int(dim * cfg.mlp_ratio)
            mlp.fc1 = QuantDense(dim, hidden // count, mode=cfg.quant)
            k = hidden // 2 if isinstance(mlp, _SwiGLU) else hidden
            mlp.fc2 = _RowSharded(k // count, dim, cfg.quant, ranks)
            if isinstance(mlp, _SwiGLU):
                mlp.norm = nn.LayerNorm(k // count, eps=mlp.norm.eps)
    return module


def make_tp_forward(
    module: ImageViT,
    state_dict: dict[str, torch.Tensor],
    ranks: tuple[int, ...] | None = None,
    *,
    device: torch.device | str | None = None,
):
    """Returns ``(forward, sharded)``: ``sharded`` is this rank's share of
    ``state_dict`` (``shard_vit_params_tp``) on ``device`` (default: the
    rank's card), and ``forward(images)`` runs ``module``'s configuration
    over the ranks of ``ranks`` (None: the world), each rank with its share;
    every rank returns the whole [B, D_out], as the JAX package's replicated
    output.  Every rank of the group calls ``forward`` with the same images.
    ``module`` gives the configuration only (it may lie on the meta device)."""
    cfg = module.cfg
    if cfg.quant == "observe":
        raise ValueError("tensor parallelism does not shard calibration: calibrate on one rank, then shard")
    count = distributed.group_size(ranks)
    index = distributed.group_index(ranks)
    device = distributed.rank_device() if device is None else torch.device(device)
    sharded = {k: v.to(device) for k, v in shard_vit_params_tp(state_dict, cfg, index, count).items()}
    local = _local_module(cfg, count, ranks)
    local.load_state_dict(sharded, assign=True)
    local.eval()

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> torch.Tensor:
        return local(images.to(device))

    return forward, sharded
