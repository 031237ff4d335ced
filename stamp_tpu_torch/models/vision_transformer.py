"""Attention-MIL Vision Transformer (the default tile-level model).

Counterpart of ``stamp_tpu.models.vision_transformer``: linear projection +
GELU → prepended CLS token (coordinate (0, 0), always valid) → ``n_layers``
pre-LN blocks (self-attention and feed-forward residuals) → LayerNorm → CLS
head.  Attention is vanilla multi-head softmax attention or the reference's
spatial ALiBi, whose distance bias is subtracted *after* the softmax.

The module tree carries the JAX tree's names (``project``, ``class_token``,
``block_{i}.attn_norm``, ``block_{i}.mhsa.in_proj|out_proj`` or
``block_{i}.mhsa.q_proj|k_proj|v_proj|fc|bias_scale``,
``block_{i}.ff.norm|fc1|fc2``, ``norm``, ``head``); the ALiBi Welford
statistics (``running_mean``, ``items_so_far``) are buffers.
``variables_from_jax`` / ``variables_to_jax`` carry weights across exactly.

At ``FLASH_ATTENTION_MIN_SEQ`` tokens or more, attention goes through the
flash wrappers of ``ops.flash_attention`` (O(T·d) memory, differentiable;
on the CPU their plain versions); below it, through the einsum path of
``ops.attention``.  The JAX module takes the flash kernels only on a TPU;
the port takes them on any device, so the CPU runs the same branch as the
card.

The flash kernels take head widths up to 128 (``flash_attention.
flash_width``); a bag that reaches the flash path with a wider head raises
at the start of the forward, naming ``python -m stamp_tpu``.

``train=True`` is the JAX module's training forward
(``stamp_tpu/models/vision_transformer.py:43-46, 90-121, 166-207, 279-281,
355``): dropout after ``project`` and inside the feed-forward, drawn from
the ``generator`` the caller passes; vanilla attention takes the flash path
in training only when ``dropout`` is 0 (the kernels have no attention
dropout), ALiBi always does; each ALiBi block updates its Welford running
mean once per training forward, under ``no_grad``, from the mean pairwise
distance of the bag (streamed on the flash path, dense on the einsum path;
the CLS token at (0, 0) counts as a tile, as in the JAX module) and uses the
updated mean in the same forward.  In a data-parallel step
(``parallel.mesh``) the distance total and the pair count are summed over
the ranks before the division, so the statistic is the whole batch's, as
XLA computes it under the JAX package's mesh.  The JAX module's ``alibi_mask`` (which
its ``VisionTransformer`` never sets) is not ported.

What the JAX module sows into ``intermediates`` for heatmaps
(``stamp_tpu/models/vision_transformer.py:78-88, 250-259``) the port puts
into a dict the caller passes as ``intermediates``: per block
``intermediates["block_{i}"]`` holds ``attn_q`` and ``attn_k`` ([B, H, T,
d], always) and, with ``sow_weights=True``, ``attn_weights`` ([B, H, T,
T], the masked softmax; for ALiBi the softmax before the distance term).
The output takes the same path with or without them.  Without a dict the
forward is the plain one.
"""

from __future__ import annotations

from collections.abc import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from stamp_tpu_torch.models import weights
from stamp_tpu_torch.ops import flash_attention
from stamp_tpu_torch.ops.attention import (
    alibi_attention,
    attention_weights,
    dropout,
    multi_head_attention,
    pairwise_distance_sums,
    pairwise_distances,
)
from stamp_tpu_torch.parallel.mesh import global_sum

# At or above this many tokens (tiles + CLS), attention takes the flash
# kernels: a [T, T] weight matrix per head no longer fits comfortably.
FLASH_ATTENTION_MIN_SEQ = 4096

_EPS = 1e-6  # flax LayerNorm's default epsilon


def _use_flash(seq_len: int) -> bool:
    return seq_len >= FLASH_ATTENTION_MIN_SEQ


def _to_heads(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    b, s, dim = t.shape
    return t.reshape(b, s, num_heads, dim // num_heads).transpose(1, 2)


def _from_heads(t: torch.Tensor) -> torch.Tensor:
    b, h, s, d = t.shape
    return t.transpose(1, 2).reshape(b, s, h * d)


def _flat(t: torch.Tensor) -> torch.Tensor:
    """[B, H, S, ...] → contiguous [B·H, S, ...] (the kernels' layout)."""
    return t.reshape(t.shape[0] * t.shape[1], *t.shape[2:]).contiguous()


def _flat_mask(key_mask: torch.Tensor | None, b: int, h: int, s: int, device) -> torch.Tensor:
    if key_mask is None:
        key_mask = torch.ones((b, s), dtype=torch.bool, device=device)
    return _flat(key_mask[:, None, :].expand(b, h, s))


class MultiHeadSelfAttention(nn.Module):
    """Vanilla MHA, torch ``nn.MultiheadAttention`` semantics, fused qkv."""

    def __init__(self, dim: int, num_heads: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj = nn.Linear(dim, 3 * dim)
        self.out_proj = nn.Linear(dim, dim)

    def forward(
        self,
        x: torch.Tensor,
        *,
        key_mask: torch.Tensor | None,
        train: bool = False,
        generator: torch.Generator | None = None,
        store: dict | None = None,
        sow_weights: bool = False,
    ) -> torch.Tensor:
        q, k, v = (_to_heads(t, self.num_heads) for t in self.in_proj(x).chunk(3, dim=-1))
        b, h, s, d = q.shape
        if store is not None:
            store["attn_q"], store["attn_k"] = q, k
            if sow_weights:
                store["attn_weights"] = attention_weights(q, k, key_mask)
        # the flash kernels have no attention dropout: in training they are
        # taken only when dropout is off (the MIL default)
        if _use_flash(s) and not (train and self.dropout > 0.0):
            km = _flat_mask(key_mask, b, h, s, x.device)
            out = flash_attention.flash_mha(_flat(q), _flat(k), _flat(v), km).reshape(b, h, s, d)
        else:
            out = multi_head_attention(q, k, v, key_mask=key_mask, dropout_rate=self.dropout, generator=generator)
        return self.out_proj(_from_heads(out))


class MultiHeadALiBi(nn.Module):
    """Spatial ALiBi attention (reference vision_tranformer.py:34-154): a
    learned per-head ``bias_scale`` times the µm distance over the running
    mean of pairwise distances, subtracted after the softmax."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim)
        self.v_proj = nn.Linear(dim, dim)
        self.fc = nn.Linear(dim, dim)
        self.bias_scale = nn.Parameter(torch.rand(num_heads))
        self.register_buffer("running_mean", torch.ones(num_heads))
        self.register_buffer("items_so_far", torch.ones(num_heads))

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        *,
        coords: torch.Tensor,  # [B, T, 2] µm
        key_mask: torch.Tensor | None,
        train: bool = False,
        store: dict | None = None,
        sow_weights: bool = False,
    ) -> torch.Tensor:
        q, k, v = (_to_heads(proj(x), self.num_heads) for proj in (self.q_proj, self.k_proj, self.v_proj))
        b, h, s, d = q.shape
        if store is not None:
            store["attn_q"], store["attn_k"] = q, k
            if sow_weights:  # not a distribution with the distance term: the softmax part only
                store["attn_weights"] = attention_weights(q, k, key_mask)
        use_flash = _use_flash(s)
        if not use_flash:
            distances = pairwise_distances(coords, coords)  # [B, T, T]
        if train:
            # Welford update (reference vision_tranformer.py:23-31), reduced
            # to the scalar mean pairwise distance of this bag
            with torch.no_grad():
                if use_flash:
                    total, n_pairs = pairwise_distance_sums(coords, mask=key_mask)
                elif key_mask is not None:
                    pair_w = (key_mask[:, :, None] & key_mask[:, None, :]).to(distances.dtype)
                    total, n_pairs = torch.sum(distances * pair_w), torch.sum(pair_w)
                else:
                    total, n_pairs = torch.sum(distances), distances.new_tensor(float(distances.numel()))
                # a ratio of sums: in a data-parallel step, over the whole batch
                mean_d = global_sum(total) / torch.clamp_min(global_sum(n_pairs), 1.0)
                self.running_mean.copy_(self.running_mean + (mean_d - self.running_mean) / self.items_so_far)
                self.items_so_far.add_(1.0)
        if use_flash:
            km = _flat_mask(key_mask, b, h, s, x.device)
            dist_scale = (self.bias_scale / self.running_mean)[None, :].expand(b, h).reshape(b * h)
            cq = _flat(coords[:, None].expand(b, h, s, 2))
            out = flash_attention.flash_alibi_mha(
                _flat(q), _flat(k), _flat(v), cq, cq, dist_scale.contiguous(), km
            ).reshape(b, h, s, d)
        else:
            scaled = (
                distances[:, None, :, :]
                / self.running_mean[None, :, None, None]
                * self.bias_scale[None, :, None, None]
            )
            out = alibi_attention(q, k, v, scaled_distances=scaled, key_mask=key_mask)
        return self.fc(_from_heads(out))


class FeedForward(nn.Module):
    """LayerNorm → Linear → GELU → Dropout → Linear → Dropout."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0) -> None:
        super().__init__()
        self.dropout = dropout
        self.norm = nn.LayerNorm(dim, eps=_EPS)
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor, *, generator: torch.Generator | None = None) -> torch.Tensor:
        x = dropout(F.gelu(self.fc1(self.norm(x))), self.dropout, generator)
        return dropout(self.fc2(x), self.dropout, generator)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_dim: int, use_alibi: bool, dropout: float = 0.0) -> None:
        super().__init__()
        self.use_alibi = use_alibi
        self.attn_norm = nn.LayerNorm(dim, eps=_EPS)
        self.mhsa: MultiHeadALiBi | MultiHeadSelfAttention = (
            MultiHeadALiBi(dim, heads) if use_alibi else MultiHeadSelfAttention(dim, heads, dropout)
        )
        self.ff = FeedForward(dim, mlp_dim, dropout)

    def forward(
        self,
        x: torch.Tensor,
        *,
        coords: torch.Tensor,
        key_mask: torch.Tensor | None,
        train: bool = False,
        generator: torch.Generator | None = None,
        store: dict | None = None,
        sow_weights: bool = False,
    ) -> torch.Tensor:
        h = self.attn_norm(x)
        collect = dict(store=store, sow_weights=sow_weights)
        if self.use_alibi:
            attn_out = self.mhsa(h, coords=coords, key_mask=key_mask, train=train, **collect)
        else:
            attn_out = self.mhsa(h, key_mask=key_mask, train=train, generator=generator, **collect)
        x = attn_out + x
        return self.ff(x, generator=generator) + x


class VisionTransformer(nn.Module):
    """MIL aggregator over tile-feature bags (reference vision_tranformer.py:298-384)."""

    supports_coords = True

    def __init__(
        self,
        *,
        dim_output: int,
        dim_input: int,
        dim_model: int = 512,
        n_layers: int = 2,
        n_heads: int = 8,
        dim_feedforward: int = 512,
        dropout: float = 0.0,
        use_alibi: bool = False,
    ) -> None:
        super().__init__()
        self.n_layers = n_layers
        self.dropout = dropout
        self.head_dim = dim_model // n_heads
        self.project = nn.Linear(dim_input, dim_model)
        self.class_token = nn.Parameter(torch.randn(dim_model))
        for i in range(n_layers):
            self.add_module(
                f"block_{i}",
                TransformerBlock(dim_model, n_heads, dim_feedforward, use_alibi, dropout),
            )
        self.norm = nn.LayerNorm(dim_model, eps=_EPS)
        self.head = nn.Linear(dim_model, dim_output)

    def forward(
        self,
        bags: torch.Tensor,  # [B, T, F]
        *,
        coords: torch.Tensor,  # [B, T, 2] µm
        key_mask: torch.Tensor | None = None,  # [B, T] True = valid tile
        train: bool = False,
        sow_weights: bool = False,  # attention maps into ``intermediates``
        generator: torch.Generator | None = None,  # training: the dropout draws
        intermediates: dict | None = None,  # per block: q, k (and the maps)
    ) -> torch.Tensor:
        if sow_weights and intermediates is None:
            raise ValueError("sow_weights collects attention maps into `intermediates`; pass a dict")
        if train and self.dropout > 0.0 and generator is None:
            raise ValueError("training with dropout draws its masks from a generator; pass one")
        if _use_flash(bags.shape[1] + 1):  # a head the flash kernels cannot take raises before any work
            flash_attention.flash_width("VisionTransformer", self.head_dim)
        generator = generator if train else None  # no dropout outside training
        b = bags.shape[0]
        x = dropout(F.gelu(self.project(bags)), self.dropout, generator)
        x = torch.cat([self.class_token.expand(b, 1, -1), x], dim=1)
        coords = torch.cat([coords.new_zeros(b, 1, 2), coords], dim=1)
        if key_mask is not None:
            key_mask = torch.cat([key_mask.new_ones(b, 1), key_mask], dim=1)
        for i in range(self.n_layers):
            store = None if intermediates is None else intermediates.setdefault(f"block_{i}", {})
            x = getattr(self, f"block_{i}")(
                x, coords=coords, key_mask=key_mask, train=train, generator=generator, store=store,
                sow_weights=sow_weights,
            )  # fmt: skip
        return self.head(self.norm(x)[:, 0])

    @staticmethod
    def model_params_keys() -> list[str]:
        return ["dim_model", "n_layers", "n_heads", "dim_feedforward", "dropout", "use_alibi"]


# --- weights across the two packages ------------------------------------------

_BUFFERS = ("running_mean", "items_so_far")  # the flax "alibi_stats" collection


def variables_from_jax(variables: Mapping) -> dict[str, torch.Tensor]:
    """The JAX module's variables (``{"params": ..., "alibi_stats": ...}``,
    numpy leaves as ``load_checkpoint`` returns them) → a ``state_dict`` of
    :class:`VisionTransformer` (``models.weights``' rule)."""
    return weights.state_dict_from_tree(variables, ("params", "alibi_stats"))


def variables_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """The exact inverse of :func:`variables_from_jax`: a state dict → the
    JAX module's variable tree with numpy leaves, for ``save_checkpoint``."""
    return weights.tree_from_state_dict(
        state_dict, lambda leaf: "alibi_stats" if leaf in _BUFFERS else "params"
    )


def init_random_weights_(model: VisionTransformer, generator: torch.Generator) -> VisionTransformer:
    """Random weights for smoke runs, drawn on the CPU from ``generator``.

    The distributions follow the flax module's initializers (Dense kernels
    truncated normal with variance 1/fan_in, biases zero, LayerNorm scale
    one, class token N(0, 1), ``bias_scale`` U[0, 1), ALiBi statistics one),
    but not its values: the two frameworks' generators differ."""
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, nn.Linear):
                std = module.in_features**-0.5 / 0.87962566103423978  # flax lecun_normal
                nn.init.trunc_normal_(module.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, MultiHeadALiBi):
                module.bias_scale.uniform_(0.0, 1.0, generator=generator)
                module.running_mean.fill_(1.0)
                module.items_so_far.fill_(1.0)
        model.class_token.normal_(0.0, 1.0, generator=generator)
    return model
