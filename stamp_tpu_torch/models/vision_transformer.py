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
updated mean in the same forward.  In a step over a mesh of ranks the
distance total and the pair count are summed over the ranks
(``StepGroup.sum``) before the division, so the statistic is the whole
batch's, as XLA computes it under the JAX package's mesh.  The JAX
module's ``alibi_mask`` (which its ``VisionTransformer`` never sets) is not
ported.

Sequence parallelism (a ``group`` with ``seq_parts`` > 1, handed in by the
training step or by ``parallel.mesh.make_sp_eval_forward``): each rank
holds a contiguous share of the bag's tiles, and every attention layer
gathers the keys and values of the whole sequence (``group.gather_seq``,
one collective for both, whose backward reduce-scatters dK and dV to their
owners); the coordinates and key mask of the whole sequence are gathered
once a forward.  Queries stay local, so both attention paths run with Tq ≠
Tk: Tq = T/sp + 1 queries against the T + 1 keys.  The flash path is chosen
from the whole sequence's length, as without sharding.

The CLS token lives on every rank: each rank prepends it to its share and
computes its query, so the head's input is the same on every rank after
the forward with no broadcast.  Its key and value are taken from the rank's
own copy and put in front of the gathered tiles, so every rank's keys are
the unsharded sequence in its order (the CLS key once).  It is counted once
where it is summed: the ALiBi statistic counts the CLS row on the
sequence's first rank only, and the step keeps the output's gradient on
that rank only (``parallel.mesh``), so the other ranks' copies of the CLS
stream receive no gradient from the loss; what they pass on (dK and dV of
the tiles their queries attend) is their share.  Dropout masks are the
rank's rows of the unsharded draw (``lead=1``: the CLS row, then the share),
so sp = N draws what sp = 1 draws.

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
from stamp_tpu_torch.ops.step_group import SINGLE, StepGroup

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


def _whole(t: torch.Tensor, group: StepGroup) -> torch.Tensor:
    """[B, 1 + share, ...] (the CLS token, then this rank's tiles) → [B,
    1 + T, ...]: the rank's own CLS entry, then every rank's tiles in order."""
    if group.seq_parts == 1:
        return t
    return torch.cat([t[:, :1], group.gather_seq(t[:, 1:], dim=1)], dim=1)


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
        group: StepGroup = SINGLE,
    ) -> torch.Tensor:
        """``key_mask`` is the keys' (the whole sequence's under ``group``)."""
        # the whole sequence's keys and values under ``group``, gathered in one collective
        q, kv = self.in_proj(x).split([x.shape[-1], 2 * x.shape[-1]], dim=-1)
        q, k, v = (_to_heads(t, self.num_heads) for t in (q, *_whole(kv, group).chunk(2, dim=-1)))
        b, h, s, d = q.shape
        tk = k.shape[2]
        if store is not None:
            store["attn_q"], store["attn_k"] = q, k
            if sow_weights:
                store["attn_weights"] = attention_weights(q, k, key_mask)
        # the flash kernels have no attention dropout: in training they are
        # taken only when dropout is off (the MIL default)
        if _use_flash(tk) and not (train and self.dropout > 0.0):
            km = _flat_mask(key_mask, b, h, tk, x.device)
            out = flash_attention.flash_mha(_flat(q), _flat(k), _flat(v), km).reshape(b, h, s, d)
        else:
            out = multi_head_attention(
                q, k, v, key_mask=key_mask, dropout_rate=self.dropout, generator=generator, group=group, lead=1
            )
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
        coords: torch.Tensor,  # [B, Q, 2] µm, the queries'
        key_mask: torch.Tensor | None,  # [B, K], the keys'
        train: bool = False,
        store: dict | None = None,
        sow_weights: bool = False,
        group: StepGroup = SINGLE,
        coords_k: torch.Tensor | None = None,  # [B, K, 2]: under ``group``, the whole sequence's
        query_mask: torch.Tensor | None = None,  # [B, Q]: the rows the statistic counts (default: key_mask)
    ) -> torch.Tensor:
        q = _to_heads(self.q_proj(x), self.num_heads)
        # the whole sequence's keys and values under ``group``, gathered in one collective
        kv = _whole(torch.cat([self.k_proj(x), self.v_proj(x)], dim=-1), group)
        k, v = (_to_heads(t, self.num_heads) for t in kv.chunk(2, dim=-1))
        coords_k = coords if coords_k is None else coords_k
        query_mask = key_mask if query_mask is None else query_mask
        b, h, s, d = q.shape
        tk = k.shape[2]
        if store is not None:
            store["attn_q"], store["attn_k"] = q, k
            if sow_weights:  # not a distribution with the distance term: the softmax part only
                store["attn_weights"] = attention_weights(q, k, key_mask)
        use_flash = _use_flash(tk)
        if not use_flash:
            distances = pairwise_distances(coords, coords_k)  # [B, Q, K]
        if train:
            # Welford update (reference vision_tranformer.py:23-31), reduced
            # to the scalar mean pairwise distance of this bag
            with torch.no_grad():  # the counted rows against the whole sequence's keys
                total, n_pairs = pairwise_distance_sums(coords, mask=query_mask, coords_k=coords_k, key_mask=key_mask)
                # a ratio of sums: in a step over a mesh, over the whole batch
                mean_d = group.sum(total) / torch.clamp_min(group.sum(n_pairs), 1.0)
                self.running_mean.copy_(self.running_mean + (mean_d - self.running_mean) / self.items_so_far)
                self.items_so_far.add_(1.0)
        if use_flash:
            km = _flat_mask(key_mask, b, h, tk, x.device)
            dist_scale = (self.bias_scale / self.running_mean)[None, :].expand(b, h).reshape(b * h)
            cq = _flat(coords[:, None].expand(b, h, s, 2))
            ck = cq if coords_k is coords else _flat(coords_k[:, None].expand(b, h, tk, 2))
            out = flash_attention.flash_alibi_mha(
                _flat(q), _flat(k), _flat(v), cq, ck, dist_scale.contiguous(), km
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

    def forward(
        self, x: torch.Tensor, *, generator: torch.Generator | None = None, group: StepGroup = SINGLE
    ) -> torch.Tensor:
        seq = dict(seq_dim=1, lead=1)  # x: the CLS token, then this rank's tiles
        x = dropout(F.gelu(self.fc1(self.norm(x))), self.dropout, generator, group, **seq)
        return dropout(self.fc2(x), self.dropout, generator, group, **seq)


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
        group: StepGroup = SINGLE,
        coords_k: torch.Tensor | None = None,
        query_mask: torch.Tensor | None = None,
    ) -> torch.Tensor:
        h = self.attn_norm(x)
        collect = dict(store=store, sow_weights=sow_weights, group=group)
        if self.use_alibi:
            attn_out = self.mhsa(
                h, coords=coords, key_mask=key_mask, train=train, coords_k=coords_k, query_mask=query_mask, **collect
            )
        else:
            attn_out = self.mhsa(h, key_mask=key_mask, train=train, generator=generator, **collect)
        x = attn_out + x
        return self.ff(x, generator=generator, group=group) + x


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
        group: StepGroup = SINGLE,  # a step's collectives; a share of the bag under sp
    ) -> torch.Tensor:
        if sow_weights and intermediates is None:
            raise ValueError("sow_weights collects attention maps into `intermediates`; pass a dict")
        if train and self.dropout > 0.0 and generator is None:
            raise ValueError("training with dropout draws its masks from a generator; pass one")
        if _use_flash(bags.shape[1] * group.seq_parts + 1):  # a head the kernels cannot take raises before any work
            flash_attention.flash_width("VisionTransformer", self.head_dim)
        generator = generator if train else None  # no dropout outside training
        b = bags.shape[0]
        x = dropout(F.gelu(self.project(bags)), self.dropout, generator, group, seq_dim=1)
        x = torch.cat([self.class_token.expand(b, 1, -1), x], dim=1)
        coords = torch.cat([coords.new_zeros(b, 1, 2), coords], dim=1)
        if key_mask is not None:
            key_mask = torch.cat([key_mask.new_ones(b, 1), key_mask], dim=1)
        # the keys' coordinates and mask: the whole sequence's under sp
        coords_k, key_mask_k, query_mask = coords, key_mask, None
        if group.seq_parts > 1:
            coords_k = _whole(coords, group)
            key_mask_k = None if key_mask is None else _whole(key_mask, group)
            query_mask = torch.ones_like(coords[..., 0], dtype=torch.bool) if key_mask is None else key_mask.clone()
            query_mask[:, 0] = group.seq_index == 0  # the CLS row counts once
        for i in range(self.n_layers):
            store = None if intermediates is None else intermediates.setdefault(f"block_{i}", {})
            x = getattr(self, f"block_{i}")(
                x, coords=coords, key_mask=key_mask_k, train=train, generator=generator, store=store,
                sow_weights=sow_weights, group=group, coords_k=coords_k, query_mask=query_mask,
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
