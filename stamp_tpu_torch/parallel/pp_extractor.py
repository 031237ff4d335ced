"""Pipeline-parallel (GPipe-schedule) forward for the extractor ViTs.

Counterpart of ``stamp_tpu/parallel/pp_extractor.py``.  The transformer's
depth is split into P stages over the ranks of a group, each rank holding
depth/P contiguous blocks (``stack_block_params``); the patch embedding and
the final norm and pooling stay on every rank (a negligible share of the
work).  Stage 0 runs ``ImageViT``'s ``part="embed"``, the last stage
``part="head"``, and microbatches of tokens travel from stage to stage by
point-to-point sends (``distributed.send_`` / ``recv_``; staged through
pinned host memory under gloo, as the other collectives).

The schedule is GPipe's: with M microbatches and P stages it has M + P − 1
ticks, and stage s works on microbatch t − s at tick t.  The JAX package's
stages run in SPMD lockstep, so there a tick lasts one stage's work whether
or not the stage holds a microbatch, and it computes its bubble ticks on
stale activations.  Here each rank is a process that runs eagerly: a stage
simply waits for its next microbatch, so it skips its bubble ticks, which
changes no output.  The last stage's outputs are broadcast to every rank.
A ragged batch is padded with zero images to a multiple of M and the
padding rows are dropped from the output.
"""

from __future__ import annotations

import torch

from stamp_tpu_torch.models.vit_image import ImageViT, ViTConfig
from stamp_tpu_torch.parallel import distributed


def stack_block_params(
    state_dict: dict[str, torch.Tensor], depth: int, n_stages: int = 1, stage: int = 0
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Split an ImageViT state dict into (this stage's blocks, the rest).

    The first holds blocks ``stage·depth/P`` … ``(stage + 1)·depth/P − 1``
    of ``depth``, renumbered from 0 (``blocks.<j>.…``) as an ImageViT of
    depth/P names them; the second every entry outside the blocks (patch
    embedding, tokens, final norm).  Raises when ``depth`` does not divide
    into ``n_stages``."""
    if depth % n_stages:
        raise ValueError(f"depth {depth} not divisible by {n_stages} stages")
    per_stage = depth // n_stages
    first = stage * per_stage
    blocks, rest = {}, {}
    for key, tensor in state_dict.items():
        if key.startswith("blocks."):
            _, i, leaf = key.split(".", 2)
            if first <= int(i) < first + per_stage:
                blocks[f"blocks.{int(i) - first}.{leaf}"] = tensor
        else:
            rest[key] = tensor
    return blocks, rest


def _stage_module(cfg: ViTConfig, per_stage: int, state_dict: dict[str, torch.Tensor]) -> ImageViT:
    """An ImageViT of ``per_stage`` blocks holding ``state_dict``'s tensors."""
    with torch.device("meta"):
        module = ImageViT(ViTConfig(**{**cfg.__dict__, "depth": per_stage}))
    module.load_state_dict(state_dict, assign=True)
    return module.eval()


def make_pp_forward(
    module: ImageViT,
    state_dict: dict[str, torch.Tensor],
    ranks: tuple[int, ...] | None,
    n_microbatches: int,
    *,
    device: torch.device | str | None = None,
):
    """Returns ``(forward, (blocks, rest))`` over the ranks of ``ranks``
    (None: the world), one stage a rank in their order: ``blocks`` and
    ``rest`` are this stage's ``stack_block_params`` share of
    ``state_dict`` on ``device`` (default: the rank's card).  Every rank of
    the group calls ``forward(images)`` with the same images and gets
    ``module``'s output for them (``module`` gives the configuration only
    and may lie on the meta device)."""
    cfg = module.cfg
    n_stages = distributed.group_size(ranks)
    stage = distributed.group_index(ranks)
    order = list(range(n_stages)) if ranks is None else list(ranks)
    device = distributed.rank_device() if device is None else torch.device(device)
    blocks, rest = stack_block_params(state_dict, cfg.depth, n_stages, stage)
    blocks = {k: v.to(device) for k, v in blocks.items()}
    rest = {k: v.to(device) for k, v in rest.items()}
    local = _stage_module(cfg, cfg.depth // n_stages, blocks | rest)
    first, last = stage == 0, stage == n_stages - 1
    out_dim = cfg.embed_dim * (2 if cfg.pool == "token_avg_concat" else 1)

    @torch.inference_mode()
    def forward(images: torch.Tensor) -> torch.Tensor:
        b, h, w = images.shape[:3]
        pad = -b % n_microbatches
        images = images.to(device)
        if pad:
            images = torch.cat([images, images.new_zeros((pad, *images.shape[1:]))])
        size = (b + pad) // n_microbatches
        tokens = cfg.num_prefix_tokens + (h // cfg.patch_size) * (w // cfg.patch_size)
        dtype = torch.promote_types(images.dtype, local.pos_embed.dtype)
        outs = []
        for mb in range(n_microbatches):  # tick mb + stage of the GPipe schedule
            if first:
                x = local(images[mb * size : (mb + 1) * size], part="embed")
            else:
                x = distributed.recv_(torch.empty((size, tokens, cfg.embed_dim), dtype=dtype, device=device),
                                      src=order[stage - 1])  # fmt: skip
            for block in local.blocks:
                x = block(x)
            if last:
                outs.append(x)
            else:
                distributed.send_(x, dst=order[stage + 1])
        out = local(torch.cat(outs), part="head")[:b] if last else torch.empty((b, out_dim), dtype=dtype, device=device)
        return distributed.broadcast_(out.contiguous(), src=order[-1], ranks=ranks)

    return forward, (blocks, rest)
