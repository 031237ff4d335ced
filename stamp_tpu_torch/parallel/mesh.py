"""The training step over a mesh of ranks, and sequence-parallel evaluation.

Counterpart of ``stamp_tpu/parallel/mesh.py`` (``make_mesh``, ``replicate``,
``make_dp_train_step``, ``shard_batch``, ``make_sp_eval_forward``).  XLA
computes, from the JAX package's shardings, the gradient of the task's loss
over the **global** batch; the port's step computes the same explicitly,
for every task by one code path:

1. each rank runs the forward on its own contiguous rows of the global
   batch (its place on the data-parallel axes; every rank drew the same
   batch from the shared seed) and, with an ``sp`` axis, on its contiguous
   share of those rows' tiles (its place on ``sp``);
2. the outputs of every data-parallel rank are gathered: the local rows
   stay live for autograd, the others are detached, so every rank computes
   the same global loss (the Cox losses sum over the risk sets of the whole
   batch, which a mean of per-rank losses would get wrong).  The ranks of a
   sequence group all hold their rows' outputs; only the group's first rank
   keeps their gradient, so it is counted once;
3. after the backward, the gradients are all-reduced with SUM over every
   rank as one flat buffer.  Each rank's gradient is its part of the global
   loss's gradient: over a sequence group the parts of one set of rows
   (each rank's queries), over the data-parallel axes those of different
   rows (the global loss is the mean over rows, so this sum is the average
   over the data-parallel groups of each group's gradient).  The
   replicated optimizer then steps on every rank alike.

What a forward computes over the whole batch or the whole sequence goes
through the ``StepGroup`` (``ops.step_group``) the step hands to the model
(``step_group``): ``sum`` (the ALiBi Welford statistic's distance total and
pair count, summed before the division), ``max`` (TransMIL's pseudo-inverse
scale; its gradient goes back to the ranks that hold the maximum),
``draw`` (dropout masks: every rank draws the masks of the whole batch and
sequence from the same generator state and keeps its own rows and tiles, so
a mesh gives the one-rank result for one seed) and ``gather_seq`` (the
sequence group's all-gather, whose backward reduce-scatters).  Outside a step the model gets the group
of one, whose methods are identities.

``make_sp_eval_forward`` shards a [1, T, F] bag's tiles over every rank of
the mesh and returns the output, the same on every rank.
"""

from __future__ import annotations

import math
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import numpy as np
import torch

from stamp_tpu_torch.ops.step_group import SINGLE, StepGroup
from stamp_tpu_torch.parallel import distributed
from stamp_tpu_torch.parallel.distributed import Mesh, make_global_mesh, replicate_global, split_local_rows


def make_mesh(n_devices: int | None = None, axes: Sequence[str] = ("dp",), shape: Sequence[int] | None = None) -> Mesh:
    """A mesh over the ranks: one ``dp`` axis of ``n_devices`` (default:
    the world size), or ``axes`` with an explicit ``shape``."""
    if shape is None:
        if len(axes) != 1:
            raise ValueError("give an explicit shape for more than one axis")
        shape = (n_devices or distributed.process_count(),)
    return make_global_mesh(dict(zip(axes, shape, strict=True)))


def replicate(tree: Any, mesh: Mesh | None = None) -> Any:
    """Rank 0's parameters, buffers or tensors on every rank (in place)."""
    return replicate_global(tree)


def shard_batch(batch: Any, mesh: Mesh, *, sp_axis: str | None = None, tiles: bool = True) -> Any:
    """This rank's part of a global host batch (arrays or tensors, in
    tuples, lists and dicts): its rows on the data-parallel axes and, with
    ``sp_axis`` and ``tiles`` (a tile batch's bags, coordinates and key
    mask), its share of the tiles on that axis."""
    dp = mesh.ranks_along(mesh.data_axes(sp_axis))
    batch = split_local_rows(batch, index=dp.index(mesh.rank), count=len(dp))
    if sp_axis is None or not tiles:
        return batch
    sp = mesh.ranks_along((sp_axis,))
    return split_local_rows(batch, axis=1, index=sp.index(mesh.rank), count=len(sp))


class _MeshGroup(StepGroup):
    """A step's collectives over a mesh (see the module's docstring): this
    rank holds rows ``offset`` … ``offset + local`` of a batch of ``total``
    rows and, on a sequence group ``seq_ranks`` of ``seq_parts`` ranks,
    share ``seq_index`` of their tiles."""

    def __init__(self, *, offset: int, local: int, total: int, seq_ranks: tuple[int, ...], seq_index: int) -> None:
        self.offset, self.local, self.total = offset, local, total
        self.seq_ranks, self.seq_parts, self.seq_index = seq_ranks, len(seq_ranks), seq_index

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        return distributed.all_reduce_(t.detach().clone())

    def max(self, t: torch.Tensor) -> torch.Tensor:
        return _GlobalMax.apply(t)

    def draw(self, shape, draw, *, seq_dim=None, lead=0):
        if shape[0] != self.local:
            raise ValueError(
                f"StepGroup.draw in a step over a mesh needs the {self.local} local rows first, "
                f"got shape {tuple(shape)}"
            )
        whole = [self.total, *shape[1:]]
        sharded = seq_dim is not None and self.seq_parts > 1
        if sharded:
            share = shape[seq_dim] - lead
            whole[seq_dim] = lead + share * self.seq_parts
        out = draw(whole)[self.offset : self.offset + self.local]
        if sharded:
            start = lead + self.seq_index * share
            index = torch.cat([torch.arange(lead), torch.arange(start, start + share)]).to(out.device)
            out = out.index_select(seq_dim, index)
        return out

    def gather_seq(self, t: torch.Tensor, dim: int = 1) -> torch.Tensor:
        return t if self.seq_parts == 1 else distributed.gather_seq(t, dim, self.seq_ranks)


def step_group(mesh: Mesh | None, local_rows: int, *, sp_axis: str | None = None) -> StepGroup:
    """The ``StepGroup`` of a step on ``mesh`` whose rank holds
    ``local_rows`` rows (its share of their tiles on ``sp_axis``); the group
    of one without a mesh or on one rank."""
    if mesh is None or mesh.size == 1:
        return SINGLE
    dp = mesh.ranks_along(mesh.data_axes(sp_axis))
    seq = mesh.ranks_along((sp_axis,)) if sp_axis is not None else (mesh.rank,)
    return _MeshGroup(
        offset=dp.index(mesh.rank) * local_rows, local=local_rows, total=local_rows * len(dp),
        seq_ranks=seq, seq_index=seq.index(mesh.rank),
    )  # fmt: skip


class _GlobalMax(torch.autograd.Function):
    """Max over ranks; the gradient, summed over ranks, goes to the ranks
    whose value is the maximum (shared evenly, as a max's gradient is)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor) -> torch.Tensor:
        m = distributed.all_reduce_(t.detach().clone(), op=torch.distributed.ReduceOp.MAX)
        is_max = (t == m).to(t.dtype)
        ctx.save_for_backward(is_max, distributed.all_reduce_(is_max.clone()))
        return m

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        is_max, count = ctx.saved_tensors
        return distributed.all_reduce_(grad.clone()) * is_max / count


class _CountOnce(torch.autograd.Function):
    """The identity; the gradient passes on the sequence group's first rank
    and is zero on the others, whose copies of the same rows it would count
    again."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, first: bool) -> torch.Tensor:
        ctx.first = first
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (grad if ctx.first else torch.zeros_like(grad)), None


def _gather_rows(local: Any, mesh: Mesh, group: StepGroup, sp_axis: str | None) -> Any:
    """The global batch's outputs: every data-parallel rank's rows in rank
    order, this rank's live for autograd (counted on the first rank of its
    sequence group only), a tensor or a dict of them per target."""
    if isinstance(local, Mapping):
        return {k: _gather_rows(v, mesh, group, sp_axis) for k, v in local.items()}
    dp = mesh.ranks_along(mesh.data_axes(sp_axis))
    parts = distributed.all_gather_rows(local.detach(), dp)
    parts[dp.index(mesh.rank)] = local if group.seq_parts == 1 else _CountOnce.apply(local, group.seq_index == 0)
    return torch.cat(parts)


def _all_reduce_grads(params: Sequence[torch.nn.Parameter]) -> None:
    """SUM-all-reduce the gradients as one flat buffer."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = distributed.all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    offset = 0
    for g in grads:
        g.copy_(flat[offset : offset + g.numel()].view_as(g))
        offset += g.numel()


def make_dp_train_step(
    task_model,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh | None,
    *,
    forward: Callable[[tuple, torch.Tensor | None, StepGroup], Any],
    schedule: Callable[[int], float],
    sp_axis: str | None = None,
) -> Callable[[tuple, torch.Tensor | None, int], tuple[torch.Tensor, Any]]:
    """``step(batch, key_mask, count)`` → (loss, global outputs), both
    detached.  ``batch`` holds this rank's part of the inputs
    (``shard_batch``) and the global batch's targets last;
    ``forward(batch, key_mask, group)`` runs the backbone on it with the
    step's ``StepGroup``.  ``sp_axis`` names the mesh axis that shards the
    tiles (None: every axis is data-parallel).  ``count`` (updates done so
    far) sets the learning rate from ``schedule`` before the update.  With
    ``mesh`` None (or of one rank) the step is the single-device one: no
    collective."""
    if sp_axis is not None and (mesh is None or sp_axis not in mesh.axis_names):
        raise ValueError(f"sp_axis {sp_axis!r} is not an axis of the mesh {None if mesh is None else mesh.shape}")
    params = [p for p in task_model.module.parameters() if p.requires_grad]
    parallel = mesh is not None and mesh.size > 1

    def step(batch: tuple, key_mask: torch.Tensor | None, count: int) -> tuple[torch.Tensor, Any]:
        targets = batch[-1]
        group = step_group(mesh, batch[0].shape[0], sp_axis=sp_axis)
        outputs = forward(batch, key_mask, group)
        if parallel:
            outputs = _gather_rows(outputs, mesh, group, sp_axis)
        loss = task_model.loss(outputs, targets)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            _all_reduce_grads(params)
        for param_group in optimizer.param_groups:
            param_group["lr"] = schedule(count)  # optax: schedule(updates done so far)
        optimizer.step()
        detached = {k: v.detach() for k, v in outputs.items()} if isinstance(outputs, Mapping) else outputs.detach()
        return loss.detach(), detached

    return step


def pad_rows(tree: Any, n_rows: int, multiple: int) -> Any:
    """A host batch of ``n_rows`` rows (arrays in dicts, lists and tuples;
    None passes) padded to the next multiple of ``multiple`` by cycling
    its own rows, as the JAX package pads a ragged batch under a mesh
    (those rows count twice in its loss)."""
    index = [i % n_rows for i in range(math.ceil(n_rows / multiple) * multiple)]

    def one(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        return x[index]

    return one(tree)


def make_sp_eval_forward(task_model, mesh: Mesh, *, sp_axis: str = "sp"):
    """Sequence-sharded whole-bag forward: ``forward(bags, coords,
    key_mask=None)`` takes a [1, T, F] bag (and [1, T, 2] coordinates, a
    [1, T] key mask; numpy arrays or tensors, the whole bag on every rank),
    runs each rank's contiguous share of the T tiles (over every axis of the
    mesh, as the JAX package's ``P(None, axes)``) on the module's device,
    and returns the output, the same on every rank.  T must divide by the
    mesh's size.  For slides whose attention does not fit on one device.
    ``sp_axis`` is the JAX package's argument; the tiles span every axis."""
    module = task_model.module
    ranks = tuple(range(mesh.size))
    group = _MeshGroup(offset=0, local=1, total=1, seq_ranks=ranks, seq_index=mesh.rank)
    device = next(module.parameters()).device

    def local(x, start: int, stop: int) -> torch.Tensor | None:
        if x is None:
            return None
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        return x[:, start:stop].to(device)

    def forward(bags, coords, key_mask=None):
        t = bags.shape[1]
        if t % mesh.size:
            raise ValueError(f"bag size {t} not divisible by the mesh's {mesh.size} ranks; pad the bag")
        share = t // mesh.size
        start, stop = mesh.rank * share, (mesh.rank + 1) * share
        kwargs: dict = dict(train=False, group=group)
        if task_model.uses_coords:
            kwargs.update(coords=local(coords, start, stop), key_mask=local(key_mask, start, stop))
        with torch.inference_mode():
            return module(local(bags, start, stop), **kwargs)

    return forward
