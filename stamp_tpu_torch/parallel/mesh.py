"""The data-parallel training step over a mesh of ranks.

Counterpart of ``stamp_tpu/parallel/mesh.py`` (``make_mesh``, ``replicate``,
``make_dp_train_step``, ``shard_batch``) for the ``dp`` axes.  XLA computes,
from the JAX package's shardings, the gradient of the task's loss over the
**global** batch; the port's step computes the same explicitly, for every
task by one code path:

1. each rank runs the forward on its own contiguous rows of the global
   batch (every rank drew the same batch from the shared seed);
2. the outputs of every rank are gathered: the local rows stay live for
   autograd, the others are detached, so every rank computes the same
   global loss (the Cox losses sum over the risk sets of the whole batch,
   which a mean of per-rank losses would get wrong);
3. after the backward, the gradients are all-reduced with SUM as one flat
   buffer — the sum over ranks of each rank's share is the global
   gradient — and the replicated optimizer steps on every rank alike.

What a forward computes over the whole batch is made global while the
step's forward runs (``global_rows``): ``global_sum`` (the ALiBi Welford
statistic's distance total and pair count, summed before the division),
``global_max`` (TransMIL's pseudo-inverse scale; its gradient goes back to
the rank that holds the maximum) and ``global_draw`` (dropout masks: every
rank draws the masks of the whole batch from the same generator state and
keeps its own rows, so dp = N gives the dp = 1 result for one seed).
Outside the step these are identities.

``make_sp_eval_forward`` (sequence-parallel evaluation) is not ported.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Callable, Iterator, Mapping, Sequence
from dataclasses import dataclass
from typing import Any

import torch

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


def shard_batch(batch: Any, mesh: Mesh | None = None) -> Any:
    """This rank's rows of a global host batch."""
    return split_local_rows(batch)


@dataclass(frozen=True)
class _Rows:
    offset: int  # this rank's first row of the global batch
    local: int
    total: int


_rows: _Rows | None = None


@contextlib.contextmanager
def global_rows(mesh: Mesh | None, local: int) -> Iterator[None]:
    """While a step's forward runs: this rank holds ``local`` contiguous
    rows of a global batch of ``local × mesh.size`` rows."""
    global _rows
    if mesh is None or mesh.size == 1:
        yield
        return
    saved = _rows
    _rows = _Rows(offset=distributed.process_index() * local, local=local, total=local * mesh.size)
    try:
        yield
    finally:
        _rows = saved


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks inside a step's forward (no
    gradient), else ``t``."""
    if _rows is None:
        return t
    return distributed.all_reduce_(t.detach().clone())


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


def global_max(t: torch.Tensor) -> torch.Tensor:
    """The max of a scalar ``t`` over the ranks inside a step's forward
    (differentiable), else ``t``."""
    return t if _rows is None else _GlobalMax.apply(t)


def global_draw(shape: Sequence[int], draw: Callable[[Sequence[int]], torch.Tensor]) -> torch.Tensor:
    """``draw(shape)`` for a tensor whose first axis is this rank's rows:
    inside a step's forward the draw covers the whole batch and this rank
    keeps its rows, so every rank consumes the generator alike.  Inside a
    step a tensor that is not batch-major raises: a local draw there would
    advance each rank's generator differently."""
    if _rows is None:
        return draw(shape)
    if shape[0] != _rows.local:
        raise ValueError(
            f"global_draw in a data-parallel step needs the {_rows.local} local rows first, got shape {tuple(shape)}"
        )
    return draw((_rows.total, *shape[1:]))[_rows.offset : _rows.offset + _rows.local]


def _gather_rows(local: Any) -> Any:
    """The global batch's outputs: every rank's rows in rank order, this
    rank's live for autograd (a tensor, or a dict of them per target)."""
    if isinstance(local, Mapping):
        return {k: _gather_rows(v) for k, v in local.items()}
    parts = distributed.all_gather_rows(local.detach())
    parts[distributed.process_index()] = local
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
    forward: Callable[[tuple, torch.Tensor | None], Any],
    schedule: Callable[[int], float],
) -> Callable[[tuple, torch.Tensor | None, int], tuple[torch.Tensor, Any]]:
    """``step(batch, key_mask, count)`` → (loss, global outputs), both
    detached.  ``batch`` holds this rank's rows of the inputs and the
    global batch's targets last; ``forward(batch, key_mask)`` runs the
    backbone on the rows.  ``count`` (updates done so far) sets the
    learning rate from ``schedule`` before the update.  With ``mesh`` None
    (or of one rank) the step is the single-device one: no collective."""
    params = [p for p in task_model.module.parameters() if p.requires_grad]
    parallel = mesh is not None and mesh.size > 1

    def step(batch: tuple, key_mask: torch.Tensor | None, count: int) -> tuple[torch.Tensor, Any]:
        targets = batch[-1]
        local_rows = batch[0].shape[0]
        with global_rows(mesh, local_rows):
            outputs = forward(batch, key_mask)
            if parallel:
                outputs = _gather_rows(outputs)
        loss = task_model.loss(outputs, targets)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            _all_reduce_grads(params)
        for group in optimizer.param_groups:
            group["lr"] = schedule(count)  # optax: schedule(updates done so far)
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
    """Sequence-sharded evaluation (the JAX package's ``sp`` axis)."""
    raise NotImplementedError(
        "sequence-parallel evaluation (the 'sp' mesh axis) is not ported yet; run `python -m stamp_tpu`"
    )
