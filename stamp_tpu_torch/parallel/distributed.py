"""Process groups, meshes of ranks and work shares across a fleet.

Counterpart of ``stamp_tpu/parallel/distributed.py`` for PyTorch, which runs
one process per device: a **rank** is one process on one device, so
``STAMP_NUM_PROCESSES`` counts ranks (the JAX package counts hosts, each
holding all of its local devices).

* ``init_distributed`` joins the ``torch.distributed`` process group named
  by ``STAMP_COORDINATOR_ADDRESS`` / ``STAMP_NUM_PROCESSES`` /
  ``STAMP_PROCESS_ID`` (or the arguments).  The rendezvous is a TCP store at
  the coordinator address, hosted by rank 0.  Through it every rank first
  publishes its host name and card count, and the backend follows from that
  topology: ``nccl`` when every rank on a host has a card of its own,
  ``gloo`` on the CPU or when ranks share a card (NCCL refuses two ranks on
  one device).  Rank *r* takes ``cuda:{r % torch.cuda.device_count()}``.
* ``make_global_mesh`` names the ranks' axes, in the order ``dcn`` (across
  hosts), ``dp``, ``sp`` (innermost, so a sequence group's ranks are
  neighbours): ``dcn`` and ``dp`` are data-parallel, ``sp`` shards a bag's
  tiles.  With an ``sp`` axis it creates one process subgroup per sequence
  group and one per data-parallel group (``torch.distributed.new_group``:
  every rank creates every group, in the same order); a collective names
  its group by the tuple of its ranks (None: the world).
* ``shard_worklist``, ``assign_folds`` and ``fold_is_mine`` give each rank
  the JAX package's deterministic, disjoint share of slides or crossval
  folds for the same (rank, world size).
* ``replicate_global`` broadcasts rank 0's tensors; ``split_local_rows``
  takes this rank's contiguous rows of a batch every rank drew alike.
* ``all_reduce_``, ``all_gather_rows``, ``broadcast_`` and ``barrier`` are
  the collectives the training engine uses (identities without a process
  group; a group of one runs them).  ``gather_seq`` is the sequence
  axis's, with autograd: an all-gather along a dimension whose backward is
  a reduce-scatter (``reduce_scatter_seq``).  gloo's CUDA support
  covers only some collectives (PyTorch's backend table leaves
  ``all_gather`` out), so under gloo every collective on a CUDA tensor is
  staged through pinned host tensors; the step itself still runs on the
  card.  gloo has no reduce-scatter either: there it is an all-reduce of
  the whole tensor and a slice.  ``send_`` and ``recv_`` are the
  point-to-point pair the pipeline-parallel extractor passes its
  activations with (``pp_extractor.py``); tensor parallelism
  (``tp_extractor.py``) all-reduces f32 and i32 partial sums with
  ``all_reduce_``.  A collective that fails raises.
"""

from __future__ import annotations

import json
import logging
import math
import os
import socket
from collections.abc import Mapping, Sequence
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, TypeVar

import numpy as np
import torch
import torch.distributed as dist

_logger = logging.getLogger("stamp")

_T = TypeVar("_T")

_ENV = ("STAMP_COORDINATOR_ADDRESS", "STAMP_NUM_PROCESSES", "STAMP_PROCESS_ID")

_backend: str | None = None
_n_hosts = 1
_staging_logged = False
#: the mesh's process subgroups by their ranks (``make_global_mesh``)
_groups: dict[tuple[int, ...], Any] = {}

#: the mesh axes the JAX package knows, in the port's order (sp innermost)
MESH_AXES = ("dcn", "dp", "sp")


def _split_address(address: str) -> tuple[str, int]:
    host, _, port = address.removeprefix("tcp://").rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"coordinator address {address!r}: expected host:port")
    return host, int(port)


def choose_backend(topology: Sequence[tuple[str, int]]) -> tuple[str, str]:
    """(backend, reason) for the ranks' (host name, cards in use) pairs:
    ``nccl`` when every rank has cards and no host holds more ranks than
    cards, ``gloo`` otherwise."""
    if any(cards == 0 for _, cards in topology):
        return "gloo", "a rank runs on the CPU"
    ranks_on: dict[str, int] = {}
    cards_on: dict[str, int] = {}
    for host, cards in topology:
        ranks_on[host] = ranks_on.get(host, 0) + 1
        cards_on[host] = cards
    shared = {h: (ranks_on[h], cards_on[h]) for h in ranks_on if ranks_on[h] > cards_on[h]}
    if shared:
        host, (ranks, cards) = next(iter(shared.items()))
        return "gloo", f"{ranks} ranks share {cards} card(s) on {host}"
    return "nccl", "one card per rank"


def in_fleet() -> bool:
    """Whether the environment names a fleet (``STAMP_NUM_PROCESSES`` or
    ``STAMP_COORDINATOR_ADDRESS``)."""
    return any(os.environ.get(k) for k in _ENV[:2])


def init_distributed(
    *,
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    use_cuda: bool | None = None,
    timeout_s: float = 1800.0,
) -> None:
    """Join the ``torch.distributed`` process group (idempotent).

    Each field comes from its argument, else from ``STAMP_COORDINATOR_
    ADDRESS`` (``host:port``), ``STAMP_NUM_PROCESSES`` and
    ``STAMP_PROCESS_ID``; without an address and a count this is a no-op
    (a single process needs no group).  ``use_cuda`` (default: whether
    PyTorch sees a card) says whether this rank computes on a card, which
    the backend choice reads."""
    global _backend, _n_hosts
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("STAMP_COORDINATOR_ADDRESS")
    if num_processes is None and (env := os.environ.get("STAMP_NUM_PROCESSES")):
        num_processes = int(env)
    if process_id is None and (env := os.environ.get("STAMP_PROCESS_ID")):
        process_id = int(env)
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a fleet needs all of STAMP_COORDINATOR_ADDRESS, STAMP_NUM_PROCESSES and STAMP_PROCESS_ID; got "
            f"{coordinator_address!r}, {num_processes!r}, {process_id!r}"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"STAMP_PROCESS_ID {process_id} is not a rank of {num_processes}")
    if use_cuda is None:
        use_cuda = torch.cuda.is_available()
    host, port = _split_address(coordinator_address)
    timeout = timedelta(seconds=timeout_s)
    store = dist.TCPStore(host, port, num_processes, is_master=process_id == 0, timeout=timeout)
    cards = torch.cuda.device_count() if use_cuda else 0
    store.set(f"stamp/topology/{process_id}", json.dumps([socket.gethostname(), cards]))
    topology = [tuple(json.loads(store.get(f"stamp/topology/{r}"))) for r in range(num_processes)]
    backend, reason = choose_backend(topology)
    if backend == "nccl":
        torch.cuda.set_device(process_id % cards)
    dist.init_process_group(
        backend, store=dist.PrefixStore("stamp/pg", store), rank=process_id, world_size=num_processes, timeout=timeout
    )
    _backend = backend
    _n_hosts = len({h for h, _ in topology})
    _logger.info(
        f"distributed: rank {process_id}/{num_processes} on {_n_hosts} host(s), backend {backend} ({reason})"
    )


def shutdown_distributed() -> None:
    """Leave the process group, if any (a later ``init_distributed`` may
    join a new one)."""
    global _backend, _n_hosts
    if dist.is_initialized():
        dist.destroy_process_group()
    _backend, _n_hosts = None, 1
    _groups.clear()


def backend() -> str | None:
    return _backend


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_index() -> int:
    """This rank's card: ``rank % torch.cuda.device_count()``."""
    return process_index() % max(torch.cuda.device_count(), 1)


def rank_device() -> torch.device:
    """This rank's card (``local_device_index``)."""
    return torch.device("cuda", local_device_index())


def group_size(ranks: tuple[int, ...] | None = None) -> int:
    """The number of ranks in ``ranks`` (None: the world)."""
    return process_count() if ranks is None else len(ranks)


def group_index(ranks: tuple[int, ...] | None = None) -> int:
    """This rank's place among ``ranks`` (None: the world)."""
    return process_index() if ranks is None else ranks.index(process_index())


@dataclass(frozen=True)
class Mesh:
    """Named axes over the ranks, row-major: rank r sits at
    ``np.unravel_index(r, sizes)``.  ``sp`` shards the sequence; every
    other axis is data-parallel."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]
    rank: int

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def coords(self) -> dict[str, int]:
        return dict(zip(self.axis_names, (int(c) for c in np.unravel_index(self.rank, self.sizes))))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    def ranks_along(self, axes: Sequence[str], rank: int | None = None) -> tuple[int, ...]:
        """The ranks that share ``rank``'s (default: this rank's) coordinates
        on every axis not in ``axes``, in row-major order."""
        at = np.unravel_index(self.rank if rank is None else rank, self.sizes)
        grid = np.arange(self.size).reshape(self.sizes)
        index = tuple(slice(None) if a in axes else int(c) for a, c in zip(self.axis_names, at))
        return tuple(int(r) for r in grid[index].reshape(-1))

    def data_axes(self, sp_axis: str | None = "sp") -> tuple[str, ...]:
        """The data-parallel axes: all but ``sp_axis``."""
        return tuple(a for a in self.axis_names if a != sp_axis)


def check_mesh_axes(mesh_shape: Mapping[str, int]) -> None:
    """Raise ``ValueError`` for an axis name the JAX package does not know
    (``MESH_AXES``) or a size below 1."""
    unknown = [a for a in mesh_shape if a not in MESH_AXES]
    if unknown:
        raise ValueError(f"mesh_shape {dict(mesh_shape)}: unknown axis {unknown}; the axes are {list(MESH_AXES)}")
    if any(int(s) < 1 for s in mesh_shape.values()):
        raise ValueError(f"mesh_shape {dict(mesh_shape)}: every axis needs a size of at least 1")


def make_global_mesh(mesh_shape: Mapping[str, int] | None = None) -> Mesh:
    """A mesh over all ranks.  ``mesh_shape`` maps axis names to sizes, e.g.
    ``{"dcn": 2, "dp": 4}`` or ``{"dp": 2, "sp": 2}``; its product must
    equal the world size, and its axes are put in the order ``dcn``,
    ``dp``, ``sp``.  Without it: ``dcn`` = the host count (dropped at 1) and
    the rest on ``dp``.  A ``dcn`` axis must align with the hosts (one a
    multiple of the other), as in the JAX package.  With an ``sp`` axis
    this creates the mesh's process subgroups (a collective call: every
    rank calls it with the same shape)."""
    n = process_count()
    if mesh_shape is None:
        axes, shape = (("dcn", "dp"), (_n_hosts, n // _n_hosts)) if _n_hosts > 1 else (("dp",), (n,))
    else:
        check_mesh_axes(mesh_shape)
        axes = tuple(a for a in MESH_AXES if a in mesh_shape)
        shape = tuple(int(mesh_shape[a]) for a in axes)
    if math.prod(shape) != n:
        raise ValueError(f"mesh_shape {dict(zip(axes, shape))} needs {math.prod(shape)} devices but {n} are visible")
    if _n_hosts > 1:
        dcn = shape[0] if axes and axes[0] == "dcn" else 1
        if dcn % _n_hosts != 0 and _n_hosts % max(dcn, 1) != 0:
            raise ValueError(
                f"dcn axis ({dcn}) must align with the host count ({_n_hosts}) so every dcn group is whole hosts"
            )
    mesh = Mesh(axes, shape, process_index())
    if "sp" in axes and dist.is_initialized():
        _new_groups(mesh)
    return mesh


def _new_groups(mesh: Mesh) -> None:
    """One process group per sequence group and one per data-parallel
    group of ``mesh``, made by every rank in the same order (sorted by
    ranks); a group of one rank or of the world needs none."""
    for axes in (("sp",), mesh.data_axes()):
        for ranks in sorted({mesh.ranks_along(axes, r) for r in range(mesh.size)}):
            if 1 < len(ranks) < process_count() and ranks not in _groups:
                _groups[ranks] = dist.new_group(list(ranks))


def _process_group(ranks: tuple[int, ...] | None):
    """The process group of ``ranks`` (None for the world)."""
    if ranks is None or len(ranks) == process_count():
        return None
    try:
        return _groups[ranks]
    except KeyError:
        raise ValueError(f"no process group over ranks {ranks}: make_global_mesh creates a mesh's groups") from None


def shard_worklist(
    items: Sequence[_T], *, seed: int = 0x5742, index: int | None = None, count: int | None = None
) -> list[_T]:
    """This rank's deterministic, disjoint share of a worklist: sorted,
    permuted by ``np.random.default_rng(seed)``, then every ``count``-th
    item from ``index`` (default: ``process_count()`` and
    ``process_index()``) — the JAX package's shares for the same rank and
    world size."""
    try:
        canonical = sorted(items)  # type: ignore[type-var]
    except TypeError:
        canonical = sorted(items, key=repr)
    order = np.random.default_rng(seed).permutation(len(canonical))
    shuffled = [canonical[i] for i in order]
    return shuffled[process_index() if index is None else index :: process_count() if count is None else count]


def assign_folds(n_splits: int) -> list[int]:
    """The crossval folds this rank trains (round-robin over the fleet)."""
    return list(range(process_index(), n_splits, process_count()))


def fold_is_mine(fold_idx: int) -> bool:
    return fold_idx % process_count() == process_index()


def _tensors(tree: Any) -> list[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        return [*tree.parameters(), *tree.buffers()]
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    return []


def replicate_global(tree: Any) -> Any:
    """Every tensor of ``tree`` (a module's parameters and buffers, or
    tensors in dicts, lists and tuples) set to rank 0's values in place;
    returns ``tree``.  A no-op in a single process."""
    if process_count() > 1:
        with torch.no_grad():
            for t in _tensors(tree):
                broadcast_(t)
    return tree


def split_local_rows(batch: Any, *, axis: int = 0, index: int | None = None, count: int | None = None) -> Any:
    """Share ``index`` of ``count`` (default: this rank's of the world) of
    a batch along ``axis``, contiguous (numpy arrays or tensors, in dicts,
    lists and tuples; None passes)."""
    n = process_count() if count is None else count
    i = process_index() if index is None else index

    def one(x):
        if x is None:
            return None
        if isinstance(x, Mapping):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(one(v) for v in x)
        b = x.shape[axis]
        if b % n != 0:
            raise ValueError(f"batch axis {b} not divisible by {n} shares")
        step = b // n
        index = [slice(None)] * x.ndim
        index[axis] = slice(i * step, (i + 1) * step)
        return x[tuple(index)]

    return one(batch)


# --- collectives --------------------------------------------------------------


def _staged(tensor: torch.Tensor) -> bool:
    """Whether a collective on ``tensor`` goes through a pinned host copy
    (gloo with a CUDA tensor)."""
    global _staging_logged
    if _backend != "gloo" or not tensor.is_cuda:
        return False
    if not _staging_logged:
        _logger.info("gloo: collectives on CUDA tensors are staged through pinned host tensors")
        _staging_logged = True
    return True


def _host_copy(tensor: torch.Tensor) -> torch.Tensor:
    host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    host.copy_(tensor)
    return host


def all_reduce_(
    tensor: torch.Tensor, op: dist.ReduceOp.RedOpType = dist.ReduceOp.SUM, ranks: tuple[int, ...] | None = None
) -> torch.Tensor:
    """All-reduce ``tensor`` in place over ``ranks`` (None: the world);
    returns it."""
    if not dist.is_initialized() or (ranks is not None and len(ranks) == 1):
        return tensor
    group = _process_group(ranks)
    if _staged(tensor):
        host = _host_copy(tensor)
        dist.all_reduce(host, op=op, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def broadcast_(tensor: torch.Tensor, src: int = 0, ranks: tuple[int, ...] | None = None) -> torch.Tensor:
    """Rank ``src``'s values into ``tensor`` on every rank of ``ranks``
    (None: the world); returns it."""
    if not dist.is_initialized() or (ranks is not None and len(ranks) == 1):
        return tensor
    group = _process_group(ranks)
    if _staged(tensor):
        host = _host_copy(tensor)
        dist.broadcast(host, src=src, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src=src, group=group)
    return tensor


def send_(tensor: torch.Tensor, dst: int) -> None:
    """Send ``tensor`` to rank ``dst``, whose ``recv_`` takes it; returns
    once the transport holds it."""
    tensor = tensor.contiguous()
    dist.send(_host_copy(tensor) if _staged(tensor) else tensor, dst=dst)


def recv_(tensor: torch.Tensor, src: int) -> torch.Tensor:
    """Rank ``src``'s ``send_`` into ``tensor`` (contiguous, of the sent
    shape and dtype); returns it."""
    if _staged(tensor):
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        dist.recv(host, src=src)
        tensor.copy_(host)
    else:
        dist.recv(tensor, src=src)
    return tensor


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_rows(tensor: torch.Tensor, ranks: tuple[int, ...] | None = None) -> list[torch.Tensor]:
    """Every rank's ``tensor`` (equal shapes) of ``ranks`` (None: the
    world), in rank order."""
    if not dist.is_initialized() or (ranks is not None and len(ranks) == 1):
        return [tensor]
    group = _process_group(ranks)
    n = group_size(ranks)
    tensor = tensor.contiguous()
    if _staged(tensor):
        host = _host_copy(tensor)
        parts = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(parts, host, group=group)
        return [p.to(tensor.device) for p in parts]
    parts = [torch.empty_like(tensor) for _ in range(n)]
    dist.all_gather(parts, tensor, group=group)
    return parts


def all_gather_seq(tensor: torch.Tensor, dim: int, ranks: tuple[int, ...] | None = None) -> torch.Tensor:
    """Every rank's ``tensor`` of ``ranks`` concatenated along ``dim`` in
    rank order (equal shapes; a bool tensor travels as uint8)."""
    if not dist.is_initialized() or (ranks is not None and len(ranks) == 1):
        return tensor
    moved = tensor.movedim(dim, 0)
    if tensor.dtype == torch.bool:
        return torch.cat(all_gather_rows(moved.to(torch.uint8), ranks)).bool().movedim(0, dim)
    return torch.cat(all_gather_rows(moved, ranks)).movedim(0, dim)


def reduce_scatter_seq(tensor: torch.Tensor, dim: int, ranks: tuple[int, ...] | None = None) -> torch.Tensor:
    """This rank's share along ``dim`` (its place among ``ranks``) of the
    sum of every rank's ``tensor``; the length along ``dim`` divides by the
    number of ranks.  gloo has no reduce-scatter: there it is an all-reduce
    of the whole tensor, then the slice."""
    if not dist.is_initialized() or (ranks is not None and len(ranks) == 1):
        return tensor
    n, index = group_size(ranks), group_index(ranks)
    share = tensor.shape[dim] // n
    if _backend == "gloo":
        whole = all_reduce_(tensor.contiguous().clone(), ranks=ranks)
        return whole.narrow(dim, index * share, share).contiguous()
    moved = tensor.movedim(dim, 0).contiguous()
    out = moved.new_empty((share, *moved.shape[1:]))
    dist.reduce_scatter_tensor(out, moved, group=_process_group(ranks))
    return out.movedim(0, dim)


class _GatherSeq(torch.autograd.Function):
    """``all_gather_seq``; the backward reduce-scatters the gradient (each
    rank's is its part of the whole tensor's) back to the owners."""

    @staticmethod
    def forward(ctx, tensor, dim, ranks):
        ctx.dim, ctx.ranks = dim, ranks
        return all_gather_seq(tensor, dim, ranks)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter_seq(grad, ctx.dim, ctx.ranks), None, None


def gather_seq(tensor: torch.Tensor, dim: int, ranks: tuple[int, ...] | None = None) -> torch.Tensor:
    """``all_gather_seq`` with autograd (backward: a reduce-scatter)."""
    return _GatherSeq.apply(tensor, dim, ranks)


def barrier() -> None:
    if not dist.is_initialized():
        return
    if _backend == "nccl":
        dist.barrier(device_ids=[local_device_index()])
    else:
        dist.barrier()
