"""Multi-process training dry run: worker and local-fleet launcher.

Counterpart of ``stamp_tpu/parallel/_dist_dryrun.py:215``: N OS processes
of the port joined by ``torch.distributed`` (``_fleet_launch``; gloo on the
CPU or on a shared card, NCCL with a card per rank) run the data-parallel
layer as a real fleet would.  A worker runs one of:

``jobs <jobs.json>``
    the jobs the tests hand over, each a directory with ``inputs.npz``:
    ``step`` (one ``make_dp_train_step`` step from the given weights on a
    global batch; rank 0 writes ``result.npz``) and ``train``
    (``train_model_`` with the job's ``mesh_shape`` on fixed global
    batches, into ``rank{r}/``).
``cli <config> <command> [<config> <command> …]``
    the ``stamp`` CLI's commands in order, in one process group.

Every worker prints ``DIST_DRYRUN_OK pid=<rank>`` at the end.  Run one by
hand with the fleet's environment set (``STAMP_COORDINATOR_ADDRESS``,
``STAMP_NUM_PROCESSES``, ``STAMP_PROCESS_ID``):

    python -m stamp_tpu_torch.parallel._dist_dryrun cli config.yaml train
"""

from __future__ import annotations

import json
import sys
from pathlib import Path
from typing import Any

import numpy as np

_OK_SENTINEL = "DIST_DRYRUN_OK"


def task_model(spec: dict[str, Any]):
    """A tile-level task model from a job's spec: ``task``
    (classification | survival), ``model_name`` (vit | trans_mil),
    ``dim_input``, ``total_steps`` and the backbone's parameters
    (``model``)."""
    from stamp_tpu_torch.modeling.registry import ModelName, load_model_class

    lit_class, module_class = load_model_class(spec["task"], "tile", ModelName(spec.get("model_name", "vit")))
    common: dict[str, Any] = dict(
        model_class=module_class, dim_input=spec["dim_input"], total_steps=spec["total_steps"],
        model_name=spec.get("model_name", "vit"),
    )  # fmt: skip
    if spec["task"] == "classification":
        common.update(
            ground_truth_label="gt", categories=["neg", "pos"],
            category_weights=np.asarray(spec.get("category_weights", [0.5, 0.5]), np.float32),
        )  # fmt: skip
    else:
        common.update(time_label="time", status_label="status")
    return lit_class(**common, **spec.get("model", {}))


def batch_of(arrays: dict[str, np.ndarray], prefix: str = "") -> tuple:
    """(bags, coords, sizes, targets) stored under ``prefix``."""
    return tuple(arrays[f"{prefix}{k}"] for k in ("bags", "coords", "sizes", "targets"))


class FixedBatches:
    """A deterministic feed, the same on every rank."""

    def __init__(self, batches: list) -> None:
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        yield from self.batches


def _step_job(spec: dict, job_dir: Path) -> None:
    import torch

    from stamp_tpu_torch.modeling.train import forward_batch
    from stamp_tpu_torch.parallel import distributed
    from stamp_tpu_torch.parallel.mesh import make_dp_train_step, make_mesh, replicate, shard_batch

    arrays = dict(np.load(job_dir / "inputs.npz"))
    model = task_model(spec)
    state = {k.removeprefix("state/"): torch.from_numpy(v) for k, v in arrays.items() if k.startswith("state/")}
    model.module.load_state_dict(state)
    mesh = make_mesh()
    replicate(model.module, mesh)
    optimizer = model.make_optimizer(model.module.parameters())
    bags, coords, sizes, targets = batch_of(arrays)
    local = shard_batch((bags, coords, sizes), mesh)
    step = make_dp_train_step(
        model, optimizer, mesh, schedule=model.lr_schedule(),
        forward=lambda batch, key_mask: forward_batch(model, batch, key_mask, torch.device("cpu"), train=True),
    )  # fmt: skip
    loss, _ = step((*local, torch.from_numpy(targets)), None, 0)
    if distributed.process_index() == 0:
        out = {"loss": loss.numpy()} | {f"state/{k}": v.numpy() for k, v in model.module.state_dict().items()}
        np.savez(job_dir / "result.npz", **out)
    print(f"[{distributed.process_index()}] step job {job_dir.name}: loss {float(loss)}", flush=True)


def _check_replicated(module) -> None:
    """Every rank's parameters and buffers equal rank 0's, bitwise."""
    import torch

    from stamp_tpu_torch.parallel import distributed

    for name, t in module.state_dict().items():
        mine = t.detach().clone()
        if not torch.equal(distributed.broadcast_(t.detach().clone()), mine):
            raise AssertionError(f"rank {distributed.process_index()}: {name} differs from rank 0's")


def _train_job(spec: dict, job_dir: Path) -> None:
    import torch

    from stamp_tpu_torch.modeling.train import train_model_
    from stamp_tpu_torch.parallel import distributed
    from stamp_tpu_torch.utils.seed import Seed

    arrays = dict(np.load(job_dir / "inputs.npz"))
    Seed.set(spec.get("seed", 0))
    model = task_model(spec)
    rank = distributed.process_index()
    out = job_dir / f"rank{rank}"
    train_model_(
        output_dir=out, model=model,
        train_dl=FixedBatches([batch_of(arrays, f"train{i}/") for i in range(spec["n_train"])]),
        valid_dl=FixedBatches([batch_of(arrays, f"valid{i}/") for i in range(spec["n_valid"])]),
        max_epochs=spec["max_epochs"], patience=spec["patience"], device=torch.device("cpu"),
        mesh_shape=spec["mesh_shape"],
    )  # fmt: skip
    written = sorted(p.name for p in out.iterdir()) if out.exists() else []
    if rank == 0 and "model.ckpt" not in written:
        raise AssertionError(f"rank 0 wrote no model.ckpt: {written}")
    if rank != 0 and written:
        raise AssertionError(f"rank {rank} wrote {written}")
    _check_replicated(model.module)
    print(f"[{rank}] train job {job_dir.name}: replicated parameters, rank 0 alone wrote", flush=True)


def main(argv: list[str]) -> None:
    from stamp_tpu_torch.__main__ import _configure_logging
    from stamp_tpu_torch.parallel import distributed

    _configure_logging()  # the "stamp" log (the backend chosen among it) on stderr
    mode = argv[0]
    distributed.init_distributed(use_cuda=None if mode == "cli" else False)
    if mode == "cli":
        from stamp_tpu_torch.__main__ import main as cli

        for config, command in zip(argv[1::2], argv[2::2], strict=True):
            cli(["-c", config, command])  # exits non-zero on failure
        print(f"{_OK_SENTINEL} pid={distributed.process_index()}", flush=True)
    elif mode == "jobs":
        for job in json.loads(Path(argv[1]).read_text()):
            {"step": _step_job, "train": _train_job}[job["kind"]](job["spec"], Path(job["dir"]))
        print(f"{_OK_SENTINEL} pid={distributed.process_index()}", flush=True)
    else:
        raise SystemExit(f"unknown mode {mode!r}: jobs <jobs.json> | cli <config> <command> ...")
    distributed.barrier()
    distributed.shutdown_distributed()


def launch_local_fleet(args: list[str], *, n_processes: int = 2, timeout: float = 600.0, **kwargs: Any) -> str:
    """Run this worker with ``args`` as an ``n_processes`` fleet; returns
    the combined output.  Raises on a failed rank or a missing sentinel."""
    from stamp_tpu_torch.parallel._fleet_launch import launch_fleet

    return launch_fleet(
        ["-m", "stamp_tpu_torch.parallel._dist_dryrun", *args],
        n_processes=n_processes, timeout=timeout, ok_sentinel=_OK_SENTINEL, **kwargs,
    )  # fmt: skip


if __name__ == "__main__":
    main(sys.argv[1:])
