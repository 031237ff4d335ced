"""Multi-process training dry run: worker and local-fleet launcher.

Counterpart of ``stamp_tpu/parallel/_dist_dryrun.py:215``: N OS processes
of the port joined by ``torch.distributed`` (``_fleet_launch``; gloo on the
CPU or on a shared card, NCCL with a card per rank) run the data-parallel
layer as a real fleet would.  A worker runs one of:

``jobs <jobs.json>``
    the jobs the tests and ``chip_smoke.py`` hand over, each a directory
    with ``inputs.npz``: ``step`` (one ``make_dp_train_step`` step from the
    given weights on a global batch, fed as the training engine feeds it,
    on the job's ``mesh_shape`` and the spec's ``device``; rank 0 writes
    ``result.npz``: the loss, the state after the step and the all-reduced
    gradients), ``train``
    (``train_model_`` with the job's ``mesh_shape`` on fixed global
    batches, into ``rank{r}/``), ``sp_eval`` (``make_sp_eval_forward`` of
    the spec's model or of a ``ckpt`` on a whole bag, on the spec's
    ``device``; rank 0 writes ``result.npz`` with the output and its
    largest difference between ranks), ``collectives`` (the sequence
    collective with autograd, checked in each rank) and ``cli`` (one CLI
    command with the spec's ``flags``, such as ``--profile``; the kernel
    launch counts of ``ops.flash_attention`` are set to 0 before it and
    printed after it as ``LAUNCHES <rank> <json>``).
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
    """A task model from a job's spec: ``task`` (classification |
    survival), ``model_name`` (vit | trans_mil | mlp | barspoon),
    ``feature`` (tile, the default, or slide), ``dim_input``,
    ``total_steps`` and the backbone's parameters (``model``); barspoon
    takes ``targets`` ({target: categories}) and is multi-target."""
    from stamp_tpu_torch.modeling.registry import ModelName, load_model_class

    name = ModelName(spec.get("model_name", "vit"))
    lit_class, module_class = load_model_class(spec["task"], spec.get("feature", "tile"), name)
    common: dict[str, Any] = dict(
        model_class=module_class, dim_input=spec["dim_input"], total_steps=spec["total_steps"], model_name=name.value,
    )  # fmt: skip
    if name == ModelName.BARSPOON:
        targets = spec["targets"]
        common.update(
            ground_truth_label=list(targets), categories=targets,
            category_weights={t: np.full(len(c), 1 / len(c), np.float32) for t, c in targets.items()},
        )  # fmt: skip
    elif spec["task"] == "classification":
        common.update(
            ground_truth_label="gt", categories=["neg", "pos"],
            category_weights=np.asarray(spec.get("category_weights", [0.5, 0.5]), np.float32),
        )  # fmt: skip
    else:
        common.update(time_label="time", status_label="status")
    return lit_class(**common, **spec.get("model", {}))


def batch_of(arrays: dict[str, np.ndarray], prefix: str = "") -> tuple:
    """(bags, coords, sizes, targets) stored under ``prefix``; (feats,
    targets) for a feature batch (``feats``); multi-target targets stored
    as ``targets/<name>`` come back as a dict."""
    targets = arrays.get(f"{prefix}targets")
    if targets is None:
        start = f"{prefix}targets/"
        targets = {k.removeprefix(start): v for k, v in arrays.items() if k.startswith(start)}
    if f"{prefix}feats" in arrays:
        return arrays[f"{prefix}feats"], targets
    return (*(arrays[f"{prefix}{k}"] for k in ("bags", "coords", "sizes")), targets)


class FixedBatches:
    """A deterministic feed, the same on every rank."""

    def __init__(self, batches: list) -> None:
        self.batches = batches

    def __len__(self) -> int:
        return len(self.batches)

    def __iter__(self):
        yield from self.batches


def _tensors(tree, device=None):
    """numpy leaves → tensors (on ``device``, when given)."""
    import torch

    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tensors(v, device) for v in tree)
    if tree is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(tree))
    return t if device is None else t.to(device)


def _job_device(spec: dict):
    """The spec's ``device`` (the CPU by default); a card is the rank's own."""
    import torch

    from stamp_tpu_torch.parallel import distributed

    device = torch.device(spec.get("device", "cpu"))
    return torch.device("cuda", distributed.local_device_index()) if device.type == "cuda" else device


def _step_job(spec: dict, job_dir: Path) -> None:
    import torch

    from stamp_tpu_torch.modeling.train import _mesh_feed, forward_batch
    from stamp_tpu_torch.parallel import distributed
    from stamp_tpu_torch.parallel.mesh import make_dp_train_step, make_mesh, replicate

    arrays = dict(np.load(job_dir / "inputs.npz"))
    device = _job_device(spec)
    model = task_model(spec)
    state = {k.removeprefix("state/"): torch.from_numpy(v) for k, v in arrays.items() if k.startswith("state/")}
    model.module.load_state_dict(state)
    model.module.to(device)
    mesh = distributed.make_global_mesh(spec["mesh_shape"]) if spec.get("mesh_shape") else make_mesh()
    sp_axis = "sp" if "sp" in mesh.axis_names else None
    replicate(model.module, mesh)
    optimizer = model.make_optimizer(model.module.parameters())
    seed = spec.get("dropout_seed")
    generator = None if seed is None else torch.Generator().manual_seed(seed)
    step = make_dp_train_step(
        model, optimizer, mesh, schedule=model.lr_schedule(), sp_axis=sp_axis,
        forward=lambda batch, key_mask, group: forward_batch(
            model, batch, key_mask, device, train=True, generator=generator, group=group
        ),
    )  # fmt: skip
    batch, key_mask = next(_mesh_feed(iter([(batch_of(arrays), None)]), mesh))
    loss, _ = step(_tensors(batch, device), key_mask, 0)
    if distributed.process_index() == 0:
        out = {"loss": loss.cpu().numpy()}
        out |= {f"state/{k}": v.cpu().numpy() for k, v in model.module.state_dict().items()}
        out |= {f"grad/{n}": p.grad.cpu().numpy() for n, p in model.module.named_parameters() if p.grad is not None}
        np.savez(job_dir / "result.npz", **out)
    print(f"[{distributed.process_index()}] step job {job_dir.name}: loss {float(loss)}", flush=True)


def _sp_eval_job(spec: dict, job_dir: Path) -> None:
    import torch

    from stamp_tpu_torch.parallel import distributed
    from stamp_tpu_torch.parallel.mesh import make_sp_eval_forward

    arrays = dict(np.load(job_dir / "inputs.npz"))
    device = _job_device(spec)
    if "ckpt" in spec:  # a trained model.ckpt
        from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
        from stamp_tpu_torch.models import weights

        model, variables = load_model_from_ckpt(Path(spec["ckpt"]))
        weights.load_variables_(model.module, variables)
    else:  # the spec's model, with the weights stored as state/
        model = task_model(spec)
        model.module.load_state_dict({k.removeprefix("state/"): torch.from_numpy(v) for k, v in arrays.items()
                                      if k.startswith("state/")})  # fmt: skip
    model.module.to(device)
    mesh = distributed.make_global_mesh(spec.get("mesh_shape") or {"sp": distributed.process_count()})
    forward = make_sp_eval_forward(model, mesh)
    out = forward(arrays["bags"], arrays["coords"], arrays.get("key_mask"))
    if isinstance(out, dict):  # multi-target: the targets' logits side by side
        out = torch.cat(list(out.values()), dim=-1)
    parts = distributed.all_gather_rows(out.float().contiguous())
    spread = max(float((p - parts[0]).abs().max()) for p in parts)
    if distributed.process_index() == 0:
        np.savez(job_dir / "result.npz", out=out.float().cpu().numpy(), rank_spread=np.float64(spread))
    print(f"[{distributed.process_index()}] sp_eval job {job_dir.name}: ranks differ by {spread}", flush=True)


def _collectives_job(spec: dict, job_dir: Path) -> None:
    """The sequence collective with autograd over the world, checked in
    each rank against its definition: ``gather_seq`` (forward an
    all-gather along dim 1, backward a reduce-scatter of the parts of the
    gradient) on floats and bools."""
    import torch

    from stamp_tpu_torch.parallel import distributed

    r, n = distributed.process_index(), distributed.process_count()
    base = torch.arange(6.0).reshape(2, 3)
    x = (base + 10 * r).requires_grad_()
    y = distributed.gather_seq(x, 1)
    weight = torch.arange(6.0 * n).reshape(2, 3 * n)
    (y * weight).sum().backward()  # every rank's part: d/dy = weight, so d/dx_r sums n of them
    checks = {
        "gather": torch.equal(y.detach(), torch.cat([base + 10 * s for s in range(n)], dim=1)),
        "gather backward": torch.equal(x.grad, n * weight[:, 3 * r : 3 * r + 3]),
        "gather bool": torch.equal(
            distributed.gather_seq(torch.tensor([[r % 2 == 0, True]]), 1),
            torch.cat([torch.tensor([[s % 2 == 0, True]]) for s in range(n)], dim=1),
        ),
    }
    if not all(checks.values()):
        raise AssertionError(f"rank {r}: sequence collectives {checks}")
    print(f"[{r}] collectives ok", flush=True)


def _cli_job(spec: dict, job_dir: Path) -> None:
    from stamp_tpu_torch.__main__ import main as cli
    from stamp_tpu_torch.ops import flash_attention
    from stamp_tpu_torch.parallel import distributed

    counters = [name for name in vars(flash_attention) if name.endswith("LAUNCHES")]
    for name in counters:
        setattr(flash_attention, name, 0)
    cli(["-c", spec["config"], *spec.get("flags", []), spec["command"]])  # exits non-zero on failure
    launches = {name: getattr(flash_attention, name) for name in counters}
    print(f"LAUNCHES {distributed.process_index()} {json.dumps(dict(config=spec['config'], **launches))}", flush=True)


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
    jobs = json.loads(Path(argv[1]).read_text()) if mode == "jobs" else []
    on_card = any(job["kind"] == "cli" or job["spec"].get("device", "cpu") != "cpu" for job in jobs)
    distributed.init_distributed(use_cuda=None if mode == "cli" or on_card else False)
    if mode == "cli":
        from stamp_tpu_torch.__main__ import main as cli

        for config, command in zip(argv[1::2], argv[2::2], strict=True):
            cli(["-c", config, command])  # exits non-zero on failure
        print(f"{_OK_SENTINEL} pid={distributed.process_index()}", flush=True)
    elif mode == "jobs":
        kinds = {"step": _step_job, "train": _train_job, "sp_eval": _sp_eval_job, "cli": _cli_job,
                 "collectives": _collectives_job}  # fmt: skip
        for job in jobs:
            kinds[job["kind"]](job["spec"], Path(job.get("dir", ".")))
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
