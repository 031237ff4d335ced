"""Device selection for the port: an explicit ``torch.device``, never a
silent CPU fallback."""

from __future__ import annotations

import torch
import torch.distributed as dist


def resolve_device(requested: str | torch.device) -> torch.device:
    """Map a config ``device`` / ``accelerator`` value onto a ``torch.device``.

    ``"cpu"`` gives the CPU; ``"auto"``, ``"cuda"``, ``"gpu"`` and
    ``"cuda:N"`` give a CUDA card and raise when PyTorch sees none, so a GPU
    run never quietly becomes a CPU run.  Inside a fleet (a process group,
    ``parallel.distributed``) ``"auto"``, ``"cuda"`` and ``"gpu"`` give the
    rank's card, ``cuda:{rank % device_count}``; ``"cuda:N"`` is kept.  ``"tpu"`` raises by name (that is
    the JAX package's device).  A ``torch.device`` passes through unchanged.
    """
    if isinstance(requested, torch.device):
        return requested
    if requested == "cpu":
        return torch.device("cpu")
    if requested == "tpu":
        raise ValueError(
            "device 'tpu': the PyTorch port runs on a CUDA GPU or the CPU; "
            "run `python -m stamp_tpu` for the TPU"
        )
    if requested in ("auto", "cuda", "gpu") or requested.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {requested!r} asks for a CUDA GPU, but torch.cuda."
                "is_available() is False; set `device: cpu` (or `accelerator: "
                "cpu`) in the config to run on the CPU"
            )
        if requested.startswith("cuda:"):
            return torch.device(requested)
        rank = dist.get_rank() if dist.is_initialized() else 0
        return torch.device("cuda", rank % torch.cuda.device_count())
    raise ValueError(
        f"unknown device {requested!r}: expected 'auto', 'cpu', 'cuda', 'gpu' or 'cuda:N'"
    )
