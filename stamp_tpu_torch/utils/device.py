"""Device selection for the port: an explicit ``torch.device``, never a
silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(requested: str | torch.device) -> torch.device:
    """Map a config ``device`` value onto a ``torch.device``.

    ``"cpu"`` gives the CPU; ``"auto"``, ``"cuda"`` and ``"cuda:N"`` give a
    CUDA card and raise when PyTorch sees none, so a GPU run never quietly
    becomes a CPU run.  A ``torch.device`` passes through unchanged.
    """
    if isinstance(requested, torch.device):
        return requested
    if requested == "cpu":
        return torch.device("cpu")
    if requested in ("auto", "cuda") or requested.startswith("cuda:"):
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {requested!r} asks for a CUDA GPU, but torch.cuda."
                "is_available() is False; set `device: cpu` in the config to "
                "run on the CPU"
            )
        return torch.device("cuda:0" if requested in ("auto", "cuda") else requested)
    raise ValueError(
        f"unknown device {requested!r}: expected 'auto', 'cpu', 'cuda' or 'cuda:N'"
    )
