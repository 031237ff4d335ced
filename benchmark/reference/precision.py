"""Plain float32 on the card: TF32 off for matmuls and convolutions."""

from __future__ import annotations

import contextlib
from collections.abc import Iterator

import torch


@contextlib.contextmanager
def float32_exact() -> Iterator[None]:
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
