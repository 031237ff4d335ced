"""Tile-extractor abstraction, in PyTorch.

Counterpart of ``stamp_tpu.preprocessing.extractor`` with the same contract:

* ``transform_host``: PIL tile → uint8 HWC array (resize only — cheap)
* ``forward``: uint8 batch [B, H, W, 3] → float32 features [B, D] on the
  model's device.  Normalization (x − 255·mean)/(255·std) runs on the
  device in f32 and the backbone in bfloat16, so the host→device transfer
  is 1 byte a pixel.  ``forward`` does not synchronize: the caller
  materializes the features when it writes them.

Weights are timm checkpoints found in the shared ``~/.cache/stamp`` /
HuggingFace caches (or ``STAMP_WEIGHTS_DIR``).  ``STAMP_RANDOM_WEIGHTS=1``
substitutes random weights for benchmarking, drawn from
``torch.Generator().manual_seed(0)``; they differ from the JAX package's
random weights (flax's initializers and generator give other numbers).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from PIL import Image

from stamp_tpu_torch.models.vit_image import (
    VIT_CONFIGS,
    ImageViT,
    ViTConfig,
    init_random_weights_,
    select_timm_state_dict,
)

_logger = logging.getLogger("stamp")

# process-wide int8 request from the config layer
# (preprocessing.extractor_precision); None defers to STAMP_INT8_EXTRACTION
_INT8_OVERRIDE: bool | None = None


def set_int8_extraction(enabled: bool | None) -> None:
    """Request int8 extraction on/off for subsequently built extractors
    (None = defer to the STAMP_INT8_EXTRACTION environment variable)."""
    global _INT8_OVERRIDE
    _INT8_OVERRIDE = enabled


def _int8_requested() -> bool:
    if _INT8_OVERRIDE is not None:
        return _INT8_OVERRIDE
    return os.environ.get("STAMP_INT8_EXTRACTION") == "1"


@dataclass(frozen=True)
class Extractor:
    """A tile feature extractor."""

    identifier: str
    input_px: int
    feat_dim: int
    transform_host: Callable[[Image.Image], np.ndarray]
    forward: Callable[[np.ndarray], torch.Tensor]  # uint8 [B,H,W,3] → f32 [B,D]
    precision: str = "bfloat16"
    """Numeric mode the forward actually runs in — the source of truth for
    output provenance and artifact dir naming."""


def batch_floor() -> int:
    """Pad floor for extractor forwards — tracks the producer batch size
    (STAMP_EXTRACT_BATCH, preprocessing/extract.py) so a slide's partial
    final batch runs at the steady-state shape."""
    return int(os.environ.get("STAMP_EXTRACT_BATCH", "64"))


def _resize_transform(size: int) -> Callable[[Image.Image], np.ndarray]:
    def transform(img: Image.Image) -> np.ndarray:
        if img.size != (size, size):
            img = img.resize((size, size), Image.Resampling.BILINEAR)
        return np.asarray(img.convert("RGB"), dtype=np.uint8)

    return transform


def _find_torch_weights(candidates: list[str]) -> str | None:
    """Look for a pre-seeded torch checkpoint in the local caches."""
    roots = [
        Path(os.environ.get("STAMP_WEIGHTS_DIR", "")),
        Path(os.environ.get("XDG_CACHE_HOME") or (Path.home() / ".cache")) / "stamp",
        Path(os.environ.get("HF_HOME") or (Path.home() / ".cache" / "huggingface")),
    ]
    for root in roots:
        if not root or not root.exists():
            continue
        for cand in candidates:
            for hit in root.rglob(cand):
                return str(hit)
    return None


def _load_torch_state_dict(path: str) -> dict[str, torch.Tensor]:
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(path)
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and isinstance(sd["model"], dict):
        sd = sd["model"]
    return sd


def make_vit_extractor(
    *,
    identifier: str,
    arch: str,
    weight_files: list[str] | None = None,
    input_px: int = 224,
    pool: str | None = None,
    device: torch.device,
) -> Extractor:
    """Build a bf16 ViT extractor from the shared architecture zoo on
    ``device``."""
    if _int8_requested():
        raise NotImplementedError(
            f"{identifier}: int8 (W8A8) extraction is not ported yet "
            "(ROADMAP.md Queue B, ln_quant_dense); run bfloat16 or use "
            "`python -m stamp_tpu preprocess`"
        )
    cfg: ViTConfig = VIT_CONFIGS[arch]
    if input_px != cfg.img_size:
        cfg = ViTConfig(**{**cfg.__dict__, "img_size": input_px})
    if pool is not None:
        cfg = ViTConfig(**{**cfg.__dict__, "pool": pool})

    with torch.device("meta"):  # no memory and no init until weights arrive
        model = ImageViT(cfg)
    if os.environ.get("STAMP_RANDOM_WEIGHTS") == "1":
        _logger.warning(
            f"{identifier}: using RANDOM weights (STAMP_RANDOM_WEIGHTS=1) — "
            "features are only useful for benchmarking"
        )
        model.to_empty(device="cpu")
        init_random_weights_(model, torch.Generator().manual_seed(0))
    else:
        path = _find_torch_weights(weight_files or [])
        if path is None:
            raise FileNotFoundError(
                f"no weights found for extractor '{identifier}' "
                f"(searched caches for {weight_files}). Pre-seed the weight "
                "file into ~/.cache/stamp or set STAMP_WEIGHTS_DIR; "
                "set STAMP_RANDOM_WEIGHTS=1 for benchmarking without weights."
            )
        _logger.info(f"{identifier}: loading torch weights from {path}")
        sd = select_timm_state_dict(_load_torch_state_dict(path), model)
        model.load_state_dict(sd, assign=True)
    # inference weights are bf16, like the activations
    model = model.to(device=device, dtype=torch.bfloat16).eval()

    mean = torch.tensor(cfg.mean, dtype=torch.float32, device=device) * 255.0
    std = torch.tensor(cfg.std, dtype=torch.float32, device=device) * 255.0
    feat_dim = {
        "token": cfg.embed_dim,
        "avg": cfg.embed_dim,
        "token_avg_concat": 2 * cfg.embed_dim,
    }[cfg.pool]

    def forward(batch: np.ndarray) -> torch.Tensor:
        """Non-blocking: returns the device tensor so consecutive batches
        queue on the stream; callers materialize at write time."""
        n = batch.shape[0]
        pad_to = max(batch_floor(), n)
        if n < pad_to:
            # pad to the steady-state batch: one shape for every forward
            batch = np.concatenate(
                [batch, np.zeros((pad_to - n, *batch.shape[1:]), batch.dtype)]
            )
        images = torch.from_numpy(batch).to(device)
        with torch.inference_mode():
            x = (images.float() - mean) / std
            return model(x.to(torch.bfloat16)).float()[:n]

    return Extractor(
        identifier=identifier,
        input_px=input_px,
        feat_dim=feat_dim,
        transform_host=_resize_transform(input_px),
        forward=forward,
    )
