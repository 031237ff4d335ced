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
    calibrate_act_stats,
    init_random_weights_,
    quantize_vit_params,
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
    """Numeric mode the forward actually runs in ("bfloat16" | "int8") —
    the source of truth for output provenance and artifact dir naming."""


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
    """Build a ViT extractor from the shared architecture zoo on ``device``:
    bf16, or W8A8 when int8 extraction is requested (``set_int8_extraction``
    or STAMP_INT8_EXTRACTION=1).  The int8 path mirrors the JAX package's:
    the first forward calibrates each matmul's activation scale on its
    (padded) batch in observe mode, then the bf16 block weights are
    quantized per output channel and dropped, and every forward runs the
    int8 model."""
    cfg: ViTConfig = VIT_CONFIGS[arch]
    if input_px != cfg.img_size:
        cfg = ViTConfig(**{**cfg.__dict__, "img_size": input_px})
    if pool is not None:
        cfg = ViTConfig(**{**cfg.__dict__, "pool": pool})
    use_int8 = _int8_requested()
    if use_int8:
        _logger.warning(
            f"{identifier}: int8 (W8A8) inference enabled — features will "
            "deviate slightly from the fp16/bf16 reference output"
        )

    # the calibration forward runs in observe mode, whose state is the bf16 one
    build_cfg = ViTConfig(**{**cfg.__dict__, "quant": "observe"}) if use_int8 else cfg
    with torch.device("meta"):  # no memory and no init until weights arrive
        model = ImageViT(build_cfg)
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
    models = {"forward": model.to(device=device, dtype=torch.bfloat16).eval()}

    def quantize(images: torch.Tensor) -> None:
        """Calibrate on ``images``, then swap in the int8 model."""
        act_stats = calibrate_act_stats(models["forward"], images)
        with torch.no_grad():
            qstate = quantize_vit_params(models.pop("forward").state_dict(), cfg)
        with torch.device("meta"):
            qmodel = ImageViT(ViTConfig(**{**cfg.__dict__, "quant": "int8"}))
        # assign: int8 weights, f32 scales and bf16 rest keep their dtypes
        qmodel.load_state_dict({**qstate, **act_stats}, assign=True)
        models["forward"] = qmodel.eval()

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
            x = ((images.float() - mean) / std).to(torch.bfloat16)
        if use_int8 and models["forward"].cfg.quant == "observe":
            quantize(x)  # the first, padded batch calibrates, as in the JAX package
        with torch.inference_mode():
            return models["forward"](x).float()[:n]

    return Extractor(
        identifier=identifier,
        input_px=input_px,
        feat_dim=feat_dim,
        transform_host=_resize_transform(input_px),
        forward=forward,
        precision="int8" if use_int8 else "bfloat16",
    )
