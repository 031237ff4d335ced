"""Tile-extractor abstraction, in PyTorch.

Counterpart of ``stamp_tpu.preprocessing.extractor`` with the same contract:

* ``transform_host``: PIL tile → uint8 HWC array (resize only — cheap)
* ``forward``: uint8 batch [B, H, W, 3] → float32 features [B, D] on the
  model's device.  Normalization (x − 255·mean)/(255·std) runs on the
  device in f32 and the backbone in bfloat16, so the host→device transfer
  is 1 byte a pixel.  ``forward`` does not synchronize: the caller
  materializes the features when it writes them.

Every family is a tower behind ``tower_extractor``: built on the meta
device in a QuantDense mode, given weights by ``load_or_init_``, run on the
device in bf16 (Swin in f32), and, when int8 extraction is requested,
calibrated on its first batch and swapped for its W8A8 form
(``int8_tower_state``, the JAX package's ``int8_tower_state``).
``make_vit_extractor`` is the ImageViT zoo's; the other families' factories
live beside it (``coca_beit3``, ``clip_like``, ``ticon``, ``swin``,
``empty``).

Weights are upstream checkpoints (timm's for the ImageViT zoo) found in the
shared ``~/.cache/stamp`` / HuggingFace caches (or ``STAMP_WEIGHTS_DIR``).
``STAMP_RANDOM_WEIGHTS=1`` substitutes random weights for benchmarking,
drawn from ``torch.Generator().manual_seed(0)``; they differ from the JAX
package's random weights (flax's initializers and generator give other
numbers).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch
from PIL import Image
from torch import nn

from stamp_tpu_torch.models.vit_image import (
    VIT_CONFIGS,
    ImageViT,
    ViTConfig,
    calibrate_act_stats,
    init_random_weights_,
    quantize_sites,
    select_timm_state_dict,
    vit_quant_sites,
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
    forward: Callable[[np.ndarray | torch.Tensor], torch.Tensor]  # uint8 [B,H,W,3] → f32 [B,D]
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


def load_or_init_(
    model: nn.Module,
    *,
    identifier: str,
    weight_files: list[str],
    load: Callable[[dict[str, torch.Tensor], nn.Module], Mapping[str, torch.Tensor]],
    init: Callable[[nn.Module, torch.Generator], nn.Module],
) -> nn.Module:
    """Weights for ``model``, built on the meta device: random ones from
    ``init`` with ``torch.Generator().manual_seed(0)`` on the CPU under
    STAMP_RANDOM_WEIGHTS=1, else the first pre-seeded checkpoint matching
    ``weight_files`` mapped by ``load(checkpoint, model)`` onto the model's
    names (strict).  A missing checkpoint raises with guidance."""
    if os.environ.get("STAMP_RANDOM_WEIGHTS") == "1":
        _logger.warning(
            f"{identifier}: using RANDOM weights (STAMP_RANDOM_WEIGHTS=1) — "
            "features are only useful for benchmarking"
        )
        model.to_empty(device="cpu")
        return init(model, torch.Generator().manual_seed(0))
    path = _find_torch_weights(weight_files)
    if path is None:
        raise FileNotFoundError(
            f"no weights found for extractor '{identifier}' "
            f"(searched caches for {weight_files}). Pre-seed the weight "
            "file into ~/.cache/stamp or set STAMP_WEIGHTS_DIR; "
            "set STAMP_RANDOM_WEIGHTS=1 for benchmarking without weights."
        )
    _logger.info(f"{identifier}: loading torch weights from {path}")
    model.load_state_dict(load(_load_torch_state_dict(path), model), assign=True)
    return model


def int8_tower_state(
    model: nn.Module, build_int8: Callable[[], nn.Module], sites: list[str], identifier: str
) -> Callable[[torch.Tensor], nn.Module]:
    """Calibrate-once-then-W8A8 state of a tower (the JAX package's
    ``int8_tower_state``).  ``model`` is the observe-mode tower with its
    bf16 (or f32) weights on the device, ``build_int8()`` the int8-mode
    tower on the meta device, ``sites`` its QuantDense sites.  Returns
    ``model_for(x)``: its first call runs one observe forward on ``x``
    recording each site's activation maximum, quantizes the sites' weights
    per output channel, drops the bf16 ones and swaps in the int8 tower,
    which every call returns."""
    _logger.warning(
        f"{identifier}: int8 (W8A8) inference enabled — features will "
        "deviate slightly from the fp16/bf16 reference output"
    )
    state: dict[str, nn.Module] = {"observe": model}

    def model_for(x: torch.Tensor) -> nn.Module:
        if "int8" not in state:
            observe = state.pop("observe")
            act_stats = calibrate_act_stats(observe, x)
            with torch.no_grad():
                qstate = quantize_sites(observe.state_dict(), sites)
            with torch.device("meta"):
                qmodel = build_int8()
            # assign: int8 weights, f32 scales and the rest keep their dtypes
            qmodel.load_state_dict({**qstate, **act_stats}, assign=True)
            state["int8"] = qmodel.eval()
        return state["int8"]

    return model_for


def tower_extractor(
    *,
    identifier: str,
    build: Callable[[str], nn.Module],
    load: Callable[[nn.Module], nn.Module],
    sites: list[str],
    device: torch.device,
    input_px: int,
    feat_dim: int,
    mean: tuple[float, float, float],
    std: tuple[float, float, float],
    dtype: torch.dtype = torch.bfloat16,
    keep_f32: tuple[str, ...] = (),
    apply: Callable[[nn.Module, torch.Tensor], torch.Tensor] | None = None,
) -> Extractor:
    """An extractor around a tower, the shape every family's factory shares.

    ``build(quant)`` makes the tower in a QuantDense mode ("off",
    "observe" or "int8") on the meta device and ``load`` gives it weights
    on the CPU (``load_or_init_``); the tower then runs on ``device`` in
    ``dtype`` (the submodules named in ``keep_f32`` in f32).  A forward
    takes a uint8 batch (numpy, or a tensor that may already lie on
    ``device``), pads it to ``batch_floor()``, normalizes it as
    (x − 255·mean) / (255·std) in f32 on the device, casts it to ``dtype``
    and returns ``apply(tower, x)`` (default ``tower(x)``) as f32 [B, D],
    without a sync.  With int8 requested (``set_int8_extraction`` or
    STAMP_INT8_EXTRACTION=1) the first, padded batch calibrates the
    observe-mode tower and every forward runs the int8 one
    (``int8_tower_state``)."""
    use_int8 = _int8_requested()
    with torch.device("meta"):  # no memory and no init until weights arrive
        model = build("observe" if use_int8 else "off")
    model = load(model).to(device=device, dtype=dtype).eval()
    for name in keep_f32:
        model.get_submodule(name).float()
    if use_int8:  # the observe tower lives in int8_tower_state's state alone, until it is quantized
        model_for = int8_tower_state(model, lambda: build("int8"), sites, identifier)
    else:
        model_for = lambda x, tower=model: tower  # noqa: E731
    del model
    apply = apply or (lambda tower, x: tower(x))
    mean_t = torch.tensor(mean, dtype=torch.float32, device=device) * 255.0
    std_t = torch.tensor(std, dtype=torch.float32, device=device) * 255.0

    def forward(batch: np.ndarray | torch.Tensor) -> torch.Tensor:
        """Non-blocking: returns the device tensor so consecutive batches
        queue on the stream; callers materialize at write time.  A batch
        already on ``device`` stays there."""
        images = torch.as_tensor(batch).to(device)
        n = images.shape[0]
        pad_to = max(batch_floor(), n)
        if n < pad_to:
            # pad to the steady-state batch: one shape for every forward
            images = torch.cat([images, images.new_zeros((pad_to - n, *images.shape[1:]))])
        with torch.inference_mode():
            x = ((images.float() - mean_t) / std_t).to(dtype)
        tower = model_for(x)  # the first, padded batch calibrates, as in the JAX package
        with torch.inference_mode():
            return apply(tower, x).float()[:n]

    return Extractor(
        identifier=identifier,
        input_px=input_px,
        feat_dim=feat_dim,
        transform_host=_resize_transform(input_px),
        forward=forward,
        precision="int8" if use_int8 else "bfloat16",
    )


def vit_config(arch: str, input_px: int = 224, pool: str | None = None) -> ViTConfig:
    """The zoo's ``arch`` config at ``input_px`` with ``pool`` (if given)."""
    cfg: ViTConfig = VIT_CONFIGS[arch]
    if input_px != cfg.img_size:
        cfg = ViTConfig(**{**cfg.__dict__, "img_size": input_px})
    if pool is not None:
        cfg = ViTConfig(**{**cfg.__dict__, "pool": pool})
    return cfg


def with_quant(cfg: ViTConfig, quant: str) -> ViTConfig:
    return ViTConfig(**{**cfg.__dict__, "quant": quant})


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
    cfg = vit_config(arch, input_px, pool)
    feat_dim = {"token": cfg.embed_dim, "avg": cfg.embed_dim, "token_avg_concat": 2 * cfg.embed_dim}[cfg.pool]
    return tower_extractor(
        identifier=identifier,
        build=lambda quant: ImageViT(with_quant(cfg, quant)),
        load=lambda model: load_or_init_(
            model,
            identifier=identifier,
            weight_files=weight_files or [],
            load=select_timm_state_dict,
            init=init_random_weights_,
        ),
        sites=vit_quant_sites(cfg.depth),
        device=device,
        input_px=input_px,
        feat_dim=feat_dim,
        mean=cfg.mean,
        std=cfg.std,
    )
