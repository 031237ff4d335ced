"""Synthetic inputs of the heatmaps tests: a PNG slide with tile-level
features (written by the port's h5 writer, which h5py reads too) and npz
checkpoints of a small MIL ViT, written by the port alone (no JAX)."""

from pathlib import Path

import numpy as np
from PIL import Image

TILE_UM = 256.0
TILE_PX = 224
SLIDE_MPP = TILE_UM / TILE_PX


def write_slide(root: Path, *, stem: str = "slide1", grid: tuple[int, int] = (7, 5), feat_dim: int = 8,
                seed: int = 0, holes: int = 5) -> tuple[Path, Path]:  # fmt: skip
    """A textured PNG slide of ``grid`` (x, y) tiles of 224 px at 256/224
    µm/px, and its feature file with ``holes`` tiles left out; returns
    (wsi_dir, feature_dir)."""
    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(seed)
    gx, gy = grid
    wsi_dir, feat_dir = root / "wsi", root / "feats"
    wsi_dir.mkdir(parents=True, exist_ok=True)
    Image.fromarray(rng.integers(0, 255, (gy * TILE_PX, gx * TILE_PX, 3), dtype=np.uint8)).save(
        wsi_dir / f"{stem}.png"
    )
    cells = np.stack(np.meshgrid(np.arange(gx), np.arange(gy), indexing="xy"), axis=-1).reshape(-1, 2)
    keep = np.sort(rng.permutation(len(cells))[: len(cells) - holes])
    coords = (cells[keep] * TILE_UM).astype(np.float32)
    write_tile_feats_atomic(
        output_path=feat_dir / f"{stem}.h5", feats=rng.normal(size=(len(coords), feat_dim)).astype(np.float32),
        coords_um=coords, extractor_id="test", tile_size_um=TILE_UM, tile_size_px=TILE_PX, code_hash="test",
    )  # fmt: skip
    return wsi_dir, feat_dir


def write_checkpoint(path: Path, task: str, *, feat_dim: int = 8, use_alibi: bool = False, seed: int = 0,
                     cutoff: float | None = None) -> Path:  # fmt: skip
    """An npz checkpoint of a random ``vit`` (width 16, 4 heads, 2 layers)
    for ``task``; survival with ``train_pred_median = cutoff``."""
    import torch

    from stamp_tpu_torch.modeling.checkpoint import save_checkpoint
    from stamp_tpu_torch.modeling.tasks import LitTileClassifier, LitTileRegressor, LitTileSurvival
    from stamp_tpu_torch.models import vision_transformer as vit

    common = dict(model_class=vit.VisionTransformer, dim_input=feat_dim, model_name="vit", dim_model=16,
                  dim_feedforward=16, n_heads=4, n_layers=2, use_alibi=use_alibi)  # fmt: skip
    if task == "classification":
        model = LitTileClassifier(ground_truth_label="gt", categories=["a", "b", "c"],
                                  category_weights=[1.0, 1.0, 1.0], **common)  # fmt: skip
    elif task == "regression":
        model = LitTileRegressor(ground_truth_label="t", **common)
    else:
        model = LitTileSurvival(time_label="day", status_label="status", **common)
    vit.init_random_weights_(model.module, torch.Generator().manual_seed(seed))
    hparams = model.checkpoint_hparams()
    if cutoff is not None:
        hparams["train_pred_median"] = cutoff
    save_checkpoint(path, hyper_parameters=hparams, variables=vit.variables_to_jax(model.module.state_dict()))
    return path
