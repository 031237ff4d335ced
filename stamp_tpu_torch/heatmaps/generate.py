"""Grad-CAM heatmaps and top-tile export.

Counterpart of ``stamp_tpu/heatmaps/generate.py`` for tile-level
checkpoints of every backbone: per-slide Grad-CAM per category, per-tile
softmax scores from bags of one tile, attention rollout (dense, or
streamed from (q, k) at ``STREAMING_ROLLOUT_MIN_SEQ`` tiles; ``vit``), the
category-support diverging maps, the classification / regression /
survival branches and the top- and bottom-k tile crops read back from the
WSI, with the same file names.  A multi-target model (barspoon) gets one
full set per target, each stem suffixed with ``sanitize(target)``, in the
same tree.  Coordinates go to a backbone only where it takes them
(``supports_coords``; TransMIL does not).

The JAX package takes the jacobian with ``jax.jacrev`` (one forward and a
vmapped VJP), per target for a multi-target model.  The flash kernels'
autograd Functions have no vmap rule, so the port runs one forward of the
whole bag with the features requiring grad and then one
``torch.autograd.grad`` per output, keeping the graph between them: one
backward pass per category (of every target) over a single forward, whose
logits are the slide's prediction too.  On the card a ``vit`` bag of at
least ``FLASH_ATTENTION_MIN_SEQ`` tokens (tiles + CLS) runs the flash
forward once per layer and its backward once per layer and output.  The
per-tile scores are ``torch.func.vmap`` of a one-tile forward, as the JAX
package's ``jax.vmap``: each tile's bag is its own batch (TransMIL's
pseudo-inverse scales by a max over its batch), in chunks of
``TILE_SCORE_CHUNK`` tiles.

Differences from the JAX package, none in a written file:

* the features, coordinates and ``feat_type`` come through the port's
  ``io.h5`` (no h5py on the card's machine);
* the ``raw/`` PNGs are colored through ``_colormaps``, the four
  matplotlib maps as lookup tables; matplotlib is imported inside the
  functions that draw ``plots/`` only, and without it those figures are
  skipped and named in one warning;
* rollout takes the layers in their order (the JAX package sorts the block
  names, which differs from 11 layers on).
"""

from __future__ import annotations

import dataclasses
import logging
from collections.abc import Iterable, Sequence
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch
from PIL import Image

from stamp_tpu_torch.heatmaps import _colormaps
from stamp_tpu_torch.io.h5 import _read_feature_file, get_coords, get_stride
from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
from stamp_tpu_torch.models import weights
from stamp_tpu_torch.models.barspoon import sanitize
from stamp_tpu_torch.preprocessing.wsi import get_slide_mpp_, open_slide
from stamp_tpu_torch.types import Microns, SlideMPP, TilePixels
from stamp_tpu_torch.utils import profiling
from stamp_tpu_torch.utils.device import resolve_device
from stamp_tpu_torch.utils.figures import pyplot, warn_not_written

__all__ = ["heatmaps_"]

_logger = logging.getLogger("stamp")

supported_extensions = {
    ".czi", ".svs", ".tif", ".vms", ".vmu", ".ndpi", ".scn", ".mrxs",
    ".tiff", ".svslide", ".bif", ".qptiff", ".png", ".jpg", ".jpeg",
}  # fmt: skip


def _as_tensors(module: torch.nn.Module, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
    """``arrays`` on the device and in the dtype of ``module`` (f32 as the
    CLI runs it)."""
    param = next(module.parameters())
    return tuple(torch.from_numpy(np.asarray(a)).to(param.device, param.dtype) for a in arrays)


def _forward(module: torch.nn.Module, feats: torch.Tensor, coords: torch.Tensor):
    """One forward of bags [B, T, F] without a key mask; ``coords`` [B, T, 2]
    go in only where the module takes them."""
    if module.supports_coords:
        return module(feats, coords=coords, key_mask=None)
    return module(feats)


def _cams(
    module: torch.nn.Module, feats: np.ndarray, coords: np.ndarray, outputs: Sequence | None = None
) -> tuple[np.ndarray | dict[str, np.ndarray], np.ndarray]:
    """(logits, cam) of one whole-bag forward: logits [C] ({target: [C_t]}
    for a multi-target model), and row i of cam [len(outputs), tile] is
    |mean over features of f · ∂out_i/∂f| (the jacobian's row, one backward
    each), before any normalisation.  An output is a category index, or a
    (target, index) pair of a multi-target model; by default every one, in
    order.  numpy, in the module's dtype."""
    f, c = _as_tensors(module, feats, coords)
    f.requires_grad_(True)
    out = _forward(module, f[None], c[None])
    heads = {k: v[0] for k, v in out.items()} if isinstance(out, dict) else {None: out[0]}
    if outputs is None:
        outputs = [i if t is None else (t, i) for t, logits in heads.items() for i in range(logits.shape[0])]
    cams = []
    for i, o in enumerate(outputs):
        target = heads[None][o] if isinstance(o, int) else heads[o[0]][o[1]]
        (grad,) = torch.autograd.grad(target, f, retain_graph=i < len(outputs) - 1)
        cams.append((f.detach() * grad).mean(-1).abs())
    logits = {k: v.detach().cpu().numpy() for k, v in heads.items()}
    return logits.pop(None) if None in logits else logits, torch.stack(cams).cpu().numpy()


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def _gradcam_per_category(module: torch.nn.Module, feats: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """[tile, category] Grad-CAM scores: the cam of each category, softmaxed
    over tiles (reference heatmaps/__init__.py:36-56)."""
    _, cam = _cams(module, feats, coords)
    return _softmax(cam).T


def _gradcam_single(module: torch.nn.Module, feats: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """[tile] relevance for single-output models (heatmaps/__init__.py:115-139)."""
    return _cams(module, feats, coords)[1][0]


STREAMING_ROLLOUT_MIN_SEQ = 4096


def _rollout_row_step(r: torch.Tensor, q: torch.Tensor, k: torch.Tensor, *, block: int = 256) -> torch.Tensor:
    """One rollout layer as a streamed vector–matrix product.

    ``(r · Ā)_j = meanₕ Σ_q r_q · softmax_row(q)ⱼ`` computed from (q, k)
    in query blocks of ``block`` rows — the [T, T] attention matrix is never
    materialized.  r: [T]; q, k: [H, T, D] → new r [T].
    """
    h, t, d = q.shape
    scale = d**-0.5
    acc = torch.zeros(t, dtype=torch.float32, device=q.device)
    for start in range(0, t, block):
        s = torch.matmul(q[:, start : start + block] * scale, k.transpose(-1, -2))  # [H, block, T]
        p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
        acc += torch.einsum("q,hqk->k", r[start : start + block], p) / h
    return acc


def _attention_rollout_single(module: torch.nn.Module, feats: np.ndarray, coords: np.ndarray) -> np.ndarray:
    """Attention rollout: CLS→tile relevance aggregated across layers
    (reference heatmaps/__init__.py:59-112).

    Small bags use the attention maps the model collects; large bags (≥
    ``STREAMING_ROLLOUT_MIN_SEQ`` tiles) stream the CLS-row product from the
    per-layer (q, k) instead, keeping memory O(T·D)."""
    streaming = feats.shape[0] >= STREAMING_ROLLOUT_MIN_SEQ
    f, c = _as_tensors(module, feats, coords)
    inter: dict = {}
    with torch.inference_mode():
        module(f[None], coords=c[None], key_mask=None, sow_weights=not streaming, intermediates=inter)
        if streaming:
            r = None
            for block in inter.values():
                q, k = block["attn_q"][0], block["attn_k"][0]  # [H, T+1, D]
                if r is None:
                    r = torch.zeros(q.shape[1], dtype=torch.float32, device=q.device)
                    r[0] = 1.0
                r = _rollout_row_step(r, q, k)
            cls_attn = r[1:].cpu().numpy()
        else:
            rollout = None
            for block in inter.values():
                attn = block["attn_weights"][0].mean(0)  # [seq, seq]
                attn = attn / (attn.sum(dim=-1, keepdim=True) + 1e-8)
                rollout = attn if rollout is None else rollout @ attn
            cls_attn = rollout[0, 1:].cpu().numpy()  # CLS → tiles
    cls_attn = cls_attn - cls_attn.min()
    return cls_attn / max(cls_attn.max(), 1e-8)


TILE_SCORE_CHUNK = 512


def _per_tile_scores(
    module: torch.nn.Module, feats: np.ndarray, coords: np.ndarray
) -> np.ndarray | dict[str, np.ndarray]:
    """Per-tile class scores [tile, C] ({target: [tile, C_t]} for a
    multi-target model): the softmax of each tile's bag of one tile, vmapped
    (reference heatmaps/__init__.py:417-430)."""
    f, c = _as_tensors(module, feats, coords)

    def single(fi: torch.Tensor, ci: torch.Tensor):
        out = _forward(module, fi[None, None], ci[None, None])
        return {k: v[0] for k, v in out.items()} if isinstance(out, dict) else out[0]

    with torch.no_grad():
        logits = torch.func.vmap(single, chunk_size=TILE_SCORE_CHUNK)(f, c)
        if isinstance(logits, dict):
            return {k: torch.softmax(v, dim=1).cpu().numpy() for k, v in logits.items()}
        return torch.softmax(logits, dim=1).cpu().numpy()


# raw PNG resolution: 8 px per 256 µm tile (matches the thumbnail scale)
_PX_PER_TILE = 8


def _vals_to_im(scores: np.ndarray, coords_norm: np.ndarray) -> np.ndarray:
    """Scatter per-tile values onto the [gy, gx, ...] tile grid; cells
    without a tile stay zero."""
    values = scores[:, None] if scores.ndim == 1 else scores
    gx, gy = coords_norm.max(0) + 1
    grid = np.zeros((gy, gx, *values.shape[1:]), dtype=values.dtype)
    grid[coords_norm[:, 1], coords_norm[:, 0]] = values
    return grid


def _slide_thumbnail(slide, grid_shape: tuple[int, int], default_slide_mpp) -> np.ndarray:
    """RGB thumbnail at the raw-PNG scale, cropped to the tile grid."""
    mpp = get_slide_mpp_(slide, default_mpp=default_slide_mpp)
    extent_um = np.asarray(slide.dimensions, np.float64) * mpp
    request = tuple(np.round(extent_um * _PX_PER_TILE / 256).astype(int).tolist())
    thumb = np.asarray(slide.get_thumbnail(request))
    gy, gx = grid_shape
    return thumb[: gy * _PX_PER_TILE, : gx * _PX_PER_TILE]


def _save_grid_png(path: Path, rgba: np.ndarray) -> None:
    """Save an RGBA [gy, gx, 4] float grid as an upscaled nearest PNG."""
    gy, gx = rgba.shape[:2]
    Image.fromarray(np.uint8(rgba * 255)).resize(
        (gx * _PX_PER_TILE, gy * _PX_PER_TILE),
        resample=Image.Resampling.NEAREST,
    ).save(path)


def _export_ranked_tiles(
    *,
    slide,
    tiles_dir: Path,
    stem: str,
    label: str,
    tile_scores: np.ndarray,
    coords_tile_slide_px: np.ndarray,
    tile_size_slide_px: TilePixels,
    topk: int,
    bottomk: int,
) -> None:
    """Crop the best/worst-scoring tiles out of the WSI as
    ``{top|bottom}_{rank}-{stem}-{label}={score}.jpg`` (reference
    heatmaps/__init__.py:190-239)."""
    scores = np.ravel(np.asarray(tile_scores))
    ascending = np.argsort(scores)
    rankings = (("top", ascending[::-1][:topk]), ("bottom", ascending[:bottomk]))
    for prefix, ranked in rankings:
        for rank, tile in enumerate(ranked, start=1):
            x, y = (int(v) for v in coords_tile_slide_px[tile])
            crop = slide.read_region((x, y), 0, (tile_size_slide_px, tile_size_slide_px))
            crop.convert("RGB").save(tiles_dir / f"{prefix}_{rank:02d}-{stem}-{label}={scores[tile]:0.2f}.jpg")


def _class_map_rgba(top_idx_grid: np.ndarray, occupied: np.ndarray) -> np.ndarray:
    """Pastel map of the per-cell argmax category."""
    rgba = _colormaps.apply("Pastel1", top_idx_grid)
    rgba[..., -1] = occupied.astype(float)
    return rgba


def _blend_overlay(thumb: np.ndarray, score_rgba: np.ndarray, alpha: float) -> np.ndarray:
    """Alpha-blend the heat colors over the thumbnail wherever a tile
    exists (the heat alpha channel marks coverage)."""
    base = thumb.astype(np.float64) / 255.0
    heat = (
        np.asarray(
            Image.fromarray(np.uint8(score_rgba * 255)).resize(
                (thumb.shape[1], thumb.shape[0]),
                resample=Image.Resampling.NEAREST,
            ),
            dtype=np.float64,
        )
        / 255.0
    )
    blended = base.copy()
    covered = heat[..., -1] > 0
    blended[covered] = alpha * heat[covered, :3] + (1 - alpha) * base[covered]
    return (blended * 255).astype(np.uint8)


def _save_overlay_figure(path: Path, overlay: np.ndarray, title: str, *, with_legend: bool, dpi: int) -> bool:
    """The titled overlay under ``plots/``; returns whether it was written
    (False without matplotlib)."""
    plt = pyplot()
    if plt is None:
        return False
    from matplotlib.patches import Patch

    fig, ax = plt.subplots(figsize=(10, 8))
    ax.imshow(overlay)
    ax.set_title(title, fontsize=16, pad=20)
    ax.axis("off")
    if with_legend:
        handles = [
            Patch(facecolor="red", alpha=0.7, label="Positive"),
            Patch(facecolor="blue", alpha=0.7, label="Negative"),
        ]
        ax.legend(handles=handles, loc="upper right", bbox_to_anchor=(0.98, 0.98))
    fig.tight_layout()
    fig.savefig(path, dpi=dpi, bbox_inches="tight")
    plt.close(fig)
    return True


def _save_classification_overview(path: Path, thumb, class_rgba, panels, probs, categories) -> bool:
    """Thumbnail + class map on top, one panel per category; returns
    whether it was written (False without matplotlib)."""
    plt = pyplot()
    if plt is None:
        return False
    from matplotlib.patches import Patch

    fig, axs = plt.subplots(nrows=2, ncols=max(2, len(categories)), figsize=(12, 8))
    axs[0, 0].imshow(thumb)
    axs[0, 1].imshow(class_rgba)
    legend = [Patch(facecolor=_colormaps.apply("Pastel1", i), label=c) for i, c in enumerate(categories)]
    axs[0, 1].legend(handles=legend)
    for ax, (category, rgba), p in zip(axs[1, :], panels, probs):
        ax.imshow(rgba)
        ax.set_title(f"{category} {p:1.2f}")
    for ax in axs.ravel():
        ax.axis("off")
    fig.savefig(path)
    plt.close(fig)
    return True


def _save_scalar_overview(path: Path, thumb, overlay, value: float) -> bool:
    plt = pyplot()
    if plt is None:
        return False
    fig, axs = plt.subplots(1, 2, figsize=(12, 6), facecolor="white")
    for ax, image, title in zip(axs, (thumb, overlay), ("Thumbnail", f"Prediction Heatmap ({value:.3f})")):
        ax.imshow(image)
        ax.set_title(title)
        ax.axis("off")
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return True


@dataclass(frozen=True)
class _SlideJob:
    """Everything one slide's heatmap emission needs, assembled up front."""

    stem: str
    slide: object
    feats: np.ndarray
    coords_um: np.ndarray
    grid_xy: np.ndarray  # integer tile-grid coordinates
    coords_px: np.ndarray  # level-0 pixel coordinates
    tile_px: TilePixels
    plots: Path
    raw: Path
    tiles: Path
    default_slide_mpp: SlideMPP | None

    def grid(self, per_tile: np.ndarray) -> np.ndarray:
        return _vals_to_im(per_tile, self.grid_xy)


def _load_slide_job(wsi_path: Path, h5_path: Path, output_dir: Path, default_slide_mpp: SlideMPP | None) -> _SlideJob:
    slide = open_slide(wsi_path)
    slide_mpp = get_slide_mpp_(slide, default_mpp=default_slide_mpp)
    if slide_mpp is None:
        raise ValueError(f"could not determine the MPP of {wsi_path}")

    datasets, attrs = _read_feature_file(h5_path)
    feat_type = attrs.get("feat_type", None)
    if feat_type is not None and feat_type != "tile":
        raise ValueError(
            f"Feature file {h5_path} is a slide or patient level feature. "
            "Heatmaps are currently supported for tile-level features only."
        )
    feats = np.asarray(datasets["feats"]).astype(np.float32)
    coords_info = get_coords(datasets, attrs, h5_path)

    coords_um = coords_info.coords_um.astype(np.float32)
    stride_um = Microns(get_stride(coords_um))
    dirs = {kind: output_dir / h5_path.stem / kind for kind in ("plots", "raw", "tiles")}
    for path in dirs.values():
        path.mkdir(exist_ok=True, parents=True)

    return _SlideJob(
        stem=h5_path.stem,
        slide=slide,
        feats=feats,
        coords_um=coords_um,
        grid_xy=np.round(coords_um / stride_um).astype(np.int64),
        coords_px=np.round(coords_um / slide_mpp).astype(np.int64),
        tile_px=TilePixels(int(round(float(coords_info.tile_size_um) / slide_mpp))),
        plots=dirs["plots"],
        raw=dirs["raw"],
        tiles=dirs["tiles"],
        default_slide_mpp=default_slide_mpp,
    )


def _emit_classification(
    job: _SlideJob,
    categories: Sequence[str],
    logits: np.ndarray,
    cam: np.ndarray,
    scores: np.ndarray,
    *,
    opacity: float,
    topk: int,
    bottomk: int,
) -> list[Path]:
    """Classification heatmaps from the slide's logits, its per-category
    cam ([category, tile], before the softmax over tiles) and the per-tile
    scores ([tile, category], ``_per_tile_scores``): per-category
    diverging maps whose sign is the category's *support* (winner margin vs
    runner-up) and whose intensity is Grad-CAM attention; plus class map,
    overlays, overview, and ranked tiles for the predicted category.
    Returns the ``plots/`` figures not written."""
    probs = _softmax(np.asarray(logits))
    categories = list(categories)
    predicted = int(probs.argmax())
    not_written: list[Path] = []

    gradcam = _softmax(cam).T  # [tile, category]
    occupied = job.grid(np.ones(len(job.feats))).squeeze(-1) > 0

    thumb = _slide_thumbnail(job.slide, occupied.shape, job.default_slide_mpp)
    Image.fromarray(thumb).save(job.raw / f"thumbnail-{job.stem}.png")

    class_rgba = _class_map_rgba(job.grid(scores).argmax(-1), occupied)
    _save_grid_png(job.raw / f"{job.stem}-classmap.png", class_rgba)

    # winner index + top-2 probabilities per tile drive the support term
    order = np.argsort(-scores, axis=-1)
    winner = order[:, 0]
    first, second = np.take_along_axis(scores, order[:, :2], axis=-1).T

    panels: list[tuple[str, np.ndarray]] = []
    for pos, category in enumerate(categories):
        # winner tiles: margin over the runner-up; others: deficit vs winner
        support = np.where(winner == pos, scores[:, pos] - second, scores[:, pos] - first)
        rival_cam = np.delete(gradcam, pos, axis=1).max(-1)
        attention = np.where(
            winner == pos,
            gradcam[:, pos] / gradcam.max(),
            rival_cam / max(rival_cam.max(), 1e-12),
        )
        heat = support * attention / max(attention.max(), 1e-12)

        rgba = _colormaps.apply("RdBu_r", job.grid(heat / 2 + 0.5).squeeze(-1))
        rgba[..., -1] = job.grid(attention).squeeze(-1) > 0
        panels.append((category, rgba))

        _save_grid_png(job.raw / f"{job.stem}-{category}={probs[pos]:0.2f}.png", rgba)
        overlay = _blend_overlay(thumb, rgba, opacity)
        Image.fromarray(overlay).save(job.raw / f"raw-overlay-{job.stem}-{category}.png")
        figure = job.plots / f"overlay-{job.stem}-{category}.png"
        if not _save_overlay_figure(
            figure, overlay, f"{category} - Slide Score: {probs[pos]:.3f}", with_legend=True, dpi=150
        ):
            not_written.append(figure)
        if pos == predicted:
            _export_ranked_tiles(
                slide=job.slide,
                tiles_dir=job.tiles,
                stem=job.stem,
                label=category,
                tile_scores=heat,
                coords_tile_slide_px=job.coords_px,
                tile_size_slide_px=job.tile_px,
                topk=topk,
                bottomk=bottomk,
            )

    overview = job.plots / f"overview-{job.stem}.png"
    if not _save_classification_overview(overview, thumb, class_rgba, panels, probs, categories):
        not_written.append(overview)
    return not_written


def _emit_scalar(
    job: _SlideJob,
    cutoff: float | None,
    logits: np.ndarray,
    cam: np.ndarray,
    *,
    task: str,
    opacity: float,
    topk: int,
    bottomk: int,
) -> list[Path]:
    """Regression/survival heatmaps: single Grad-CAM relevance map ``cam``
    ([tile]).

    Survival models with a stored ``train_pred_median`` (``cutoff``) get a
    diverging map centered on that cut-off (the same threshold statistics
    uses for KM splits); otherwise a sequential colormap.  Returns the
    ``plots/`` figures not written."""
    value = float(np.asarray(logits).squeeze())
    not_written: list[Path] = []

    gradcam = cam
    relevance = gradcam / max(gradcam.max(), 1e-8)
    raw_grid = job.grid(gradcam).squeeze(-1)
    normed = (raw_grid - raw_grid.min()) / (raw_grid.max() - raw_grid.min() + 1e-8)

    if task == "survival" and cutoff is not None:
        centered = normed - cutoff
        rgba = _colormaps.apply("RdBu_r", centered / (2 * np.abs(centered).max() + 1e-8) + 0.5)
    else:
        rgba = _colormaps.apply("Reds" if task == "survival" else "magma", normed)
    rgba[..., -1] = (raw_grid > 0).astype(np.float32)

    _save_grid_png(job.raw / f"{job.stem}-heatmap.png", rgba)

    thumb = _slide_thumbnail(job.slide, raw_grid.shape, job.default_slide_mpp)
    Image.fromarray(thumb).save(job.raw / f"thumbnail-{job.stem}.png")

    overlay = _blend_overlay(thumb, rgba, opacity)
    Image.fromarray(overlay).save(job.raw / f"raw-overlay-{job.stem}.png")
    figure = job.plots / f"overlay-{job.stem}.png"
    if not _save_overlay_figure(figure, overlay, f"{task} - Slide Score: {value:.3f}", with_legend=False, dpi=300):
        not_written.append(figure)
    overview = job.plots / f"overview-{job.stem}.png"
    if not _save_scalar_overview(overview, thumb, overlay, value):
        not_written.append(overview)

    _export_ranked_tiles(
        slide=job.slide,
        tiles_dir=job.tiles,
        stem=job.stem,
        label=task,
        tile_scores=relevance,
        coords_tile_slide_px=job.coords_px,
        tile_size_slide_px=job.tile_px,
        topk=topk,
        bottomk=bottomk,
    )
    return not_written


def heatmaps_(
    *,
    feature_dir: Path,
    wsi_dir: Path,
    checkpoint_path: Path,
    output_dir: Path,
    slide_paths: Iterable[Path] | None,
    device: str | torch.device = "auto",
    default_slide_mpp: SlideMPP | None,
    opacity: float,
    topk: int,
    bottomk: int,
) -> None:
    """Heatmaps of every slide of ``wsi_dir`` (or of ``slide_paths``) that
    has a feature file of its stem in ``feature_dir``, on ``device``
    (``resolve_device``: ``auto`` without a card raises)."""
    dev = resolve_device(device)
    model, variables = load_model_from_ckpt(checkpoint_path)
    task = model.hparams["task"]
    if task not in ("classification", "regression", "survival"):
        raise ValueError(f"unsupported task for heatmaps: {task}")
    module = weights.load_variables_(model.module, variables)
    module.to(dev).eval()

    if slide_paths is not None:
        worklist = (wsi_dir / slide for slide in slide_paths)
    else:
        worklist = (p for ext in supported_extensions for p in wsi_dir.glob(f"**/*{ext}"))

    not_written: list[Path] = []
    try:
        for wsi_path in worklist:
            h5_path = feature_dir / wsi_path.with_suffix(".h5").name
            if not h5_path.exists():
                _logger.info(f"could not find matching h5 file at {h5_path}. Skipping...")
                continue

            _logger.info(f"creating heatmaps for {wsi_path.name}")
            job = _load_slide_job(wsi_path, h5_path, output_dir, default_slide_mpp)
            if task == "classification" and isinstance(model.categories, dict):
                # multi-target: one set per target, from one forward
                outputs = [(t, i) for t, cats in model.categories.items() for i in range(len(cats))]
                with profiling.stage("heatmaps/gradcam"):
                    logits, cam = _cams(module, job.feats, job.coords_um, outputs)
                with profiling.stage("heatmaps/tile_scores"):
                    scores = _per_tile_scores(module, job.feats, job.coords_um)
                with profiling.stage("heatmaps/render"):
                    for t, cats in model.categories.items():
                        rows = [k for k, (target, _) in enumerate(outputs) if target == t]
                        not_written += _emit_classification(
                            dataclasses.replace(job, stem=f"{job.stem}-{sanitize(t)}"), cats, logits[t], cam[rows],
                            scores[t], opacity=opacity, topk=topk, bottomk=bottomk,
                        )  # fmt: skip
                continue
            with profiling.stage("heatmaps/gradcam"):
                logits, cam = _cams(module, job.feats, job.coords_um)
            if task == "classification":
                with profiling.stage("heatmaps/tile_scores"):
                    scores = _per_tile_scores(module, job.feats, job.coords_um)
                with profiling.stage("heatmaps/render"):
                    not_written += _emit_classification(
                        job, model.categories, logits, cam, scores, opacity=opacity, topk=topk, bottomk=bottomk
                    )
            else:
                with profiling.stage("heatmaps/render"):
                    not_written += _emit_scalar(
                        job, model.hparams.get("train_pred_median", None), logits, cam[0],
                        task=task, opacity=opacity, topk=topk, bottomk=bottomk,
                    )  # fmt: skip
    finally:
        module.to("cpu")
    warn_not_written(not_written)
