"""MCP server: LLM-agent access to the stamp pipeline of the port.

Counterpart of ``stamp_tpu/mcp/server.py``, with the same 13 tools, their
names, parameters and docstrings (``check_available_devices`` reports the
CUDA devices): one tool per pipeline command (preprocess / train / crossval
/ deploy / statistics / heatmaps / encode_slides / encode_patients) that
builds a config dict, writes it to a temp YAML, and invokes the port's CLI
(``stamp_tpu_torch.__main__._run_cli``) in-process on a worker thread —
plus sandboxed filesystem helpers (read_file, list_files, analyze_csv,
list_column_values, check_available_devices).

Serves through ``fastmcp`` where it is installed, else through the in-repo
runtime (``_minimal_mcp``: JSON-RPC 2.0 over newline-delimited stdio); run
with ``python -m stamp_tpu_torch.mcp.server``.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import os
import tempfile
from pathlib import Path

import yaml

try:
    from fastmcp import Context, FastMCP  # type: ignore[no-redef]
except ModuleNotFoundError:
    # fall back to the in-repo minimal MCP runtime (same tool semantics,
    # newline-delimited JSON-RPC stdio transport)
    from stamp_tpu_torch.mcp._minimal_mcp import Context, FastMCP

_logger = logging.getLogger("stamp")

mcp = FastMCP("stamp-tpu")

STAMP_ROOT = Path(os.environ.get("STAMP_MCP_ROOT", Path.cwd())).resolve()


class _CtxLogHandler(logging.Handler):
    """Streams `stamp` logger records into the MCP context."""

    def __init__(self, ctx: Context, loop: asyncio.AbstractEventLoop):
        super().__init__(level=logging.INFO)
        self.ctx = ctx
        self.loop = loop

    def emit(self, record: logging.LogRecord) -> None:
        try:
            msg = self.format(record)
            asyncio.run_coroutine_threadsafe(self.ctx.info(msg), self.loop)
        except Exception:
            pass


async def _run_stamp(mode: str, config: dict, ctx: Context) -> str:
    """Write `config` to a temp YAML and run the CLI command in a thread."""
    from stamp_tpu_torch.__main__ import _run_cli

    handler = _CtxLogHandler(ctx, asyncio.get_running_loop())
    _logger.addHandler(handler)
    with tempfile.NamedTemporaryFile("w", suffix=".yaml", delete=False) as tmp:
        yaml.safe_dump(config, tmp)
        config_path = tmp.name
    try:
        args = argparse.Namespace(command=mode, config_file_path=Path(config_path), profile=False)
        # argv: what a rank the CLI launches itself (a mesh_shape, several cards) runs
        await asyncio.to_thread(_run_cli, args, ["-c", config_path, mode])
        return f"stamp {mode} completed successfully"
    except Exception as e:
        return f"stamp {mode} failed: {e}"
    finally:
        _logger.removeHandler(handler)
        Path(config_path).unlink(missing_ok=True)


def _drop_none(d: dict) -> dict:
    return {k: v for k, v in d.items() if v is not None}


@mcp.tool
async def preprocess_stamp(
    ctx: Context,
    output_dir: str,
    wsi_dir: str,
    extractor: str = "empty",
    device: str = "auto",
    cache_dir: str | None = None,
    tile_size_um: float = 256.0,
    tile_size_px: int = 224,
    max_workers: int = 8,
    default_slide_mpp: float | None = None,
    brightness_cutoff: int | None = 240,
    canny_cutoff: float | None = 0.02,
) -> str:
    """Extract tile features from whole-slide images."""
    config = {
        "preprocessing": _drop_none(
            dict(
                output_dir=output_dir,
                wsi_dir=wsi_dir,
                extractor=extractor,
                device=device,
                cache_dir=cache_dir,
                tile_size_um=tile_size_um,
                tile_size_px=tile_size_px,
                max_workers=max_workers,
                default_slide_mpp=default_slide_mpp,
                brightness_cutoff=brightness_cutoff,
                canny_cutoff=canny_cutoff,
            )
        )
    }
    return await _run_stamp("preprocess", config, ctx)


def _modeling_config(
    *,
    section: str,
    output_dir: str,
    clini_table: str,
    slide_table: str | None,
    feature_dir: str,
    task: str,
    ground_truth_label,
    time_label: str | None,
    status_label: str | None,
    categories: list[str] | None,
    patient_label: str,
    filename_label: str,
    extra: dict | None = None,
) -> dict:
    cfg = _drop_none(
        dict(
            output_dir=output_dir,
            clini_table=clini_table,
            slide_table=slide_table,
            feature_dir=feature_dir,
            task=task,
            ground_truth_label=ground_truth_label,
            time_label=time_label,
            status_label=status_label,
            categories=categories,
            patient_label=patient_label,
            filename_label=filename_label,
        )
    )
    if extra:
        cfg.update(extra)
    return {section: cfg}


@mcp.tool
async def train_stamp(
    ctx: Context,
    output_dir: str,
    clini_table: str,
    feature_dir: str,
    ground_truth_label: str | list[str] | None = None,
    slide_table: str | None = None,
    task: str = "classification",
    time_label: str | None = None,
    status_label: str | None = None,
    categories: list[str] | None = None,
    patient_label: str = "PATIENT",
    filename_label: str = "FILENAME",
) -> str:
    """Train an attention-MIL model on extracted features."""
    config = _modeling_config(
        section="training",
        output_dir=output_dir,
        clini_table=clini_table,
        slide_table=slide_table,
        feature_dir=feature_dir,
        task=task,
        ground_truth_label=ground_truth_label,
        time_label=time_label,
        status_label=status_label,
        categories=categories,
        patient_label=patient_label,
        filename_label=filename_label,
    )
    return await _run_stamp("train", config, ctx)


@mcp.tool
async def crossval_stamp(
    ctx: Context,
    output_dir: str,
    clini_table: str,
    feature_dir: str,
    ground_truth_label: str | list[str] | None = None,
    slide_table: str | None = None,
    task: str = "classification",
    n_splits: int = 5,
    time_label: str | None = None,
    status_label: str | None = None,
    categories: list[str] | None = None,
    patient_label: str = "PATIENT",
    filename_label: str = "FILENAME",
) -> str:
    """K-fold cross-validation of an attention-MIL model."""
    config = _modeling_config(
        section="crossval",
        output_dir=output_dir,
        clini_table=clini_table,
        slide_table=slide_table,
        feature_dir=feature_dir,
        task=task,
        ground_truth_label=ground_truth_label,
        time_label=time_label,
        status_label=status_label,
        categories=categories,
        patient_label=patient_label,
        filename_label=filename_label,
        extra={"n_splits": n_splits},
    )
    return await _run_stamp("crossval", config, ctx)


@mcp.tool
async def deploy_stamp(
    ctx: Context,
    output_dir: str,
    checkpoint_paths: list[str],
    slide_table: str,
    feature_dir: str,
    clini_table: str | None = None,
    ground_truth_label: str | list[str] | None = None,
    time_label: str | None = None,
    status_label: str | None = None,
    patient_label: str = "PATIENT",
    filename_label: str = "FILENAME",
) -> str:
    """Deploy trained model checkpoint(s) on a cohort."""
    config = {
        "deployment": _drop_none(
            dict(
                output_dir=output_dir,
                checkpoint_paths=checkpoint_paths,
                clini_table=clini_table,
                slide_table=slide_table,
                feature_dir=feature_dir,
                ground_truth_label=ground_truth_label,
                time_label=time_label,
                status_label=status_label,
                patient_label=patient_label,
                filename_label=filename_label,
            )
        )
    }
    return await _run_stamp("deploy", config, ctx)


@mcp.tool
async def statistics_stamp(
    ctx: Context,
    output_dir: str,
    pred_csvs: list[str],
    task: str = "classification",
    ground_truth_label: str | list[str] | None = None,
    true_class: str | None = None,
    time_label: str | None = None,
    status_label: str | None = None,
) -> str:
    """Compute statistics (AUROC/AUPRC/C-index/KM) for prediction CSVs."""
    config = {
        "statistics": _drop_none(
            dict(
                output_dir=output_dir,
                pred_csvs=pred_csvs,
                task=task,
                ground_truth_label=ground_truth_label,
                true_class=true_class,
                time_label=time_label,
                status_label=status_label,
            )
        )
    }
    return await _run_stamp("statistics", config, ctx)


@mcp.tool
async def heatmaps_stamp(
    ctx: Context,
    output_dir: str,
    feature_dir: str,
    wsi_dir: str,
    checkpoint_path: str,
    slide_paths: list[str] | None = None,
    topk: int = 0,
    bottomk: int = 0,
    default_slide_mpp: float | None = None,
    opacity: float = 0.6,
) -> str:
    """Generate Grad-CAM heatmaps and top-tile exports for a checkpoint."""
    config = {
        "heatmaps": _drop_none(
            dict(
                output_dir=output_dir,
                feature_dir=feature_dir,
                wsi_dir=wsi_dir,
                checkpoint_path=checkpoint_path,
                slide_paths=slide_paths,
                topk=topk,
                bottomk=bottomk,
                default_slide_mpp=default_slide_mpp,
                opacity=opacity,
            )
        )
    }
    return await _run_stamp("heatmaps", config, ctx)


@mcp.tool
async def encode_slides_stamp(
    ctx: Context,
    output_dir: str,
    feat_dir: str,
    encoder: str = "chief",
    device: str = "auto",
    agg_feat_dir: str | None = None,
) -> str:
    """Encode tile features into slide-level embeddings."""
    config = {
        "slide_encoding": _drop_none(
            dict(
                output_dir=output_dir,
                feat_dir=feat_dir,
                encoder=encoder,
                device=device,
                agg_feat_dir=agg_feat_dir,
            )
        )
    }
    return await _run_stamp("encode_slides", config, ctx)


@mcp.tool
async def encode_patients_stamp(
    ctx: Context,
    output_dir: str,
    feat_dir: str,
    slide_table: str,
    encoder: str = "chief",
    device: str = "auto",
    patient_label: str = "PATIENT",
    filename_label: str = "FILENAME",
    agg_feat_dir: str | None = None,
) -> str:
    """Encode tile features into patient-level embeddings."""
    config = {
        "patient_encoding": _drop_none(
            dict(
                output_dir=output_dir,
                feat_dir=feat_dir,
                slide_table=slide_table,
                encoder=encoder,
                device=device,
                patient_label=patient_label,
                filename_label=filename_label,
                agg_feat_dir=agg_feat_dir,
            )
        )
    }
    return await _run_stamp("encode_patients", config, ctx)


# ---------------------------------------------------------------------------
# sandboxed filesystem helpers (reference mcp/server.py:733-1096)
# ---------------------------------------------------------------------------


def _resolve_path(subpath: str) -> Path:
    path = (STAMP_ROOT / subpath).resolve()
    if not str(path).startswith(str(STAMP_ROOT)):
        raise ValueError(f"path {subpath} escapes the sandbox root {STAMP_ROOT}")
    return path


@mcp.tool
async def read_file(ctx: Context, path: str) -> str:
    """Read a text file below the sandbox root."""
    p = _resolve_path(path)
    return p.read_text()[:100_000]


@mcp.tool
async def list_files(ctx: Context, subdir: str = "") -> str:
    """List files below the sandbox root."""
    p = _resolve_path(subdir)
    entries = sorted(p.iterdir())
    return "\n".join(
        f"{'d' if e.is_dir() else 'f'} {e.relative_to(STAMP_ROOT)}" for e in entries
    )


@mcp.tool
async def analyze_csv(ctx: Context, path: str) -> str:
    """Summarize a CSV: columns, dtypes, null counts, describe()."""
    import pandas as pd

    df = pd.read_csv(_resolve_path(path))
    parts = [
        f"rows: {len(df)}",
        f"columns: {list(df.columns)}",
        "dtypes:\n" + df.dtypes.to_string(),
        "nulls:\n" + df.isna().sum().to_string(),
        "describe:\n" + df.describe(include="all").to_string(),
    ]
    return "\n\n".join(parts)


@mcp.tool
async def list_column_values(ctx: Context, path: str, column_name: str) -> str:
    """Unique values + counts of a CSV column."""
    import pandas as pd

    df = pd.read_csv(_resolve_path(path))
    if column_name not in df.columns:
        return f"column {column_name!r} not found; columns: {list(df.columns)}"
    return df[column_name].value_counts(dropna=False).to_string()


@mcp.tool
async def check_available_devices(ctx: Context) -> str:
    """Report the CUDA devices visible to the pipeline."""
    import torch

    if not torch.cuda.is_available():
        return "backend=cpu count=0 devices=['cpu']"
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    return f"backend=cuda count={len(names)} devices={names}"


def main() -> None:  # pragma: no cover
    mcp.run()


if __name__ == "__main__":  # pragma: no cover
    main()
