"""``python -m stamp_tpu_torch`` — the ``stamp`` CLI of the PyTorch port.

The argument surface and the YAML schema (``StampConfig``, the port's copy
of ``stamp_tpu/utils/config.py``) are those of ``python -m stamp_tpu``, and
so are the subcommands: ``init``, ``config``, ``preprocess`` (the ImageViT
extractors, bf16 and int8), ``encode_slides`` and ``encode_patients`` (every
slide and patient encoder), ``train``, ``crossval``, ``deploy``, ``statistics`` and
``heatmaps`` (every backbone and feature level), and ``export_ckpt SRC DST``,
which converts between the npz ``model.ckpt`` and the reference's Lightning
``.ckpt`` in the direction the source file calls for.  As in the JAX CLI,
``advanced_config.seed`` seeds the run (``utils.seed.Seed``) before any
command runs.

``train``, ``crossval`` and ``preprocess`` join the fleet the environment
names (``STAMP_COORDINATOR_ADDRESS``, ``STAMP_NUM_PROCESSES``,
``STAMP_PROCESS_ID``; ``parallel.distributed``) before resolving the
device, so each rank computes on its own card.  With no fleet in its
environment, a single process runs several local ranks of the same command
and fails if any of them fails: ``train`` and ``crossval`` whose
``advanced_config.mesh_shape`` holds P > 1 ranks (axes ``dcn``, ``dp``,
``sp``) run P (one per card, or CPU ranks for ``accelerator: cpu``), and
``preprocess`` on a card (``device`` auto, cuda or gpu) with N > 1 cards
visible runs N, one a card, each extracting its ``shard_worklist`` share of
the slides.

``--profile`` wraps the command in ``utils.profiling.profiled_run``: a
``torch.profiler`` trace under ``<output_dir>/profile/`` (CUDA activity too
when the command runs on a card) and the per-stage wall-time table in the
log.  A process that launches local ranks leaves the profile to them (each
writes its own trace).
"""

from __future__ import annotations

import argparse
import logging
import shutil
import sys
from pathlib import Path

import yaml

STAMP_FACTORY_SETTINGS = Path(__file__).with_name("config.yaml")

_logger = logging.getLogger("stamp")

_COMMANDS = {
    "init": "Create a new STAMP configuration file at the path specified by --config",
    "preprocess": "Preprocess whole-slide images into feature vectors",
    "encode_slides": "Encode patch-level features into slide-level embeddings",
    "encode_patients": "Encode features into patient-level embeddings",
    "train": "Train a Vision Transformer model",
    "crossval": "Train a Vision Transformer model with cross validation for "
    "modeling.n_splits folds",
    "deploy": "Deploy a trained Vision Transformer model",
    "statistics": "Generate AUROCs and AUPRCs with 95%%CI for a trained Vision "
    "Transformer model",
    "config": "Print the loaded configuration",
    "export_ckpt": "Convert a model checkpoint between this framework's npz format "
    "and the reference's Lightning .ckpt (direction inferred from the source file)",
    "heatmaps": "Generate heatmaps for a trained model",
}


def _configure_logging() -> None:
    _logger.setLevel(logging.DEBUG)
    if not any(getattr(h, "_stamp_torch", False) for h in _logger.handlers):
        handler = logging.StreamHandler(sys.stderr)
        handler.setLevel(logging.INFO)
        handler.setFormatter(logging.Formatter("%(asctime)s\t%(levelname)s\t%(message)s"))
        handler._stamp_torch = True  # type: ignore[attr-defined]
        _logger.addHandler(handler)


def _add_file_handle_(logger: logging.Logger, *, output_dir: Path) -> None:
    output_dir.mkdir(exist_ok=True, parents=True)
    file_handler = logging.FileHandler(output_dir / "logfile.log")
    file_handler.setLevel(logging.DEBUG)
    file_handler.setFormatter(logging.Formatter("%(asctime)s\t%(levelname)s\t%(message)s"))
    logger.addHandler(file_handler)


def _card_ranks(device: str) -> int:
    """The local ranks ``preprocess`` on ``device`` runs as: one a card when
    several are visible, no fleet is set and the device is a card chosen
    by the rank (auto, cuda, gpu); 0 otherwise (it runs in this process)."""
    import torch

    from stamp_tpu_torch.parallel import distributed

    if device not in ("auto", "cuda", "gpu") or distributed.in_fleet() or not torch.cuda.is_available():
        return 0
    n = torch.cuda.device_count()
    return n if n > 1 else 0


def _mesh_ranks(advanced) -> int:
    """The local ranks ``train`` or ``crossval`` runs as: the
    ``mesh_shape``'s P > 1 when no fleet is set (raising when the cards
    are fewer), 0 otherwise."""
    import math

    import torch

    from stamp_tpu_torch.parallel import distributed

    if not advanced.mesh_shape or distributed.in_fleet():
        return 0
    n = math.prod(advanced.mesh_shape.values())
    if n == 1:
        return 0
    distributed.check_mesh_axes(advanced.mesh_shape)
    if advanced.accelerator != "cpu" and (visible := torch.cuda.device_count()) < n:
        raise ValueError(f"mesh_shape {advanced.mesh_shape} needs {n} devices but {visible} are visible")
    return n


def _local_ranks(config, command: str, section) -> int:
    """How many local ranks this command runs as (0: in this process)."""
    if command in ("train", "crossval"):
        if section.task is None:
            raise ValueError(f"task must be set in {'training' if command == 'train' else command} configuration")
        return _mesh_ranks(config.advanced_config)
    if command == "preprocess":
        return _card_ranks(section.device)
    return 0


def _on_card(config, command: str, section) -> bool:
    """Whether the command computes on a card (its trace records CUDA activity)."""
    import torch

    if command in ("train", "crossval"):
        device = config.advanced_config.accelerator
    else:
        device = getattr(section, "device", None) or getattr(section, "accelerator", None) or "cpu"
    return str(device) != "cpu" and torch.cuda.is_available()


def _run_preprocess(section) -> None:
    from stamp_tpu_torch.parallel.distributed import init_distributed
    from stamp_tpu_torch.preprocessing.extract import extract_
    from stamp_tpu_torch.utils.device import resolve_device

    init_distributed(use_cuda=section.device != "cpu")
    extract_(
        output_dir=section.output_dir,
        wsi_dir=section.wsi_dir,
        wsi_list=section.wsi_list,
        cache_dir=section.cache_dir,
        tile_size_um=section.tile_size_um,
        tile_size_px=section.tile_size_px,
        extractor=section.extractor,
        max_workers=section.max_workers,
        device=resolve_device(section.device),
        default_slide_mpp=section.default_slide_mpp,
        brightness_cutoff=section.brightness_cutoff,
        canny_cutoff=section.canny_cutoff,
        cache_tiles_ext=section.cache_tiles_ext,
        generate_hash=section.generate_hash,
        macenko_normalization=section.macenko_normalization,
        # only an explicit YAML value pins the numeric mode; otherwise
        # the STAMP_INT8_EXTRACTION env var is in charge
        extractor_precision=(
            section.extractor_precision
            if "extractor_precision" in section.model_fields_set
            else None
        ),
    )


def _run_deploy(section) -> None:
    from stamp_tpu_torch.modeling.deploy import deploy_categorical_model_
    from stamp_tpu_torch.utils.device import resolve_device

    deploy_categorical_model_(
        output_dir=section.output_dir,
        checkpoint_paths=section.checkpoint_paths,
        clini_table=section.clini_table,
        slide_table=section.slide_table,
        feature_dir=section.feature_dir,
        patient_label=section.patient_label,
        filename_label=section.filename_label,
        drop_patients_with_missing_ground_truth=section.drop_patients_with_missing_ground_truth,
        device=resolve_device(section.accelerator),
        ground_truth_label=section.ground_truth_label,
        time_label=section.time_label,
        status_label=section.status_label,
    )


def _run_encode_slides(section) -> None:
    from stamp_tpu_torch.encoding.init import init_slide_encoder_
    from stamp_tpu_torch.utils.device import resolve_device

    init_slide_encoder_(
        encoder=section.encoder,
        output_dir=section.output_dir,
        feat_dir=section.feat_dir,
        device=resolve_device(section.device),
        agg_feat_dir=section.agg_feat_dir,
        generate_hash=section.generate_hash,
    )


def _run_encode_patients(section) -> None:
    from stamp_tpu_torch.encoding.init import init_patient_encoder_
    from stamp_tpu_torch.utils.device import resolve_device

    init_patient_encoder_(
        encoder=section.encoder,
        output_dir=section.output_dir,
        feat_dir=section.feat_dir,
        slide_table_path=section.slide_table,
        patient_label=section.patient_label,
        filename_label=section.filename_label,
        device=resolve_device(section.device),
        agg_feat_dir=section.agg_feat_dir,
        generate_hash=section.generate_hash,
    )


def _run_train(config, section) -> None:
    from stamp_tpu_torch.modeling.train import train_categorical_model_
    from stamp_tpu_torch.parallel.distributed import init_distributed
    from stamp_tpu_torch.utils.device import resolve_device

    advanced = config.advanced_config
    init_distributed(use_cuda=advanced.accelerator != "cpu")
    train_categorical_model_(config=section, advanced=advanced, device=resolve_device(advanced.accelerator))


def _run_crossval(config, section) -> None:
    from stamp_tpu_torch.modeling.crossval import categorical_crossval_
    from stamp_tpu_torch.parallel.distributed import init_distributed
    from stamp_tpu_torch.utils.device import resolve_device

    advanced = config.advanced_config
    init_distributed(use_cuda=advanced.accelerator != "cpu")
    categorical_crossval_(config=section, advanced=advanced, device=resolve_device(advanced.accelerator))


def _run_statistics(section) -> None:
    from stamp_tpu_torch.statistics import compute_stats_

    compute_stats_(
        task=section.task,
        output_dir=section.output_dir,
        pred_csvs=section.pred_csvs,
        ground_truth_label=section.ground_truth_label,
        true_class=section.true_class,
        time_label=section.time_label,
        status_label=section.status_label,
    )


def _run_heatmaps(section) -> None:
    from stamp_tpu_torch.heatmaps.generate import heatmaps_

    heatmaps_(
        feature_dir=section.feature_dir,
        wsi_dir=section.wsi_dir,
        checkpoint_path=section.checkpoint_path,
        output_dir=section.output_dir,
        slide_paths=section.slide_paths,
        device=section.device,
        topk=section.topk,
        bottomk=section.bottomk,
        default_slide_mpp=section.default_slide_mpp,
        opacity=section.opacity,
    )


def _run_export_ckpt(src: Path, dst: Path) -> None:
    """Convert between the npz checkpoint and the reference's Lightning
    format, whichever direction the source file calls for."""
    from stamp_tpu_torch.modeling.checkpoint import save_checkpoint
    from stamp_tpu_torch.modeling.interop import (
        export_reference_checkpoint,
        is_reference_checkpoint,
        load_reference_checkpoint,
    )

    if is_reference_checkpoint(src):
        model, variables = load_reference_checkpoint(src)
        save_checkpoint(dst, hyper_parameters=model.checkpoint_hparams(), variables=variables)
        _logger.info(f"converted reference Lightning checkpoint {src} -> npz {dst}")
    else:
        export_reference_checkpoint(src, dst)
        _logger.info(f"converted npz checkpoint {src} -> reference Lightning {dst}")


# command → (config section, runner(config, section))
_RUNNERS = {
    "preprocess": ("preprocessing", lambda config, section: _run_preprocess(section)),
    "encode_slides": ("slide_encoding", lambda config, section: _run_encode_slides(section)),
    "encode_patients": ("patient_encoding", lambda config, section: _run_encode_patients(section)),
    "train": ("training", _run_train),
    "crossval": ("crossval", _run_crossval),
    "deploy": ("deployment", lambda config, section: _run_deploy(section)),
    "statistics": ("statistics", lambda config, section: _run_statistics(section)),
    "heatmaps": ("heatmaps", lambda config, section: _run_heatmaps(section)),
}
# commands that take advanced_config (a default one when the YAML has none)
_NEEDS_ADVANCED = {"train", "crossval"}


def _run_cli(args: argparse.Namespace, argv: list[str]) -> None:
    if args.command == "export_ckpt":
        _run_export_ckpt(args.src, args.dst)
        return
    if args.command == "init":
        if args.config_file_path.exists():
            _logger.info(
                f"Refusing to overwrite existing config file at "
                f"{args.config_file_path.absolute()}"
            )
        else:
            shutil.copy(STAMP_FACTORY_SETTINGS, args.config_file_path)
            _logger.info(f"Created new config file at {args.config_file_path.absolute()}")
        return

    from stamp_tpu_torch.modeling.config import AdvancedConfig, MlpModelParams, ModelParams, VitModelParams
    from stamp_tpu_torch.utils import profiling
    from stamp_tpu_torch.utils.config import StampConfig
    from stamp_tpu_torch.utils.seed import Seed

    with open(args.config_file_path) as config_yaml:
        config = StampConfig.model_validate(yaml.safe_load(config_yaml))
    if args.command in _NEEDS_ADVANCED and config.advanced_config is None:
        config.advanced_config = AdvancedConfig(model_params=ModelParams(vit=VitModelParams(), mlp=MlpModelParams()))
    if config.advanced_config is not None and config.advanced_config.seed is not None:
        Seed.set(config.advanced_config.seed)
    if args.command == "config":
        print(yaml.dump(config.model_dump(mode="json", exclude_none=True)))
        return

    section_name, run = _RUNNERS[args.command]
    section = getattr(config, section_name)
    if section is None:
        raise ValueError(f"no {section_name} configuration supplied")
    _add_file_handle_(_logger, output_dir=section.output_dir)
    _logger.info(
        "using the following configuration:\n"
        f"{yaml.dump(section.model_dump(mode='json', exclude_none=True))}"
    )
    if n := _local_ranks(config, args.command, section):
        from stamp_tpu_torch.parallel._fleet_launch import launch_fleet

        why = "mesh_shape " + str(config.advanced_config.mesh_shape) if args.command != "preprocess" else f"{n} cards"
        _logger.info(f"{why}: running this command as {n} local ranks")
        launch_fleet(["-m", "stamp_tpu_torch", *argv], n_processes=n, capture=False)
        return
    if args.profile:  # a torch.profiler trace and the per-stage wall-time table
        with profiling.profiled_run(section.output_dir, cuda=_on_card(config, args.command, section)):
            run(config, section)
    else:
        run(config, section)


def main(argv: list[str] | None = None) -> None:
    _configure_logging()
    parser = argparse.ArgumentParser(
        prog="stamp",
        description="STAMP: Solid Tumor Associative Modeling in Pathology "
        "(PyTorch/CUDA port)",
    )
    parser.add_argument(
        "--config",
        "-c",
        type=Path,
        dest="config_file_path",
        default=Path("config.yaml"),
        help="Path to config file. Default: config.yaml",
    )
    parser.add_argument(
        "--profile",
        action="store_true",
        help="Write a torch.profiler trace under <output_dir>/profile and log a per-stage wall-time table.",
    )
    subparsers = parser.add_subparsers(dest="command")
    for name, help_text in _COMMANDS.items():
        sub = subparsers.add_parser(name, help=help_text)
        if name == "export_ckpt":
            sub.add_argument("src", type=Path, help="checkpoint to convert")
            sub.add_argument("dst", type=Path, help="output path")

    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        sys.exit(1)
    try:
        _run_cli(args, argv)
    except Exception as e:
        _logger.exception(e)
        sys.exit(1)


if __name__ == "__main__":
    main()
