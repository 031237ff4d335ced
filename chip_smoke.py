#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stamp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints at least one line; any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: compiles ``stamp_tpu_torch/ops/csrc/*.cu`` and loads them.
3. kernels: each CUDA kernel against its plain PyTorch version at the UNI2
   shapes in bf16, max |Δ| / max |ref| against a stated tolerance, and the
   median time of each (with a bf16 PyTorch control for reference);
   ``fused_qkv_mha`` also at ViT-L's and Virchow's (d = 80) shapes, and
   ragged, at the one-pass kernel's N limit and above it (the two-pass
   kernel, N = 273 and 1,030); ``ln_dense`` also at ViT-L's and Virchow's sites (Virchow's fc2
   at K = 3,416) and at ragged K and N (N = 200, 8, 1), with its rate and
   the share of its bound it reaches; ``fused_qkv_mha``, ``ln_dense`` and
   their library controls also timed in runs of back-to-back calls
   (``*_b2b``) beside the per-call timer.
4. main path: ``python -m stamp_tpu_torch -c config.yaml
   preprocess`` in-process, UNI2 at full width with random weights on a
   synthetic 3072×3072 px slide (144 tiles at 256 µm / 224 px, batch 64);
   checks the h5 and that every kernel launch count grew as the model's
   structure says.
5. whole model: the same UNI2 weights on 8 tiles through the kernel path
   and the plain path on the card (per-tile cosine), the steady-state
   forward rate at batch 64 and a ``torch.profiler`` split of one forward.
3b. flash kernels: ``flash_mha`` and ``flash_alibi_mha`` (f32) against their
   plain versions at the deploy shapes [8, 4097, 64] and [8, 16385, 64] with
   the last 40% of keys masked, and at ragged small shapes and d = 32, 128;
   the median time of each, its TFLOP/s over the valid keys and share of
   the bound, with ``F.scaled_dot_product_attention`` as the library
   control of ``flash_mha``, and (``torch.profiler``) the device time of
   the pre-pass, the tile list and the attention kernel (and, for the
   ALiBi forward, of the distance-weighted sum's three kernels); then the
   cases the tile skipping creates (whole masked key tiles between valid
   ones, a sequence with no valid key, every key masked at a ragged T,
   Tq ≠ Tk, d = 32, 128; bitwise-equal reruns); then a head width of 48 at
   T = 4,097 through the public wrappers (zero-padded to the 64 instance).
6. deploy: ``python -m stamp_tpu_torch -c config.yaml deploy``
   in-process, an ensemble of two MIL ViT checkpoints at the default width
   (``vit`` and ``vit`` + ALiBi, random weights, UNI2 inputs of width 1536)
   on four patients of 2,500 to 20,000 tiles (T = 4,097 … 32,769 after
   bucket padding and CLS); checks the three CSVs and that each flash
   kernel ran 2 layers × 4 patients times, then holds the kernel path
   against the plain path on the card for the patients with T ≤ 16,385.
3c. backward kernels: the flash backward (pre-pass, tile lists, dQ and
   dK/dV kernels) of ``flash_mha`` and ``flash_alibi_mha`` and the
   distance-weighted sum (f32) against their plain versions at
   [8, 4097 | 16385, 64] with 40% of keys masked and a dense dO, and at
   ragged small shapes and d = 32, 128; masked keys get exactly zero dK and
   dV, two runs are bitwise equal; the median time of each, with the
   backward of ``F.scaled_dot_product_attention`` as the library control of
   ``flash_mha``'s, and (``torch.profiler``) the device time of each of the
   four kernels, the TFLOP/s they execute and the share of the bound; the
   distance-weighted sum as the ALiBi backward calls it (the key mask as its
   a-mask: masked rows exactly zero) with a dense dO and, timed as its own
   row, the last MIL layer's dO, and without an a-mask; then
   the cases the tile skipping creates: a key mask with whole masked tiles
   between valid ones, a sequence with no valid key, the first MIL layer's
   dO (zero on the padded rows) and the last layer's (zero but on row 0,
   timed at [8, 16385, 64] as its own row, its bound counting only the
   nonzero rows), each with a zero dQ where dO is zero; then the gradients
   of both wrappers at a head width of 48, T = 4,097, against the plain
   backward.  As everywhere in this script the plain versions run with
   TF32 off (phase 1), so they are f32 throughout.  A product that must
   stay f32-accurate (ALiBi's D·V and the distance-weighted sum) is bounded
   at the better of the f32 rate and three TF32 products (``bound_ms``);
   ``bound_f32_ms`` is the same bound at the f32 rate alone.
7. train: ``python -m stamp_tpu_torch -c config.yaml train``
   in-process, whole-slide training (``bag_size: null``, 2 epochs) of the
   default MIL ViT (``vit`` and ``vit`` + ALiBi, width 512, UNI2 inputs) on
   twelve synthetic patients of 2,100 to 12,000 tiles (T = 4,097, 8,193,
   16,385) with a planted signal; checks ``metrics.csv``, that each backward
   kernel ran 2 layers × training steps times and the ALiBi statistic's
   kernel (``pairwise_distance_sums``) once a training step, that
   ``model.ckpt`` deploys, and one training step at T = 8,193 on the kernel
   path against the plain path (the flash kernels and the statistic's
   kernel swapped for their plain versions), from the initial and from the
   trained weights; the step time at each T, the statistic's kernel at each
   T on the model's coordinates and mask against its plain version (and
   both against float64), timed beside it with its bound, and a
   ``torch.profiler`` split of one step at T = 16,385.
8. crossval: ``python -m stamp_tpu_torch -c config.yaml crossval`` on the
   same cohort (2 folds, 2 epochs, batches of 2, the default ``bag_size`` of
   512: training on the einsum path, validation and fold exports through
   the forward kernels; the ALiBi statistic's kernel once a training step,
   at 512 tiles too); checks each fold's checkpoint, that its metrics
   and predictions are finite, and holds fold 0's exported probabilities
   against its checkpoint on the kernel path and the plain path.

3d. int8 kernel: ``ln_quant_dense`` against its plain version at phase
   3's sites (UNI2, ViT-L, Virchow's qkv and its fc2 at K = 3,416, whose
   int8 weight the wrapper pads to 16-byte rows: the pad timed alone) and
   ragged shapes, its int8 activations
   (read back through an identity weight) against the plain quantization;
   the median time of each site, its rate and share of its bound, beside
   ``torch._int_mm`` on the pre-quantized activation (the library control;
   both also back to back, as in phase 3) and the bf16 ``ln_dense`` kernel.
3e. TITAN kernel: ``flash_alibi2d_mha`` (f32) against its plain version at
   [12, 4097 | 16385 | 20001, 64] (20,001: a patient of two 10,000-tile
   slides) on the grid of a slide-shaped tissue region with the CLS token
   at (0, 0), and at ragged small shapes, N < 64 and N = 1 (with and
   without the CLS exemption); the median time, its TFLOP/s and share of
   the bound, beside ``F.scaled_dot_product_attention`` f32 with the
   [12, N, N] bias materialised outside the timed region (up to 16,385).
4b. int8 main path: phase 4's ``preprocess`` with ``extractor_precision:
   int8``: the ``uni2-int8`` directory, ``precision = "int8"``, 72
   ``ln_quant_dense`` launches per int8 forward (none in the calibration
   forward), per-tile cosine against phase 4's bf16 features; the
   steady-state int8 and bf16 rates at batch 64 in turns, a
   ``torch.profiler`` split of one int8 forward, and the int8 model on the
   kernel path against its plain path.
9. TITAN: ``python -m stamp_tpu_torch -c config.yaml
   encode_slides`` and ``encode_patients`` in-process at full width
   (random weights) on synthetic CONCH1.5 slides of 1,500, 4,096, 10,000
   (two) and 16,384 tiles and one patient of the two 10,000-tile slides
   (the virtual slide, 20,000 tiles); checks the h5 contract and 12 kernel
   launches for each slide or patient of at least 2,048 tiles (none below),
   the 4,096-tile embedding on the kernel path against the plain path, the
   seconds per slide, and a ``torch.profiler`` split of the 16,384-tile
   slide.

10. statistics: ``python -m stamp_tpu_torch -c config.yaml statistics``
   in-process on phase 6's deploy CSVs (the ensemble of ``vit`` and
   ALiBi), phase 8's crossval folds, and seeded regression and survival
   predictions: every table exists and is finite, each AUROC in the tables
   is the numpy metric computed from its CSV, and each figure is written
   or (no matplotlib on the machine) named in the command's warning.
11. heatmaps: ``python -m stamp_tpu_torch -c config.yaml
   heatmaps`` in-process, one slide a run, with phase 7's trained
   checkpoints (``vit`` and ``vit`` + ALiBi, width 512, 8 heads of 64, 2
   layers) on synthetic TIFF slides (32 µm/px, 256 µm tiles) with UNI2
   features of 2,500, 6,000 and 20,000 tiles (T = 2,501 on the einsum
   path, 6,001 and 20,001 on the kernels, no key mask): the ``plots/``,
   ``raw/`` and ``tiles/`` tree; 2 flash forward launches and 2 × C
   backward launches (and, for ALiBi, 2 × C distance-weighted sums) per
   slide of T ≥ 4,096 and none below; the pre-softmax Grad-CAM [category,
   tile] on the kernel path against the plain path on the card at
   T = 6,001 and 20,001 (``CAM_TOL`` of max |plain|, and the top-k tile
   sets wherever the plain cam's gap at rank k exceeds it); the last
   category's cam computed alone bitwise equal to the one computed after
   the other categories' backward passes over the retained graph; seconds
   per slide (and the command's stages), and a ``torch.profiler`` split of
   the 20,000-tile ALiBi slide's Grad-CAM (the forward's kernels, the
   distance-weighted sum's, each backward kernel, the rest, and the host).

12. model zoo: the other backbones through the CLI in-process at the widths
   of ``modeling/config.py`` (``mlp`` 512 wide, 2 layers; ``trans_mil`` 512;
   ``barspoon`` 512, 8 + 8 heads, 2 + 2 layers, feed-forward 2,048; random
   weights, synthetic features from fixed seeds), with the TF32 flags as
   PyTorch leaves them for the CLI.  12a: ``encode_slides`` (TITAN) on 24
   CONCH1.5 slides of 1,500 to 6,000 tiles (12 ``flash_alibi2d_mha``
   launches a slide of 2,048 tiles or more, none below) and
   ``encode_patients`` (two slides a patient); ``train`` and ``deploy`` of
   ``mlp`` and ``linear`` on the slide features and of ``mlp`` on the
   patient features, and the slide-level ``mlp`` deployed on the patient
   features.  12b: on phase 7's cohort, ``crossval`` (2 folds, 2 epochs,
   ``bag_size`` 512) and ``deploy`` (fold 0, full bags) of ``trans_mil`` and
   of multi-target ``barspoon`` (targets of 2 and 3 classes), and
   ``statistics`` of the multi-target CSV; a training step at bag 512 and a
   forward at 12,000 tiles timed.  12c: ``heatmaps`` of phase 11's
   6,000-tile slide with both fold-0 checkpoints, one file tree per
   target.  12d: ``export_ckpt`` to the Lightning format, ``deploy`` from
   it (the CSV the npz deploy's to 1e-6) and ``export_ckpt`` back (bitwise).
   No launch of rows 4–8 anywhere in phase 12.  For one patient per
   backbone and for the 6,000-tile cams, the card against the port's own
   CPU forward on the same checkpoint and features (``ZOO_PROB_TOL``,
   ``ZOO_CAM_TOL``; barspoon's cams in f64, with the f32 distances and the
   f32 cam's one-ulp sensitivity printed); a ``torch.profiler`` split of
   each backbone's training step and 12,000-tile forward.

13. extractor zoo: every other tile-extractor family through ``python -m
   stamp_tpu_torch -c config.yaml preprocess`` in-process on phase
   4's slide (144 tiles, batch 64, random weights at full width): CONCH and
   CONCH1.5 (CoCa at 448 px, 785 tokens: row 1's two-pass kernel), KEEP
   (ViT-L/16 and its head), TICON (H-Optimus-1 and the contextualizer) in
   bf16 and in int8, CTransPath, CHIEF-CTransPath, PLIP, MUSK and ``empty``
   in bf16, and PLIP once more with ``macenko_normalization``; each run's
   h5 contract and its launches (rows 1–3 at every block of the first
   four, ``ln_quant_dense`` in int8; none of rows 1–9 elsewhere).  Each
   family's features on the card against its plain path (rows 1–3's plain
   versions; 8 tiles, bf16 and int8, LayerScale γ = 1 for KEEP and TICON)
   or, for the families without a kernel, against the port's CPU forward
   of the same weights (2 tiles, MUSK 1), per-tile cosine ≥
   ``ZOO_COSINE_MIN`` (KEEP's and TICON's ImageViT output too; int8 ≥
   ``ZOO_INT8_COSINE_MIN``, TICON's int8 features ≥
   ``TICON_INT8_COSINE_MIN``); rows 1–3 at every shape those families give them
   (``ZOO_LN_SITES``, ``ZOO_ATTENTION``) against their plain versions at
   ``KERNEL_TOL``; CONCH and CONCH1.5 tiles/s at batch 64 and MFU over the
   H100's bf16 peak (``TILE_GFLOP``); row 1's two-pass kernel at
   [64, 785, 2304 | 3072] (12 and 16 heads) against its plain version and
   SDPA bf16, one sync a call and back to back, with its bound, the
   design's floor, its TFLOP/s, the share of its outputs bitwise equal to
   the plain version's (≥ ``TWO_PASS_EQUAL_MIN``: only this tells the JAX
   package's operation order from p cast before its normalization) and a
   bitwise repeat; the two-pass kernel's
   launches (``fused_qkv_long``: 12 a CONCH forward, one a block, 24 a
   CONCH1.5 one, none for KEEP and TICON; none for UNI2 in phases 4 and
   4b); Macenko on the card against the golden tile
   and the CPU (H&E-like tiles), on uniform-noise tiles the card and the
   CPU each against the CPU in f64 (p99 ≤ ``MACENKO_P99``), and its ms per
   batch; ``encode_slides`` with TITAN on the CONCH1.5 features.

14. encoder zoo: the other slide and patient encoders through ``python -m
   stamp_tpu_torch -c config.yaml encode_slides`` and
   ``encode_patients`` in-process at published width (random weights) on
   synthetic tile features of phase 9's slides (1,500, 4,096, 10,000 (two)
   and 16,384 tiles) and patient (the two 10,000-tile slides): GigaPath
   (1536-d ``gigapath``), PRISM (2560-d ``virchow-full``), COBRA (2560-d
   ``virchow2``, and 512-d ``conch`` slides), MADELEINE (``conch``), CHIEF
   (768-d ``chief-ctranspath``) and EAGLE (768-d ``ctranspath`` with the
   Virchow2 files as ``agg_feat_dir``), with the TF32 flags as PyTorch
   leaves them; the h5 contract (shape, attrs) and skip-if-exists on a
   rerun; no launch of rows 1–9 (every count 0 before each command and
   after); each encoder on the card against the port's CPU forward of the
   same weights on the 1,500-tile slide (``ENCODER_TOL`` of max |CPU|,
   ``ENCODER_COSINE_MIN``), and GigaPath once more with matmul TF32 on,
   which the limit must refuse; EAGLE's top-25 tile sets against the CPU's
   with the rank-25 gap; seconds per slide and patient (the encoder's
   forward, inputs read beforehand, median of 3) beside the CLI's
   ``encode/read``, ``encode/forward`` and ``encode/h5_write``; a
   ``torch.profiler`` split of the 16,384-tile GigaPath, PRISM and COBRA
   forwards, and each encoder's peak device memory at 16,384 tiles.

15. parallel: ``stamp_tpu_torch.parallel`` on the one card (see
   ``phase_parallel``): (a) ``train`` with ``mesh_shape: {dp: 1}`` (a
   process group of one, NCCL) on phase 7's cohort and configs, its
   ``model.ckpt`` against phase 7's (≤ 1e-6 of max |param|, bitwise
   expected) and rows 4–8 and the ALiBi statistic's kernel launched as in
   phase 7; (b) a fleet of two ranks
   sharing the card (gloo, collectives staged through pinned host
   memory): whole-slide ``train`` with ``{dp: 2}`` against (a) (≤ 1e-6,
   bitwise expected) and ALiBi at ``bag_size: 512``, ``batch_size: 4``
   against a run without a mesh (≤ 1e-5); (c) ``preprocess`` (UNI2 bf16)
   as a fleet of two ranks on four small slides: the shares
   ``shard_worklist``'s, the features bitwise a single process's, a
   crashed rank's share picked up by one process; (d) ``crossval`` as a
   fleet of two ranks, one fold each, each fold's probabilities within
   1e-6 of a single-process run; (e) phase 7's training epoch with the
   prefetching feed and with the synchronous one: the epoch's wall time
   and the device's idle share.

16. sequence: ``stamp_tpu_torch.parallel``'s ``sp`` axis, ``--profile``'s
   trace and ``preprocess`` over several cards, on the one card (see
   ``phase_sequence``): (a) a fleet of two ranks sharing the card (gloo,
   staged) trains phase 7's ``vit`` and ALiBi configs on whole slides
   with ``mesh_shape: {sp: 2}`` (rows 4–8 at Tq = T/2 + 1 against T + 1
   gathered keys): each ``model.ckpt`` against phase 7's (≤ 1e-5 of max
   |param|), each rank's launches of rows 4–8 and of the ALiBi statistic's
   kernel equal to phase 7's run, their sum printed as ``sp_launches``; one ``{sp: 2}`` step at T = 4,097 on the
   card, its all-reduced gradients against one process's (≤ 1e-3 of each
   tensor's largest, a limit the doubled gradients fail); (b) in the same fleet,
   ``make_sp_eval_forward`` of phase 7's ``vit`` on a 16,384-tile bag
   against the single forward (≤ 1e-5); (c) ``--profile train`` of phase
   7's ``vit`` and ALiBi: the trace under ``<output_dir>/profile/`` naming
   the flash kernels, the stage table, ``model.ckpt`` bitwise the run
   without ``--profile``, the mean step with and without the trace, the
   trace's top five device operations and the device's idle share per
   epoch; (d) phase 4's ``preprocess`` with two cards seen
   by the parent: two ranks share the card, the h5 bitwise phase 4's.

17. model parallel: ``stamp_tpu_torch.parallel``'s ``make_tp_forward`` and
   ``make_pp_forward``, the MCP server and shapecheck, on the one card (see
   ``phase_model_parallel``): (a) UNI2 at full width (random weights,
   LayerScale γ = 1) on 64 tiles, TP over two ranks sharing the card (gloo,
   staged) in bf16 and int8 against the one-rank forward, each rank's
   launches of rows 1–3 by its counters and by the profiler; the two new
   entry forms of rows 2 and 3 at UNI2's fc2 under TP (the caller's row
   statistics, the partial-sum epilogue) against their plain versions,
   timed beside their library controls and bound, and row 1 at 12 and 6
   heads; (b) PP over the two ranks, 12 blocks a stage, 4 microbatches, in
   bf16 and int8 on the 64 tiles and a ragged 61, bitwise or its largest
   difference against one rank; the forwards' wall times beside one
   rank's and the share the collectives hold; (c) ``python -m
   stamp_tpu_torch.mcp.server`` as a subprocess: ``initialize``,
   ``tools/list``, ``check_available_devices`` (names the card) and
   ``deploy_stamp`` of phase 7's checkpoint, its CSV equal to the CLI's;
   (d) a wrongly shaped ``fused_qkv_mha`` call raises with no launch.

Phases run in the order 1, 2, 3, 3b, 3c, 3d, 3e, 4, 4b, 5, 6, 7, 8, 9, 10,
11, 12, 13, 14, 15, 16, 17 and print their wall time.  The phases that read a
command's stage timer (4, 4b, 6, 7, 9, 11, 13, 14) run it in-process with
the timer on and no trace (``_staged_cli``: ``--profile``'s stage table
without its ``torch.profiler`` trace), so their rates are untraced; 16a's
ranks and 16c run ``--profile`` itself.  The line before the last is
``{"kernels": [...]}``: each kernel's launches on its main path (phase 4,
4b, 6, 7 or 9, rows 1–3 also phase 13's; the MIL forward's, phases 6 and 7;
the ALiBi statistic's ``alibi_pair_sums``, phases 7 and 8's training;
rows 4–8 also ``heatmaps_launches``, phase 11's; rows 1, 2, 4–8 and the
statistic also ``parallel_launches``, phase 15's in-process runs; rows 4–8
and the statistic also ``sp_launches``, phase 16's ``sp`` training on both
ranks; rows 1–3 also
``tp_launches`` and ``pp_launches``, phase 17's on both ranks, rows 2 and 3
the ``forms`` TP runs at fc2 and row 1 the heads of a rank, ``tp_heads``;
row 1 also its
two-pass kernel's launches and times at [64, 785, 3072], ``long_*``), its
largest error against its plain
version, its time, the plain version's and the library control's, and the
least time the card could take for the same work (``bound_ms``: the larger
of the bytes over 3.35 TB/s and the operations over the H100 SXM's peak
rate for their type, an f32-accurate product at the better of the f32 rate
and three TF32 products; rows 6–8 also print ``bound_f32_ms``, that product
at the f32 rate alone).  The last line is ``{"ok": true, "device": {...}}``.
Without a CUDA card, or outside a checkout of the repository, the script
exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
WORK = REPO / "build" / "chip_smoke"

# max |kernel − plain| / max |plain| on bf16 outputs.  Both sides round the
# output once to bf16 (relative step 2^-8 ≈ 3.9e-3); the kernel and the
# plain version sum in different orders and may round an intermediate
# (LN output, softmax probability) to the neighbouring bf16 value, which
# moves an output by a fraction of that step.  1e-2 leaves room for a few
# such flips on the largest elements and still fails any indexing,
# masking or scaling fault, which shows as an error of order 1.
KERNEL_TOL = 1e-2
# whole-model per-tile cosine, kernel path against plain path on the card
COSINE_MIN = 0.99

UNI2_TOKENS = 265  # (224/14)² patches + 1 cls + 8 register tokens
BATCH = 64

# max |kernel − plain| / max |plain| on the f32 flash kernels.  Their q·kᵀ
# and P·V run in TF32 (10-bit mantissa: each operand rounded by up to
# 2^-11 ≈ 4.9e-4 relative); the errors of a 64-term dot mostly cancel, and
# the softmax averages them further.  5e-3 leaves a margin of ten and still
# fails a masking or indexing fault, whose error is of order one.
FLASH_TOL = 5e-3
# ALiBi's D·V is a 3×TF32 split (22 of f32's 24 mantissa bits per operand)
# summed per 64-key tile, then across tiles in rounded f32.  Phase 3b also
# holds the kernel and the plain version against an f64 D·V: the plain f32
# GEMM is the less accurate of the two, near 1e-5 of max |ref| at
# T = 16,385.  1e-4 holds that and refuses plain TF32 (order 1e-3).
DACC_TOL = 1e-4
# deploy: class probabilities, kernel path against plain path
PROB_TOL = 1e-3
# the flash backward's dq, dk, dv (and ALiBi's d dist_scale) against the
# plain f32 backward: five TF32 products per (query, key) pair, each
# operand rounded by up to 2^-11; as for the forward, 5e-3 of max |ref|
# leaves a margin and fails any masking or indexing fault (order one)
BWD_TOL = 5e-3
# the distance-weighted sum alone against its plain version: the forward's
# 3×TF32 D·V with per-tile sums (see DACC_TOL)
DWS_TOL = 1e-4
# a whole-slide training step, kernel path against plain path: the loss
# (relative) and every parameter gradient (of its max |ref|)
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 5e-3

# whole-model per-tile cosine, int8 (W8A8) features against bf16 ones
INT8_COSINE_MIN = 0.98
# TITAN's slide embedding, kernel path against plain path: max |Δ| / max |ref|
# (the flash kernel's TF32 products, FLASH_TOL, through 12 layers) and cosine
TITAN_TOL = 1e-2
TITAN_COSINE_MIN = 0.999

# H100 SXM peaks (NVIDIA data sheet, dense): the bounds in the kernels line
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12, "int8": 1979e12}

# deploy cohort: tiles per patient → T = bucket + CLS = 4,097 … 32,769
DEPLOY_TILES = (2500, 6000, 12000, 20000)
# training cohort: four patients in each bucket, T = 4,097, 8,193, 16,385
TRAIN_TILES = (2100, 2600, 3200, 3900, 4400, 5200, 6100, 7300, 8400, 9600, 10900, 12000)
TRAIN_EPOCHS = 2
# phase 7's third run: the vit with STAMP's attention dropout (config.yaml's
# 0.25), rows 4–5's dropout forms in training at every bucket
TRAIN_DROPOUT = 0.25
CROSSVAL_EPOCHS = 2
UNI2_DIM = 1536
MIL_LAYERS = 2
MIL_HEADS = 8
# TITAN cohort: CONCH1.5 slides of these tile counts (users encode slides of
# 5,000-20,000 tiles), and one patient of the two 10,000-tile slides
TITAN_TILES = {"slide-1500": 1500, "slide-4096": 4096, "slide-10000": 10000, "slide-10000b": 10000,
               "slide-16384": 16384}  # fmt: skip
TITAN_PATIENT = ("slide-10000", "slide-10000b")
TITAN_LAYERS = 12
# heatmaps: synthetic slides of these tile counts (T = 2,501 on the einsum
# path, 6,001 and 20,001 on the kernels: ragged, no key mask) at a coarse
# 32 µm/px, tiles of 256 µm (8 px): the 20,000-tile TIFF is 1,136 px square
HEATMAP_TILES = (2500, 6000, 20000)
HEATMAP_MPP = 32.0
HEATMAP_TOPK = 8
# the pre-softmax Grad-CAM [category, tile], kernel path against plain
# path: max |Δ| / max |plain|.  The cam is |mean(f·J)| with J through two
# layers of TF32 flash forward and backward (FLASH_TOL, BWD_TOL each) and
# the f32 GEMMs around them; 1e-2 holds their sum with a margin and fails a
# masking or indexing fault (order one).  The ALiBi cam is mostly the
# distance term's, so at T = 20,001 the softmax branch is also held alone
CAM_TOL = 1e-2

# model zoo (phase 12): 24 CONCH1.5 slides of 1,500 to 6,000 tiles for
# TITAN, then the other backbones at the widths of modeling/config.py
ZOO_SLIDE_TILES = tuple(1500 + 4500 * i // 23 for i in range(24))
ZOO_EPOCHS = 2
ZOO_TARGETS = {"subtype": ["a", "b"], "grade": ["g1", "g2", "g3"]}
# the card against the port's own CPU forward on the same checkpoint and
# features: class probabilities (absolute, f32 on both) and the pre-softmax
# cams (of max |CPU|; TransMIL's in f32, barspoon's in f64 on both devices:
# its f32 cam moves by ~1e-3 when the features move by one ulp, so two
# correct f32 devices differ by that much, and the f32 distances are
# printed beside).  A masking, indexing or TF32 fault shows at 1e-3 and more.
ZOO_PROB_TOL = 1e-4
ZOO_CAM_TOL = 1e-3
ZOO_DEVICE = "cuda:0"
ZOO_WIDTH = 512  # barspoon's d_model and the other backbones' width (modeling/config.py)


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


#: back-to-back calls a sample of the second timer of rows 1–3 holds
B2B_REPS = 20


def _time_ms(fn, iters: int, reps: int = 1) -> list[float]:
    """Per-call device time of ``fn`` (CUDA events), after a warm-up call:
    ``iters`` samples of ``reps`` back-to-back calls each.  With ``reps = 1``
    (a sync around every call: the timer of every kernel time the script
    reports) a short call's host launch work is timed as device time; a run
    of back-to-back calls overlaps it with the device's work, as a forward
    does."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return times


def _compare_timed(kernel, plain, control=None, iters: int = 5, reps: int = 1) -> dict:
    """Kernel vs plain (vs a bf16 control), timed in turns (plain, kernel,
    control, control, kernel, plain) on this one card; medians in ms.  A
    None is left out."""
    fns = {"plain": plain, "kernel": kernel, "control": control}
    samples: dict[str, list[float]] = {k: [] for k, fn in fns.items() if fn is not None}
    for name in ("plain", "kernel", "control", "control", "kernel", "plain"):
        if fns[name] is not None:
            samples[name] += _time_ms(fns[name], iters, reps)
    return {k: statistics.median(v) for k, v in samples.items()}


def _error(got, want) -> tuple[float, float]:
    """(max |Δ|, max |Δ| / max |want|) in f32."""
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


def phase_device() -> tuple[str, str]:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
    )
    if smi.returncode != 0 or not smi.stdout.strip():
        _fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    print(
        f"[1 device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"get_device_name: {kind}; count {torch.cuda.device_count()}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}"
    )
    return kind, card


def phase_build() -> None:
    from stamp_tpu_torch.ops import _build

    t0 = time.perf_counter()
    fresh = not _build.library_path().is_file()
    _build.load_library()
    secs = time.perf_counter() - t0
    print(f"[2 build] {'built' if fresh else 'loaded'} {_build.library_path().name} in {secs:.1f} s")
    log = _build.library_path().with_suffix(".log")
    if fresh and log.is_file():
        for line in log.read_text().splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "arning")):
                print(f"[2 build] {line.strip()}")


# (M, K, N, site) of the LayerNorm-fed matmuls phases 3 and 3d hold the
# kernels to: UNI2's three at batch 64 (the main path), then ViT-L (DINO,
# UNI: K = 1024, 257 tokens, batch 8) and Virchow/Virchow2 (K = 1280; the
# SwiGLU inner norm → fc2 at K = int(1280·5.3375) / 2 = 3,416, 8 mod 16)
ZOO_M = 8 * 257
LN_SITES = (
    (BATCH * UNI2_TOKENS, 1536, 4608, "norm1→qkv"), (BATCH * UNI2_TOKENS, 1536, 8192, "norm2→fc1"),
    (BATCH * UNI2_TOKENS, 4096, 1536, "mlp.norm→fc2"), (ZOO_M, 1024, 3072, "ViT-L qkv"),
    (ZOO_M, 1024, 4096, "ViT-L fc1"), (ZOO_M, 1280, 3840, "Virchow qkv"), (ZOO_M, 3416, 1280, "Virchow fc2"),
)  # fmt: skip
UNI2_SITES = 3  # the first three of LN_SITES


def phase_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=gen)).to(torch.bfloat16)

    results: dict = {"fused_qkv_mha": [], "ln_dense": []}
    # UNI2 (ViT-H/14-reg8), DINO/UNI ViT-L (N=257, d=64), Virchow (d=80)
    for b, n, h, d in ((BATCH, UNI2_TOKENS, 24, 64), (8, 257, 16, 64), (8, 257, 16, 80)):
        qkv = randn(b, n, 3 * h * d)
        got = attn.fused_qkv_mha(qkv, h)
        want = attn.fused_qkv_mha_reference(qkv, h)
        torch.cuda.synchronize()
        abs_err, rel_err = _error(got, want)

        def control(qkv=qkv, b=b, n=n, h=h, d=d):
            q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
            o = F.scaled_dot_product_attention(q, k, v)
            return o.transpose(1, 2).reshape(b, n, h * d)

        t = _compare_timed(
            lambda: attn.fused_qkv_mha(qkv, h),
            lambda: attn.fused_qkv_mha_reference(qkv, h),
            control,
        )
        b2b = _compare_timed(lambda: attn.fused_qkv_mha(qkv, h), None, control, reps=B2B_REPS)
        row = dict(shape=[b, n, 3 * h * d], heads=h, head_dim=d, max_abs_err=abs_err,
                   rel_err=rel_err, ms=t["kernel"], plain_ms=t["plain"], sdpa_bf16_ms=t["control"],
                   ms_b2b=b2b["kernel"], sdpa_bf16_ms_b2b=b2b["control"])  # fmt: skip
        print(f"[3 kernels] fused_qkv_mha {json.dumps(row)} on {card}")
        if not rel_err <= KERNEL_TOL:
            _fail(f"fused_qkv_mha {row['shape']}: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}")
        results["fused_qkv_mha"].append(row)
        del qkv, got, want

    # ragged shapes: N below one 16-row tile's keys, at the one-pass
    # kernel's limit, and above it (the two-pass kernel: a last key tile of
    # 17 keys at 273, of 6 at 1,030); M and N off the GEMM tile
    rel_attn = {}
    long_before = attn.LONG_LAUNCHES
    for b, n, h in ((3, 21, 4), (2, attn.ONE_PASS_MAX_N, 2), (2, attn.ONE_PASS_MAX_N + 1, 2), (2, 1030, 2)):
        qkv = randn(b, n, 3 * h * 64)
        rel_attn[f"N={n}"] = _error(attn.fused_qkv_mha(qkv, h), attn.fused_qkv_mha_reference(qkv, h))[1]
    if attn.LONG_LAUNCHES - long_before != 2:
        _fail(f"N = 273 and 1,030 launched the two-pass kernel {attn.LONG_LAUNCHES - long_before} times, not 2")
    rel_ln = {}
    for n in (200, 8, 1):  # K = 264: a tail of 8 past four 64-wide boxes
        x, g, beta, w, bias = randn(1000, 264), randn(264), randn(264), randn(n, 264, scale=0.06), randn(n)
        rel_ln[f"N={n}"] = _error(lnd.ln_dense(x, g, beta, w, bias), lnd.ln_dense_reference(x, g, beta, w, bias))[1]
    print(f"[3 kernels] ragged: fused_qkv_mha d=64 rel {json.dumps(rel_attn)}; ln_dense M=1000 K=264 rel {json.dumps(rel_ln)}")
    if not (max(rel_attn.values()) <= KERNEL_TOL and max(rel_ln.values()) <= KERNEL_TOL):
        _fail("ragged shapes disagree with the plain versions")

    # UNI2's M = 16,960 rows: the TPU kernel's 256-row gate refused this M
    for m_rows, k, n, site in LN_SITES:
        x = randn(m_rows, k)
        g = (1.0 + 0.1 * torch.randn(k, device=dev, generator=gen)).to(torch.bfloat16)
        beta = randn(k, scale=0.1)
        w = randn(n, k, scale=k**-0.5)
        bias = randn(n, scale=0.1)
        got = lnd.ln_dense(x, g, beta, w, bias)
        want = lnd.ln_dense_reference(x, g, beta, w, bias)
        torch.cuda.synchronize()
        abs_err, rel_err = _error(got, want)
        kernel = lambda: lnd.ln_dense(x, g, beta, w, bias)  # noqa: E731
        control = lambda: F.linear(F.layer_norm(x, (k,), g, beta, 1e-6), w, bias)  # noqa: E731
        t = _compare_timed(kernel, lambda: lnd.ln_dense_reference(x, g, beta, w, bias), control)
        b2b = _compare_timed(kernel, None, control, reps=B2B_REPS)
        bound, by = _bound(2 * (m_rows * k + k * n + m_rows * n), {"bf16": 2 * m_rows * k * n})
        row = dict(site=site, m=m_rows, k=k, n=n, max_abs_err=abs_err, rel_err=rel_err,
                   ms=t["kernel"], plain_ms=t["plain"], layer_norm_linear_bf16_ms=t["control"],
                   ms_b2b=b2b["kernel"], layer_norm_linear_bf16_ms_b2b=b2b["control"],
                   bound_ms=bound, bound_by=by, bound_share=bound / t["kernel"],
                   kernel_tflops=2 * m_rows * k * n / t["kernel"] / 1e9)  # fmt: skip
        print(f"[3 kernels] ln_dense {json.dumps(row)} on {card}")
        if not rel_err <= KERNEL_TOL:
            _fail(f"ln_dense {site}: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}")
        results["ln_dense"].append(row)
        del x, w, got, want
    torch.cuda.empty_cache()
    return results


def _identity_readback(lnd, x, g, beta, s_x):
    """The int8 activations the ``ln_quant_dense`` kernel forms, read back
    through an identity weight (w_scale 1, no bias): out = q·s_x/127 in
    bf16, whose 8-bit mantissa holds |q| ≤ 127 to within 0.25 of a step."""
    import torch

    k = x.shape[1]
    eye = torch.eye(k, device=x.device, dtype=torch.int8)
    out = lnd.ln_quant_dense(x, g, beta, s_x, eye, torch.ones(k, device=x.device))
    return torch.round(out.float() / (s_x / 127.0)).to(torch.int32)


def phase_quant_kernels(card: str) -> dict:
    """3d: ``ln_quant_dense`` against its plain version at the sites of
    ``LN_SITES`` and ragged shapes; its int8 activations against the plain
    quantization; times beside ``torch._int_mm`` on the pre-quantized
    activation (cuBLASLt's int8 GEMM, no LayerNorm) and the bf16
    ``ln_dense`` kernel at the same shape."""
    import torch

    from stamp_tpu_torch.models.vit_image import _quantized_dense_site
    from stamp_tpu_torch.ops import ln_dense as lnd

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(4)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=gen)).to(torch.bfloat16)

    rows = []
    ragged = tuple((1000, 272, n, f"ragged N={n}") for n in (200, 8, 1))  # K: a tail of 16 past two 128-wide blocks
    for rows_m, k, n, site in LN_SITES + ragged:
        x = randn(rows_m, k)
        g = (1.0 + 0.1 * torch.randn(k, device=dev, generator=gen)).to(torch.bfloat16)
        beta = randn(k, scale=0.1)
        w = randn(n, k, scale=k**-0.5)
        bias = randn(n, scale=0.1)
        quant = _quantized_dense_site(w, None)
        wq, ws = quant["weight_q"], quant["w_scale"]
        # the calibrated scale: max |LN(x)| of this batch, with 5% headroom
        y = lnd.layer_norm_f32(x, g, beta, 1e-6).to(torch.bfloat16)
        s_x = y.abs().max().float().clamp_min(1e-6) * 1.05
        xq = lnd.quantize_activation(y, s_x)
        del y
        args = (x, g, beta, s_x, wq, ws, bias)
        got = lnd.ln_quant_dense(*args)
        want = lnd.ln_quant_dense_reference(*args)
        torch.cuda.synchronize()
        abs_err, rel_err = _error(got, want)
        step = (_identity_readback(lnd, x, g, beta, s_x) - xq.int()).abs()
        row = dict(site=site, m=rows_m, k=k, n=n, max_abs_err=abs_err, rel_err=rel_err,
                   q_share_one_step=(step == 1).float().mean().item(), q_max_step=step.max().item())  # fmt: skip
        del got, want, step
        if not rel_err <= KERNEL_TOL or row["q_max_step"] > 1:
            _fail(f"ln_quant_dense {row}: beyond {KERNEL_TOL}, or a quantized value off by more than one step")
        if not site.startswith("ragged"):
            kernel = lambda: lnd.ln_quant_dense(*args)  # noqa: E731
            control = lambda: torch._int_mm(xq, wq.t())  # noqa: E731
            t = _compare_timed(kernel, lambda: lnd.ln_quant_dense_reference(*args), control)
            b2b = _compare_timed(kernel, None, control, reps=B2B_REPS)
            t_bf16 = statistics.median(_time_ms(lambda: lnd.ln_dense(x, g, beta, w, bias), 5))
            if k % 16:  # the wrapper's pad of W_q to 16-byte rows, inside ms
                row["pad_ms"] = statistics.median(_time_ms(lambda: torch.nn.functional.pad(wq, (0, -k % 16)), 5))
            m = rows_m
            nbytes = 2 * m * k + k * n + 4 * n + 2 * n + 4 * k + 2 * m * n  # x, W_q, w_scale, bias, γβ in; out
            bound, by = _bound(nbytes, {"int8": 2 * m * k * n})
            row |= dict(ms=t["kernel"], plain_ms=t["plain"], int_mm_ms=t["control"], ln_dense_bf16_ms=t_bf16,
                        ms_b2b=b2b["kernel"], int_mm_ms_b2b=b2b["control"], bound_ms=bound, bound_by=by,
                        bound_share=bound / t["kernel"], kernel_tops=2 * m * k * n / t["kernel"] / 1e9)  # fmt: skip
        print(f"[3d quant] ln_quant_dense {json.dumps(row)} on {card}")
        rows.append(row)
        del x, w, wq, xq, args
    torch.cuda.empty_cache()
    return {"ln_quant_dense": rows}


def _alibi2d_inputs(gen, bh: int, n: int, d: int):
    """q, k, v ~ N(0, 1) f32; the integer grid positions of a slide-shaped
    (elliptical) tissue region, CLS at (0, 0) as TITAN places it; TITAN's
    slopes for bh heads."""
    import torch

    from stamp_tpu_torch.models.slide_encoders import alibi_slopes

    dev = torch.device("cuda:0")
    q, k, v = (torch.randn(bh, n, d, device=dev, generator=gen) for _ in range(3))
    grid = _tissue_grid(max(n - 1, 1))[: n - 1]
    coords = torch.cat([torch.zeros(1, 2), torch.from_numpy(grid).float()]).to(dev)
    slopes = torch.from_numpy(alibi_slopes(bh)).to(dev)
    return q, k, v, coords.expand(bh, n, 2).contiguous(), slopes


def _tissue_grid(n: int):
    """[n, 2] int64 grid cells of an elliptical region (1.6:1), row by row."""
    import numpy as np

    a = math.sqrt(1.6 * n / math.pi) + 2
    b = a / 1.6
    ys, xs = np.mgrid[0 : int(2 * b) + 1, 0 : int(2 * a) + 1]
    inside = ((xs - a) / a) ** 2 + ((ys - b) / b) ** 2 <= 1.0
    cells = np.stack([xs[inside], ys[inside]], axis=1).astype(np.int64)
    if len(cells) < n:
        raise ValueError(f"ellipse holds {len(cells)} cells, {n} asked for")
    return cells[:n]


def phase_alibi2d_kernels(card: str) -> dict:
    """3e: ``flash_alibi2d_mha`` against its plain version at TITAN's
    shapes ([12, 4097 | 16385 | 20001, 64], the last a patient of two
    10,000-tile slides) and at ragged small ones, N < 64 and N = 1 (there
    also without the CLS exemption); times with the TFLOP/s and the share
    of the bound, beside SDPA f32 with the [12, N, N] bias materialised
    (built outside the timed region; up to N = 16,385)."""
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.ops import flash_attention as attn

    gen = torch.Generator(device="cuda:0").manual_seed(5)
    rows = []
    shapes = ((3, 1, 64), (12, 37, 64), (12, 300, 64), (2, 130, 32), (2, 200, 128), (12, 4097, 64), (12, 16385, 64),
              (12, 20001, 64))  # fmt: skip
    for bh, n, d in shapes:
        q, k, v, coords, slopes = _alibi2d_inputs(gen, bh, n, d)
        errs = []
        for exempt in (True, False) if n < 4097 else (True,):
            got = attn.flash_alibi2d_mha(q, k, v, coords, slopes, exempt_first=exempt)
            want = attn.flash_alibi2d_mha_reference(q, k, v, coords, slopes, exempt_first=exempt)
            torch.cuda.synchronize()
            errs.append(_error(got, want))
            del want
        abs_err, rel_err = max(errs, key=lambda e: e[1])
        row = dict(shape=[bh, n, d], max_abs_err=abs_err, rel_err=rel_err)
        if not rel_err <= FLASH_TOL:
            _fail(f"flash_alibi2d_mha {row}: beyond {FLASH_TOL}")
        if n >= 4097:
            io_bytes = 4 * q.numel() * 4 + coords.numel() * 4 + slopes.numel() * 4  # q k v in, out; coords; slopes
            flops = 4 * d * bh * n * n
            bound, by = _bound(io_bytes, {"tf32": flops})
            sdpa = None
            if n <= 16385:
                bias = attn._pairwise_distances(coords, coords).mul_(-slopes[:, None, None])
                bias[:, 0, :] = 0.0
                bias[:, :, 0] = 0.0

                def sdpa(q=q, k=k, v=v, bias=bias):
                    return F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=bias[None])[0]

            t = _compare_timed(lambda: attn.flash_alibi2d_mha(q, k, v, coords, slopes),
                               lambda: attn.flash_alibi2d_mha_reference(q, k, v, coords, slopes), sdpa, iters=3)  # fmt: skip
            row |= dict(ms=t["kernel"], plain_ms=t["plain"], bound_ms=bound, bound_by=by, bound_share=bound / t["kernel"],
                        kernel_tflops=flops / t["kernel"] / 1e9)  # fmt: skip
            if sdpa is not None:
                row |= dict(sdpa_f32_dense_bias_ms=t["control"], sdpa_rel_diff=_error(sdpa(), got)[1])
                del bias
        print(f"[3e alibi2d] flash_alibi2d_mha {json.dumps(row)} on {card}")
        rows.append(row)
        del q, k, v, got
        torch.cuda.empty_cache()
    return {"flash_alibi2d_mha": rows}


def _write_slide(path: Path) -> None:
    """3072×3072 px of texture at 1 µm/px: 12×12 tissue tiles of 256 µm."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(0)
    arr = rng.integers(60, 200, (3072, 3072, 3), dtype=np.uint8)
    Image.fromarray(arr).save(
        path, format="TIFF", compression="tiff_lzw", resolution=10000.0, resolution_unit=3
    )


def phase_main_path(card: str) -> dict:
    import numpy as np
    import yaml

    from stamp_tpu_torch.io.h5 import read_h5
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd
    from stamp_tpu_torch.preprocessing import extract

    slides = WORK / "slides"
    out = WORK / "features"
    slides.mkdir(parents=True)
    _write_slide(slides / "synthetic.tif")
    config = WORK / "config.yaml"
    config.write_text(
        yaml.safe_dump(
            {
                "preprocessing": {
                    "output_dir": str(out),
                    "wsi_dir": str(slides),
                    "extractor": "uni2",
                    "device": "cuda",
                    "generate_hash": False,
                    # the PIL reader (no native build needed) sees no MPP tag
                    "default_slide_mpp": 1.0,
                    "max_workers": 4,
                }
            }
        )
    )
    os.environ["STAMP_RANDOM_WEIGHTS"] = "1"
    os.environ["STAMP_EXTRACT_BATCH"] = str(BATCH)

    attn.LAUNCHES = attn.LONG_LAUNCHES = 0
    lnd.LAUNCHES = 0
    t0 = time.perf_counter()
    _staged_cli(["-c", str(config), "preprocess"])  # exits non-zero on failure
    wall = time.perf_counter() - t0
    launches = {"fused_qkv_mha": attn.LAUNCHES, "ln_dense": lnd.LAUNCHES}
    if attn.LONG_LAUNCHES:  # UNI2's 265 tokens are the one-pass kernel's
        _fail(f"UNI2 launched the two-pass attention kernel {attn.LONG_LAUNCHES} times")

    h5s = sorted(out.rglob("*.h5"))
    if len(h5s) != 1:
        _fail(f"expected one h5 under {out}, found {h5s}")
    datasets, attrs = read_h5(h5s[0])  # this machine may lack h5py
    feats, coords, extractor_attr = datasets["feats"], datasets["coords"], attrs["extractor"]
    n = len(coords)
    if feats.dtype != np.float16 or feats.shape != (n, 1536):
        _fail(f"feats {feats.dtype} {feats.shape}, expected float16 [{n}, 1536]")
    if n <= 2 * BATCH:
        _fail(f"{n} tiles: need more than {2 * BATCH} so that three batches run")
    if not np.isfinite(feats).all() or not np.abs(feats).max() > 0:
        _fail("features are not finite or all zero")
    if extractor_attr != "uni2":
        _fail(f"extractor attr {extractor_attr!r}")
    batches = math.ceil(n / BATCH)
    expected = {"fused_qkv_mha": 24 * batches, "ln_dense": 72 * batches}
    if launches != expected:
        _fail(f"kernel launches {launches}, expected {expected} for {batches} batches")
    # the driver's stage timer, which --profile switched on for this run
    forward_s = extract.profiling.timer.seconds["extract/forward"]
    row = dict(tiles=n, batches=batches, launches=launches, wall_s=wall,
               forward_s=forward_s, forward_tiles_per_s=n / forward_s)  # fmt: skip
    print(f"[4 main path] {json.dumps(row)} on {card}")
    return row


def _sorted_by_coords(datasets) -> tuple:
    import numpy as np

    coords = datasets["coords"]
    order = np.lexsort((coords[:, 1], coords[:, 0]))
    return datasets["feats"][order].astype(np.float32), coords[order]


def phase_int8_main_path(card: str, bf16_row: dict) -> dict:
    """4b: ``preprocess`` with ``extractor_precision: int8`` through the CLI
    on phase 4's slide: the ``-int8`` directory, the ``precision``
    attribute, 72 ``ln_quant_dense`` launches per int8 forward (none in the
    calibration forward), per-tile cosine against phase 4's bf16 features;
    then the steady-state int8 and bf16 forward rates at batch 64, and the
    int8 model on the kernel path against its plain path."""
    import numpy as np
    import torch
    import yaml

    from stamp_tpu_torch.io.h5 import read_h5
    from stamp_tpu_torch.models import vit_image
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd
    from stamp_tpu_torch.preprocessing import extract
    from stamp_tpu_torch.preprocessing.extractor import set_int8_extraction
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    config = yaml.safe_load((WORK / "config.yaml").read_text())
    out = WORK / "features_int8"
    config["preprocessing"] |= {"output_dir": str(out), "extractor_precision": "int8"}
    (WORK / "config_int8.yaml").write_text(yaml.safe_dump(config))

    attn.LAUNCHES = attn.LONG_LAUNCHES = lnd.LAUNCHES = lnd.QUANT_LAUNCHES = 0
    t0 = time.perf_counter()
    _staged_cli(["-c", str(WORK / "config_int8.yaml"), "preprocess"])  # exits non-zero on failure
    wall = time.perf_counter() - t0
    launches = {"ln_quant_dense": lnd.QUANT_LAUNCHES, "ln_dense": lnd.LAUNCHES, "fused_qkv_mha": attn.LAUNCHES}
    if attn.LONG_LAUNCHES:
        _fail(f"int8 UNI2 launched the two-pass attention kernel {attn.LONG_LAUNCHES} times")
    h5s = sorted(out.rglob("*.h5"))
    if len(h5s) != 1 or h5s[0].parent.name != "uni2-int8":
        _fail(f"expected one h5 under {out / 'uni2-int8'}, found {h5s}")
    datasets, attrs = read_h5(h5s[0])
    feats, coords = _sorted_by_coords(datasets)
    bf16, bf16_coords = _sorted_by_coords(read_h5(next((WORK / "features").rglob("*.h5")))[0])
    n = len(coords)
    batches = math.ceil(n / BATCH)
    # the calibration forward (observe mode) runs attention but no fused LN
    expected = {"ln_quant_dense": 72 * batches, "ln_dense": 0, "fused_qkv_mha": 24 * (batches + 1)}
    if attrs.get("precision") != "int8" or launches != expected:
        _fail(f"precision {attrs.get('precision')!r}, launches {launches}; expected 'int8', {expected}")
    if not np.array_equal(coords, bf16_coords) or not np.isfinite(feats).all():
        _fail("int8 features: other tiles than phase 4's, or not finite")
    cos = (feats * bf16).sum(1) / (np.linalg.norm(feats, axis=1) * np.linalg.norm(bf16, axis=1))
    if not cos.min() >= INT8_COSINE_MIN:
        _fail(f"int8 against bf16 features: min per-tile cosine {cos.min()} < {INT8_COSINE_MIN}")
    forward_s = extract.profiling.timer.seconds["extract/forward"]
    row = dict(tiles=n, batches=batches, launches=launches, wall_s=wall, forward_s=forward_s,
               forward_tiles_per_s=n / forward_s, bf16_forward_tiles_per_s=bf16_row["forward_tiles_per_s"],
               min_cosine_vs_bf16=float(cos.min()), mean_cosine_vs_bf16=float(cos.mean()))  # fmt: skip
    print(f"[4b int8 main path] {json.dumps(row)} on {card}")

    # steady state at batch 64 (the first int8 forward calibrates), in turns
    dev = torch.device("cuda:0")
    tiles = np.random.default_rng(1).integers(60, 200, (BATCH, 224, 224, 3), dtype=np.uint8)
    set_int8_extraction(True)
    try:
        ext8 = resolve_extractor("uni2", dev)
    finally:
        set_int8_extraction(None)
    ext16 = resolve_extractor("uni2", dev)
    ext8.forward(tiles)
    t = _compare_timed(lambda: ext8.forward(tiles), lambda: ext16.forward(tiles), iters=3)
    steady = dict(int8_ms=t["kernel"], int8_tiles_per_s=BATCH / t["kernel"] * 1e3,
                  bf16_ms=t["plain"], bf16_tiles_per_s=BATCH / t["plain"] * 1e3)  # fmt: skip
    _profile_forward(card, f"UNI2 int8 forward, batch {BATCH}", lambda: (None, 1e3 * _timed(lambda: ext8.forward(tiles))),
                     tag="4b int8 main path")  # fmt: skip
    # the int8 model on its kernel path against its plain path (8 tiles)
    got = ext8.forward(tiles[:8])
    vit_image.ln_quant_dense = lnd.ln_quant_dense_reference
    try:
        want = ext8.forward(tiles[:8])
    finally:
        vit_image.ln_quant_dense = lnd.ln_quant_dense
    cos8 = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1).min().item()
    steady |= dict(int8_kernel_vs_plain_min_cosine=cos8, int8_kernel_vs_plain_max_abs_diff=(got - want).abs().max().item())
    print(f"[4b int8 main path] steady-state forward, batch {BATCH}: {json.dumps(steady)} on {card}")
    if not cos8 >= COSINE_MIN:
        _fail(f"int8 whole model, kernel against plain path: min cosine {cos8} < {COSINE_MIN}")
    del ext8, ext16
    torch.cuda.empty_cache()
    return row | steady


def phase_whole_model(card: str) -> None:
    import numpy as np
    import torch

    from stamp_tpu_torch.models import vit_image
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1)
    tiles = rng.integers(60, 200, (BATCH, 224, 224, 3), dtype=np.uint8)

    def plain_path(fn, *args):
        with vit_image.plain_kernels():
            return fn(*args)

    def check(what: str, got, want) -> None:
        cos = torch.nn.functional.cosine_similarity(got.double(), want.double(), dim=-1)
        print(
            f"[5 whole model] {what}, 8 tiles: max|Δ| {(got - want).abs().max().item():.6g}, "
            f"max|ref| {want.abs().max().item():.6g}, min cosine {cos.min().item():.6f} on {card}"
        )
        if not cos.min().item() >= COSINE_MIN:
            _fail(f"whole model ({what}): min cosine {cos.min().item()} < {COSINE_MIN}")

    # (a) the extractor of phase 4: STAMP_RANDOM_WEIGHTS=1, seed 0
    extractor = resolve_extractor("uni2", dev)
    check("UNI2 as in phase 4", extractor.forward(tiles[:8]), plain_path(extractor.forward, tiles[:8]))
    t = _compare_timed(lambda: extractor.forward(tiles), lambda: plain_path(extractor.forward, tiles), iters=3)
    print(
        f"[5 whole model] steady-state forward, batch {BATCH}: kernel path "
        f"{t['kernel']:.4f} ms ({BATCH / t['kernel'] * 1e3:.2f} tiles/s), plain path "
        f"{t['plain']:.2f} ms ({BATCH / t['plain'] * 1e3:.1f} tiles/s) on {card}"
    )
    _profile_forward(card, f"UNI2 bf16 forward, batch {BATCH}", lambda: (None, 1e3 * _timed(lambda: extractor.forward(tiles))),
                     tag="5 whole model")  # fmt: skip
    del extractor

    # (b) the same random draw with LayerScale γ = 1: at γ = 1e-5 the blocks
    # barely move the residual stream, so (a) alone would hide a block fault
    cfg = vit_image.VIT_CONFIGS["uni2"]
    with torch.device("meta"):
        model = vit_image.ImageViT(cfg)
    model.to_empty(device="cpu")
    vit_image.init_random_weights_(model, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for block in model.blocks:
            block.ls1.gamma.fill_(1.0)
            block.ls2.gamma.fill_(1.0)
    model = model.to(device=dev, dtype=torch.bfloat16).eval()
    mean = torch.tensor(cfg.mean, device=dev) * 255.0
    std = torch.tensor(cfg.std, device=dev) * 255.0
    x = ((torch.from_numpy(tiles[:8]).to(dev).float() - mean) / std).to(torch.bfloat16)
    with torch.inference_mode():
        check("UNI2, LayerScale γ = 1", model(x).float(), plain_path(model, x).float())


def _op_seconds(kind: str, n: float) -> float:
    """Least seconds for n operations of one kind.  "fp32_dot" is a product
    that must stay f32-accurate: at the f32 rate, or as three TF32 products
    (hi·hi, hi·lo, lo·hi of a TF32 split, per-tile f32 sums: what the port's
    kernels run), whichever is faster."""
    if kind == "fp32_dot":
        return min(n / PEAK_FLOPS["fp32"], 3 * n / PEAK_FLOPS["tf32"])
    return n / PEAK_FLOPS[kind]


def _bound(nbytes: float, flops: dict[str, float]) -> tuple[float, str]:
    """(least ms the card could take, what bounds it): the bytes over the
    memory rate against the operations over the peak rate of their type
    (summed over types)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(_op_seconds(kind, n) for kind, n in flops.items()) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bounds(nbytes: float, flops: dict[str, float]) -> dict:
    """bound_ms and bound_by (the f32-accurate product at the better of its
    two rates, ``_op_seconds``), and bound_f32_ms: the same with that
    product at the f32 rate alone."""
    bound, by = _bound(nbytes, flops)
    f32 = {("fp32" if kind == "fp32_dot" else kind): n for kind, n in flops.items()}
    return dict(bound_ms=bound, bound_by=by, bound_f32_ms=_bound(nbytes, f32)[0])


def _mean_pairwise_distance(coords) -> float:
    """Mean Euclidean distance over all ordered pairs of [N, 2] coordinates
    on the card, in row blocks, summed in f64."""
    import torch

    c = coords.double()
    total = sum(torch.cdist(c[i : i + 4096], c).sum().item() for i in range(0, len(c), 4096))
    return total / len(c) ** 2


def _flash_inputs(gen, bh: int, t: int, d: int):
    """q, k, v ~ N(0, 1) f32; the last 40% of keys masked (as bucket padding
    leaves them); coordinates on a 256 µm grid; dist_scale = 1 / the mean
    pairwise distance of the valid tiles, so that the post-softmax bias is
    not 10⁴× the softmax branch (as with running_mean = 1)."""
    import torch

    dev = torch.device("cuda:0")
    q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen) for _ in range(3))
    n_valid = max(1, t - (2 * t) // 5)
    key_mask = (torch.arange(t, device=dev) < n_valid).expand(bh, t).contiguous()
    side = math.isqrt(n_valid - 1) + 1
    idx = torch.arange(t, device=dev)
    grid = torch.stack([idx % side, idx // side], dim=-1).float() * 256.0
    coords = grid.expand(bh, t, 2).contiguous()
    mean = _mean_pairwise_distance(grid[:n_valid]) if n_valid > 1 else 1.0
    dist_scale = torch.full((bh,), 1.0 / max(mean, 1.0), device=dev)
    return q, k, v, key_mask, coords, dist_scale


# the forward's kernels as torch.profiler names them (the ALiBi forward runs
# the distance-weighted sum's three first)
_FWD_KERNELS = {"prepass": "flash_fwd_prepass", "lists": "flash_fwd_lists", "attention": "flash_fwd_kernel"}
_DWS_KERNELS = {"dws_prepass": "dws_prepass", "dws_lists": "dws_lists", "dws": "dist_weighted_sum_kernel"}


def _fwd_executed_flops(mask, tq: int, d: int) -> float:
    """Operations the attention kernel executes for q·kᵀ and P·V: each block
    of 128 queries (the grid covers Tq rounded up to 128) over the listed
    key tiles (64 keys, 32 at d = 128) that hold a valid key; a sequence
    with no valid key keeps every tile."""
    import torch

    tile = 32 if d == 128 else 64
    bh, tk = mask.shape
    pad = torch.zeros(bh, -tk % tile, dtype=torch.bool, device=mask.device)
    keys = mask | ~mask.any(dim=-1, keepdim=True)
    listed = torch.cat([keys, pad], dim=1).view(bh, -1, tile).any(dim=-1).sum().item()
    return float(listed * tile * -(-tq // 128) * 128 * 4 * d)


# (bh, tq, tk, d, key mask) of the cases phase 3b adds for the forward's tile
# skipping; inputs from tests/flash_bwd_util.py ("holes": whole masked 64-
# and 128-key tiles and 30% of the other keys; "one-empty": no valid key in
# sequence 1), and "none": no valid key in any sequence, at a ragged T
FWD_SKIP_CASES = (
    (8, 4097, 4097, 64, "holes"),
    (4, 700, 517, 64, "one-empty"),
    (3, 333, 700, 128, "holes"),
    (3, 517, 300, 32, "one-empty"),
    (2, 333, 333, 64, "none"),
)


def _fwd_skip_case(card: str, gen, bh, tq, tk, d, mask_kind) -> dict:
    """Both forward wrappers on one skip case against their plain versions:
    FLASH_TOL (dacc DACC_TOL) over the sequences with a valid key and over
    those without (whose lse is near −1e30), bitwise-equal reruns."""
    import torch
    from flash_bwd_util import skip_case_inputs

    from stamp_tpu_torch.ops import flash_attention as attn

    kind = "suffix" if mask_kind == "none" else mask_kind
    q, k, v, mask, _, coords_q, coords_k, ds = skip_case_inputs(gen, bh, tq, tk, d, kind, "dense")
    if mask_kind == "none":
        mask = torch.zeros_like(mask)
    has_valid = mask.any(dim=1)
    plain_sm, plain_dacc, plain_lse = attn._flash_alibi_forward_reference(q, k, v, coords_q, coords_k, mask)
    calls = {
        "flash_mha": (lambda: attn._flash_forward(q, k, v, mask), (plain_sm, plain_lse), (FLASH_TOL, FLASH_TOL)),
        "flash_alibi_mha": (lambda: attn._flash_alibi_forward(q, k, v, coords_q, coords_k, ds, mask),
                            (plain_sm - ds[:, None, None] * plain_dacc, plain_sm, plain_dacc, plain_lse),
                            (FLASH_TOL, FLASH_TOL, DACC_TOL, FLASH_TOL)),
    }  # fmt: skip
    rows = {}
    for name, (kernel, want, tols) in calls.items():
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        errs = [_error(a[rows_], b[rows_])[1] for a, b in zip(got, want) for rows_ in (has_valid, ~has_valid)
                if rows_.any()]  # fmt: skip
        limits = [tol for tol in tols for rows_ in (has_valid, ~has_valid) if rows_.any()]
        row = dict(case=f"{mask_kind} mask", shape=[bh, tq, tk, d], sequences_with_no_valid_key=int((~has_valid).sum()),
                   max_abs_err=max((a - b).abs().max().item() for a, b in zip(got, want)), max_rel_err=max(errs))  # fmt: skip
        if not all(e <= tol for e, tol in zip(errs, limits)):
            _fail(f"{name} {row}: beyond {FLASH_TOL} (dacc {DACC_TOL}): {errs}")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            _fail(f"{name} {row}: two runs differ")
        print(f"[3b flash] {name} {json.dumps(row)} on {card}")
        rows[name] = row
    return rows


def phase_flash_kernels(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.ops import flash_attention as attn

    gen = torch.Generator(device="cuda:0").manual_seed(1)
    rows: dict = {"flash_mha": [], "flash_alibi_mha": []}
    shapes = ((3, 1, 64), (3, 300, 64), (2, 130, 32), (2, 200, 128), (8, 4097, 64), (8, 16385, 64))
    for bh, t, d in shapes:
        q, k, v, mask, coords, ds = _flash_inputs(gen, bh, t, d)
        # pairs the function must score: every query against every valid key
        pairs = t * mask.sum().item()
        io_bytes = 4 * q.numel() * 4 + mask.numel()  # q, k, v in, out out (f32); mask

        out, lse = attn._flash_forward(q, k, v, mask)
        want, want_lse = attn._flash_forward_reference(q, k, v, mask)
        torch.cuda.synchronize()
        abs_err, rel_err = _error(out, want)
        _, rel_lse = _error(lse, want_lse)
        row = dict(shape=[bh, t, d], max_abs_err=abs_err, rel_err=rel_err, lse_rel_err=rel_lse)
        if not (rel_err <= FLASH_TOL and rel_lse <= FLASH_TOL):
            _fail(f"flash_mha {row}: beyond {FLASH_TOL}")
        del want, want_lse
        if t >= 4097:
            bound, by = _bound(io_bytes, {"tf32": 4 * d * pairs})
            sdpa_mask = mask[:, None, None, :]

            def sdpa(q=q, k=k, v=v, m=sdpa_mask):
                return F.scaled_dot_product_attention(q[:, None], k[:, None], v[:, None], attn_mask=m)[:, 0]

            tm = _compare_timed(
                lambda: attn.flash_mha(q, k, v, mask), lambda: attn.flash_mha_reference(q, k, v, mask), sdpa, iters=3
            )
            _, rel_sdpa = _error(sdpa(), out)
            row |= dict(ms=tm["kernel"], plain_ms=tm["plain"], library_ms=tm["control"],
                        sdpa_rel_diff=rel_sdpa, bound_ms=bound, bound_by=by, bound_share=bound / tm["kernel"],
                        tflops=4 * d * pairs / tm["kernel"] / 1e9)  # fmt: skip
            split = _device_split(lambda: attn.flash_mha(q, k, v, mask), _FWD_KERNELS)
            executed = _fwd_executed_flops(mask, t, d)
            row |= split | dict(executed_tflops=executed / split["attention_ms"] / 1e9)
        print(f"[3b flash] flash_mha {json.dumps(row)} on {card}")
        rows["flash_mha"].append(row)

        out, out_sm, dacc, lse = attn._flash_alibi_forward(q, k, v, coords, coords, ds, mask)
        want_sm, want_dacc, want_lse = attn._flash_alibi_forward_reference(q, k, v, coords, coords, mask)
        want = want_sm - ds[:, None, None] * want_dacc
        torch.cuda.synchronize()
        abs_err, rel_err = _error(out, want)
        errs = {
            "softmax_rel_err": _error(out_sm, want_sm)[1],
            "dacc_rel_err": _error(dacc, want_dacc)[1],
            "lse_rel_err": _error(lse, want_lse)[1],
        }
        if t >= 4097:  # both against an f64 D·V of the first sequence
            c = coords[0].double()
            dist64 = torch.cdist(c, c).masked_fill_(~mask[0][None, :], 0.0)
            dacc64 = dist64 @ v[0].double()
            errs |= {"dacc_rel_err_f64": _error(dacc[0], dacc64)[1],
                     "plain_dacc_rel_err_f64": _error(want_dacc[0], dacc64)[1]}  # fmt: skip
            del dist64, dacc64
        row = dict(shape=[bh, t, d], max_abs_err=abs_err, rel_err=rel_err, **errs)
        if not (max(rel_err, errs["softmax_rel_err"], errs["lse_rel_err"]) <= FLASH_TOL
                and errs["dacc_rel_err"] <= DACC_TOL):  # fmt: skip
            _fail(f"flash_alibi_mha {row}: beyond {FLASH_TOL} (dacc {DACC_TOL})")
        del want, want_sm, want_dacc, want_lse
        if t >= 4097:
            alibi_bytes = io_bytes + 2 * coords.numel() * 4 + ds.numel() * 4
            bounds = _bounds(alibi_bytes, {"tf32": 4 * d * pairs, "fp32_dot": 2 * d * pairs})
            args = (q, k, v, coords, coords, ds, mask)
            tm = _compare_timed(
                lambda: attn.flash_alibi_mha(*args), lambda: attn.flash_alibi_mha_reference(*args), iters=3
            )
            row |= dict(ms=tm["kernel"], plain_ms=tm["plain"], library_ms=None, **bounds,
                        bound_share=bounds["bound_ms"] / tm["kernel"],
                        tflops=(4 + 3 * 2) * d * pairs / tm["kernel"] / 1e9)  # fmt: skip
            row |= _device_split(lambda: attn.flash_alibi_mha(*args), _FWD_KERNELS | _DWS_KERNELS)
        print(f"[3b flash] flash_alibi_mha {json.dumps(row)} on {card}")
        rows["flash_alibi_mha"].append(row)
        del q, k, v, out, out_sm, dacc, lse
        torch.cuda.empty_cache()

    for case in FWD_SKIP_CASES:
        for name, row in _fwd_skip_case(card, gen, *case).items():
            rows[name].append(row)
        torch.cuda.empty_cache()

    # a head width with no instance of its own: the public wrappers pad it
    # to 64 and pass 48^-1/2; the plain versions run at the true width
    q, k, v, mask, coords, ds = _flash_inputs(gen, 8, 4097, 48)
    for name, got, want in (
        ("flash_mha", attn.flash_mha(q, k, v, mask), attn.flash_mha_reference(q, k, v, mask)),
        ("flash_alibi_mha", attn.flash_alibi_mha(q, k, v, coords, coords, ds, mask),
         attn.flash_alibi_mha_reference(q, k, v, coords, coords, ds, mask)),
    ):  # fmt: skip
        torch.cuda.synchronize()
        abs_err, rel_err = _error(got, want)
        row = dict(shape=[8, 4097, 48], padded_to=attn.flash_width(name, 48), max_abs_err=abs_err, rel_err=rel_err)
        print(f"[3b flash] {name} {json.dumps(row)} on {card}")
        if not (got.shape == want.shape and rel_err <= FLASH_TOL):
            _fail(f"{name} at head width 48 {row}: beyond {FLASH_TOL}")
        rows[name].append(row)
    del q, k, v, got, want
    torch.cuda.empty_cache()
    return rows


def _write_deploy_cohort(root: Path) -> tuple[list[tuple[str, int]], float]:
    """Four patients' UNI2 feature files (fp16, the port's own writer),
    slide.csv and a two-class clini.csv; returns the patients and the
    cohort's mean pairwise tile distance."""
    import numpy as np
    import pandas as pd
    import torch

    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(2)
    features = root / "features"
    patients, weighted, n_pairs = [], 0.0, 0
    for i, n in enumerate(DEPLOY_TILES):
        side = math.isqrt(n - 1) + 1
        idx = np.arange(n)
        coords = (np.stack([idx % side, idx // side], axis=1) * 256.0).astype(np.float32)
        feats = rng.standard_normal((n, UNI2_DIM), dtype=np.float32).astype(np.float16)
        name = f"patient-{i}"
        write_tile_feats_atomic(
            output_path=features / f"{name}.h5", feats=feats, coords_um=coords, extractor_id="uni2",
            tile_size_um=256.0, tile_size_px=224, code_hash="chip-smoke",
        )  # fmt: skip
        weighted += _mean_pairwise_distance(torch.from_numpy(coords).cuda()) * n * n
        n_pairs += n * n
        patients.append((name, n))
    pd.DataFrame({"FILENAME": [f"{p}.h5" for p, _ in patients], "PATIENT": [p for p, _ in patients]}).to_csv(
        root / "slide.csv", index=False
    )
    labels = ["high", "low", "low", "high"]
    pd.DataFrame({"PATIENT": [p for p, _ in patients], "isup": labels}).to_csv(root / "clini.csv", index=False)
    return patients, weighted / n_pairs


def phase_deploy(card: str) -> dict:
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from stamp_tpu_torch.modeling.checkpoint import save_checkpoint
    from stamp_tpu_torch.modeling.config import VitModelParams
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.modeling.tasks import LitTileClassifier
    from stamp_tpu_torch.models import vision_transformer as vit
    from stamp_tpu_torch.ops import flash_attention as attn

    root = WORK / "deploy"
    patients, mean_dist = _write_deploy_cohort(root)
    checkpoints = []
    for use_alibi in (False, True):
        # the repo's default MIL ViT width: dim_model 512, 8 heads of 64, 2 layers
        model = LitTileClassifier(
            model_class=vit.VisionTransformer, ground_truth_label="isup", categories=["high", "low"],
            category_weights=[1.0, 1.0], dim_input=UNI2_DIM, model_name="vit",
            **VitModelParams(use_alibi=use_alibi).model_dump(),
        )  # fmt: skip
        vit.init_random_weights_(model.module, torch.Generator().manual_seed(10 + use_alibi))
        if use_alibi:
            for name, buf in model.module.named_buffers():
                if name.endswith("running_mean"):
                    buf.fill_(mean_dist)
        path = root / ("vit-alibi.ckpt" if use_alibi else "vit.ckpt")
        save_checkpoint(path, hyper_parameters=model.checkpoint_hparams(),
                        variables=vit.variables_to_jax(model.module.state_dict()))  # fmt: skip
        checkpoints.append(path)
    out = root / "out"
    config = root / "config.yaml"
    config.write_text(yaml.safe_dump({"deployment": {
        "output_dir": str(out), "checkpoint_paths": [str(c) for c in checkpoints],
        "clini_table": str(root / "clini.csv"), "slide_table": str(root / "slide.csv"),
        "feature_dir": str(root / "features"), "ground_truth_label": "isup", "accelerator": "cuda",
    }}))  # fmt: skip

    attn.FLASH_MHA_LAUNCHES = 0
    attn.FLASH_ALIBI_MHA_LAUNCHES = 0
    t0 = time.perf_counter()
    _staged_cli(["-c", str(config), "deploy"])  # exits non-zero on failure
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_mha": attn.FLASH_MHA_LAUNCHES, "flash_alibi_mha": attn.FLASH_ALIBI_MHA_LAUNCHES}
    expected = MIL_LAYERS * len(patients)
    if launches != {"flash_mha": expected, "flash_alibi_mha": expected}:
        _fail(f"flash launches {launches}, expected {expected} each ({MIL_LAYERS} layers × {len(patients)} patients)")

    columns = ["PATIENT", "isup", "pred", "isup_high", "isup_low", "loss"]
    csv = {}
    for name in ("patient-preds-0.csv", "patient-preds-1.csv", "patient-preds_95_confidence_interval.csv"):
        df = pd.read_csv(out / name)
        probs = df[["isup_high", "isup_low"]].to_numpy()
        if list(df.columns) != columns or len(df) != len(patients):
            _fail(f"{name}: columns {list(df.columns)}, {len(df)} rows; expected {columns}, {len(patients)}")
        if not np.isfinite(probs).all() or not np.allclose(probs.sum(axis=1), 1.0, atol=1e-5):
            _fail(f"{name}: probabilities not finite or not summing to 1: {probs}")
        csv[name] = df.set_index("PATIENT")

    # per patient: the forward on the kernel path (timed) against the CSVs
    # the main path wrote, and against the plain path on the card for T ≤ 16,385
    per_patient, max_diff = [], 0.0
    dev = torch.device("cuda:0")
    for index, path in enumerate(checkpoints):
        task_model, variables = load_model_from_ckpt(path)
        module = task_model.module
        module.load_state_dict(vit.variables_from_jax(variables))
        module.to(dev).eval()
        for name, n in patients:
            bags, coords, key_mask = _whole_bag(root / "features" / f"{name}.h5", dev)
            bucket = bags.shape[1]
            _forward_probs(module, bags, coords, key_mask)  # warm-up
            probs, ms = _forward_probs(module, bags, coords, key_mask)
            row = dict(checkpoint=path.name, patient=name, tiles=n, seq_len=bucket + 1, forward_ms=ms)
            if n == max(DEPLOY_TILES):
                _profile_forward(card, f"{path.name}, largest patient", lambda: _forward_probs(module, bags, coords, key_mask))
            written = csv[f"patient-preds-{index}.csv"].loc[name, ["isup_high", "isup_low"]].to_numpy(float)
            if not np.abs(probs - written).max() <= 1e-5:
                _fail(f"{row}: kernel-path probabilities {probs} differ from the CSV's {written}")
            if bucket + 1 <= 16385:
                plain, plain_ms = _forward_probs(module, bags, coords, key_mask, plain=True)
                diff = float(np.abs(probs - plain).max())
                max_diff = max(max_diff, diff)
                row |= dict(plain_forward_ms=plain_ms, prob_max_abs_diff=diff)
                if not diff <= PROB_TOL:
                    _fail(f"{row}: kernel path against plain path {diff} > {PROB_TOL}")
            print(f"[6 deploy] {json.dumps(row)} on {card}")
            per_patient.append(row)
            del bags, coords
            torch.cuda.empty_cache()
        module.to("cpu")
    row = dict(patients=len(patients), checkpoints=len(checkpoints), launches=launches, wall_s=wall,
               mean_pairwise_distance_um=mean_dist, prob_max_abs_diff=max_diff)  # fmt: skip
    print(f"[6 deploy] {json.dumps(row)} on {card}")
    return row


def _forward_probs(module, bags, coords, key_mask, plain: bool = False) -> tuple:
    """(class probabilities of one bag, forward ms) in inference mode, on
    the kernel path or, with ``plain``, through the flash functions' plain
    versions."""
    import torch

    from stamp_tpu_torch.ops import flash_attention as attn

    kernel_fns = (attn.flash_mha, attn.flash_alibi_mha)
    if plain:
        attn.flash_mha, attn.flash_alibi_mha = attn.flash_mha_reference, attn.flash_alibi_mha_reference
    try:
        torch.cuda.synchronize()
        start = time.perf_counter()
        with torch.inference_mode():
            logits = module(bags, coords=coords, key_mask=key_mask)
        probs = torch.softmax(logits.double(), dim=-1)[0].cpu().numpy()
    finally:
        attn.flash_mha, attn.flash_alibi_mha = kernel_fns
    return probs, (time.perf_counter() - start) * 1e3


def _profile_forward(card: str, what: str, fn, tag: str = "6 deploy") -> None:
    """Device time by kernel of one forward (``torch.profiler``), and the
    share of the forward's wall time the device was busy."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_ms = fn()
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    rows = [dict(kernel=e.key[:60], calls=e.count, device_ms=e.device_time_total / 1e3) for e in top]
    print(
        f"[{tag}] profile {what}: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); top kernels {json.dumps(rows)} on {card}"
    )


def _rel_errs(got, want) -> list[float]:
    """max |Δ| / max |ref| per gradient.  With one key per sequence the
    softmax is constant, dS = 0 and the reference dq and dk are exactly 0
    while the kernel's TF32 dP − D leaves rounding: there the scale of dq and
    dk is that of dv, the gradient that does not cancel."""
    floor = want[2].abs().max().item() if want[0].shape[1] == 1 else 1e-30
    return [(a - b).abs().max().item() / max(b.abs().max().item(), floor) for a, b in zip(got, want)]


# the flash backward's kernels as torch.profiler names them
_BWD_KERNELS = {"prepass": "flash_bwd_prepass", "lists": "flash_bwd_lists", "dq": "flash_bwd_dq",
                "dkv": "flash_bwd_dkv"}  # fmt: skip


def _bwd_executed_flops(mask, do, d: int) -> float:
    """Operations the d = 64 backward kernels execute: each warpgroup of 64
    queries with a nonzero dO row, over the 64-key tiles that hold a valid
    key (3 products: s, dP, dS·k); each warpgroup of 64 keys that holds a
    valid key, over the 64-query tiles with a nonzero dO row (4 products:
    s, dP, Pᵀ·dO, dSᵀ·q).  A sequence with no valid key keeps every tile."""
    import torch

    def tiles(flags):  # [bh, n] → live tiles of 64 rows, [bh]
        bh, n = flags.shape
        pad = torch.zeros(bh, -n % 64, dtype=torch.bool, device=flags.device)
        return torch.cat([flags, pad], dim=1).view(bh, -1, 64).any(dim=-1).sum(dim=-1)

    live_rows = (do != 0).any(dim=-1)
    keys = mask | ~mask.any(dim=-1, keepdim=True)
    pairs = tiles(live_rows) * tiles(keys) * 64 * 64
    return float((pairs * (3 + 4)).sum().item()) * 2 * d


#: traces ``_device_split`` takes before it fails: CUPTI now and then hands
#: the profiler a trace with no device activity at all, for a call whose
#: kernels the trace before and after it shows
SPLIT_TRACES = 3


def _device_split(fn, kernels: dict) -> dict:
    """Device ms of each kernel of ``kernels`` (part → a tag of its name) in
    one call of ``fn`` (``torch.profiler``), as ``<part>_ms``.  The call is
    synchronised inside the trace.  A trace without one of the kernels is
    taken again, up to ``SPLIT_TRACES`` in all (each empty one printed);
    the last one without them fails."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, SPLIT_TRACES + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        device = {e.key: e.device_time_total / 1e3 for e in prof.key_averages()
                  if str(e.device_type).endswith("CUDA") and e.device_time_total > 0}  # fmt: skip
        split = {f"{part}_ms": sum(ms for key, ms in device.items() if tag in key) for part, tag in kernels.items()}
        if all(split.values()):
            return split
        print(f"[profiler] trace {attempt} of {SPLIT_TRACES} lacks a kernel of {sorted(kernels.values())}: "
              f"{split}; {len(device)} device events in all")  # fmt: skip
    _fail(f"torch.profiler traced no device time for a kernel of {sorted(kernels.values())} in {SPLIT_TRACES} traces")


def _bwd_split(fn, mask, do, d: int) -> dict:
    """Device ms of each of the backward's kernels in one call of ``fn``,
    and the TFLOP/s the dQ and dK/dV kernels execute over their time."""
    split = _device_split(fn, _BWD_KERNELS)
    kernels_ms = split["dq_ms"] + split["dkv_ms"]
    executed = _bwd_executed_flops(mask, do, d)
    return split | dict(executed_tflop=executed / 1e12, executed_tflops=executed / kernels_ms / 1e9 if kernels_ms else None)


# (bh, tq, tk, d, key mask, dO, timed) of the cases phase 3c adds for the
# backward's tile skipping; their inputs come from tests/flash_bwd_util.py,
# which the card tests share ("holes" masks whole 64- and 128-key tiles and
# 30% of the other keys, "one-empty" every key of sequence 1)
BWD_SKIP_CASES = (
    (8, 4097, 4097, 64, "holes", "dense", False),
    (8, 4097, 4097, 64, "suffix", "padded-rows-zero", False),
    (4, 700, 517, 64, "one-empty", "dense", False),
    (3, 700, 700, 128, "holes", "row0", False),
    (8, 16385, 16385, 64, "suffix", "row0", True),
)


def _bwd_skip_case(card: str, gen, bh, tq, tk, d, mask_kind, do_kind, timed) -> dict:
    """Both backward wrappers on one skip case against their plain
    versions: BWD_TOL per sequence, zero dk and dv on masked keys of
    sequences with a valid key, zero dq where dO is zero, bitwise-equal
    reruns; with ``timed`` also the times, the bound over the nonzero dO
    rows, and the kernels' split."""
    import torch
    from flash_bwd_util import skip_case_inputs

    from stamp_tpu_torch.ops import flash_attention as attn

    q, k, v, mask, do, coords_q, coords_k, ds = skip_case_inputs(gen, bh, tq, tk, d, mask_kind, do_kind)
    zero_do = (do == 0).all(dim=-1)
    masked = ~mask & mask.any(dim=1)[:, None]
    out, lse = attn._flash_forward(q, k, v, mask)
    _, out_sm, dacc, lse_a = attn._flash_alibi_forward(q, k, v, coords_q, coords_k, ds, mask)
    calls = {
        "flash_mha_bwd": (attn._flash_backward, attn._flash_backward_reference, (q, k, v, mask, out, lse, do)),
        "flash_alibi_mha_bwd": (attn._flash_alibi_backward, attn._flash_alibi_backward_reference,
                                (q, k, v, coords_q, coords_k, ds, mask, out_sm, dacc, lse_a, do)),
    }  # fmt: skip
    rows = {}
    for name, (kernel, plain, args) in calls.items():
        got, again, want = kernel(*args), kernel(*args), plain(*args)
        torch.cuda.synchronize()
        errs = [max(_rel_errs([g[i : i + 1] for g in got[:3]], [w[i : i + 1] for w in want[:3]])) for i in range(bh)]
        if name == "flash_alibi_mha_bwd":
            errs.append(_error(got[3], want[3])[1])
        row = dict(case=f"{mask_kind} mask, {do_kind} dO", shape=[bh, tq, tk, d],
                   max_abs_err=max((a - b).abs().max().item() for a, b in zip(got, want)), max_rel_err=max(errs))  # fmt: skip
        if not max(errs) <= BWD_TOL:
            _fail(f"{name} {row}: beyond {BWD_TOL}")
        if got[1][masked].any() or got[2][masked].any():
            _fail(f"{name} {row}: masked keys got a nonzero dk or dv")
        if got[0][zero_do].any():
            _fail(f"{name} {row}: a query with a zero dO got a nonzero dq")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            _fail(f"{name} {row}: two runs differ")
        del got, again, want
        if timed:
            # the function needs the nonzero dO rows against the valid keys:
            # five products per such (query, key) pair.  It reads k, v and dO
            # in full, but q, O and lse only on those rows (elsewhere
            # D = rowsum(dO∘O) = 0 and dS = 0, so dK = dSᵀ·q takes nothing
            # from them), and writes dq, dk and dv in full
            live = (~zero_do).sum().item()
            pairs = ((~zero_do).sum(dim=1) * mask.sum(dim=1)).sum().item()
            io_bytes = 4 * (4 * k.numel() + 2 * do.numel() + live * (2 * d + 1)) + mask.numel()
            flops = {"tf32": 5 * 2 * d * pairs}
            if name == "flash_alibi_mha_bwd":
                # + the key coordinates; the query coordinates and D·V
                # (dacc) on the same rows
                io_bytes += 4 * (coords_k.numel() + live * (2 + d))
                flops["fp32_dot"] = 2 * d * pairs  # the bias branch's distance-weighted sum
            bounds = _bounds(io_bytes, flops)
            tm = _compare_timed(lambda: kernel(*args), lambda: plain(*args), iters=3)
            row |= dict(ms=tm["kernel"], plain_ms=tm["plain"], **bounds, bound_share=bounds["bound_ms"] / tm["kernel"])
            if name == "flash_mha_bwd":
                row |= _bwd_split(lambda: kernel(*args), mask, do, d)
        print(f"[3c backward] {name} {json.dumps(row)} on {card}")
        rows[name] = row
    return rows


def phase_flash_backward(card: str) -> dict:
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.ops import flash_attention as attn

    gen = torch.Generator(device="cuda:0").manual_seed(3)
    rows: dict = {"flash_mha_bwd": [], "flash_alibi_mha_bwd": [], "dist_weighted_sum": []}
    shapes = ((3, 1, 64), (3, 300, 64), (2, 130, 32), (2, 200, 128), (8, 4097, 64), (8, 16385, 64))
    for bh, t, d in shapes:
        q, k, v, mask, coords, ds = _flash_inputs(gen, bh, t, d)
        do = torch.randn(bh, t, d, device="cuda:0", generator=gen)
        n_valid = mask[0].sum().item()
        pairs = bh * t * n_valid  # (query, valid key) pairs the function needs
        io_bytes = 8 * q.numel() * 4 + 2 * bh * t * 4 + mask.numel()  # q k v dO O in, dq dk dv out; lse, D; mask
        masked = ~mask

        # flash_mha: the dQ and dK/dV kernels against the plain backward
        out, lse = attn._flash_forward(q, k, v, mask)
        args = (q, k, v, mask, out, lse, do)
        got = attn._flash_backward(*args)
        again = attn._flash_backward(*args)
        want = attn._flash_backward_reference(*args)
        torch.cuda.synchronize()
        errs = _rel_errs(got, want)
        row = dict(shape=[bh, t, d], max_abs_err=max((a - b).abs().max().item() for a, b in zip(got, want)),
                   dq_rel_err=errs[0], dk_rel_err=errs[1], dv_rel_err=errs[2])  # fmt: skip
        if not max(errs) <= BWD_TOL:
            _fail(f"flash_mha backward {row}: beyond {BWD_TOL}")
        if got[1][masked].any() or got[2][masked].any():
            _fail(f"flash_mha backward {row}: masked keys got a nonzero dk or dv")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            _fail(f"flash_mha backward {row}: two runs differ")
        del got, again, want
        if t >= 4097:
            # the backward needs five products per pair: s = q·kᵀ, dP = dO·vᵀ,
            # dQ, dK and dV (the kernels recompute s and dP in both passes)
            bound, by = _bound(io_bytes, {"tf32": 5 * 2 * d * pairs})
            bound_all, _ = _bound(io_bytes, {"tf32": 5 * 2 * d * bh * t * t})
            qg, kg, vg = (x.detach().clone().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(qg[:, None], kg[:, None], vg[:, None], attn_mask=mask[:, None, None, :])
            do4 = do[:, None]

            def sdpa_backward():
                return torch.autograd.grad(sdpa_out, (qg, kg, vg), do4, retain_graph=True)

            tm = _compare_timed(
                lambda: attn._flash_backward(*args), lambda: attn._flash_backward_reference(*args), sdpa_backward, iters=3
            )
            row |= dict(ms=tm["kernel"], plain_ms=tm["plain"], library_ms=tm["control"], bound_ms=bound,
                        bound_by=by, bound_all_keys_ms=bound_all)  # fmt: skip
            row |= _bwd_split(lambda: attn._flash_backward(*args), mask, do, d) | dict(bound_share=bound / row["ms"])
            del qg, kg, vg, sdpa_out
        print(f"[3c backward] flash_mha_bwd {json.dumps(row)} on {card}")
        rows["flash_mha_bwd"].append(row)

        # flash_alibi_mha: the same kernels on the softmax output, plus the
        # bias branch through the distance-weighted sum
        _, out_sm, dacc, lse = attn._flash_alibi_forward(q, k, v, coords, coords, ds, mask)
        args = (q, k, v, coords, coords, ds, mask, out_sm, dacc, lse, do)
        got = attn._flash_alibi_backward(*args)
        again = attn._flash_alibi_backward(*args)
        want = attn._flash_alibi_backward_reference(*args)
        torch.cuda.synchronize()
        errs = _rel_errs(got[:3], want[:3]) + [_error(got[3], want[3])[1]]
        row = dict(shape=[bh, t, d], max_abs_err=max((a - b).abs().max().item() for a, b in zip(got, want)),
                   dq_rel_err=errs[0], dk_rel_err=errs[1], dv_rel_err=errs[2], ddist_scale_rel_err=errs[3])  # fmt: skip
        if not max(errs) <= BWD_TOL:
            _fail(f"flash_alibi_mha backward {row}: beyond {BWD_TOL}")
        if got[1][masked].any() or got[2][masked].any():
            _fail(f"flash_alibi_mha backward {row}: masked keys got a nonzero dk or dv")
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            _fail(f"flash_alibi_mha backward {row}: two runs differ")
        del got, again, want
        if t >= 4097:
            alibi_bytes = io_bytes + 2 * coords.numel() * 4 + 2 * q.numel() * 4  # + coords, dacc in, dO·s
            bounds = _bounds(alibi_bytes, {"tf32": 5 * 2 * d * pairs, "fp32_dot": 2 * d * pairs})
            bound_all, _ = _bound(alibi_bytes, {"tf32": 5 * 2 * d * bh * t * t, "fp32_dot": 2 * d * bh * t * t})
            tm = _compare_timed(
                lambda: attn._flash_alibi_backward(*args), lambda: attn._flash_alibi_backward_reference(*args), iters=3
            )
            row |= dict(ms=tm["kernel"], plain_ms=tm["plain"], library_ms=None, **bounds, bound_all_keys_ms=bound_all,
                        bound_share=bounds["bound_ms"] / tm["kernel"])  # fmt: skip
        print(f"[3c backward] flash_alibi_mha_bwd {json.dumps(row)} on {card}")
        rows["flash_alibi_mha_bwd"].append(row)

        # the distance-weighted sum alone, as the ALiBi backward calls it
        # (a = keys with the key mask as the a-mask, b = queries, every b
        # counts), then without an a-mask (a correctness check: the ALiBi
        # backward always passes one) and, at the timed shapes, with the
        # last MIL layer's dO (zero but on the CLS row: one live b tile)
        val = do * ds[:, None, None]
        variants = [("key mask as a-mask, dense dO", mask, val), ("no a-mask, dense dO", None, val)]
        if t >= 4097:
            last = torch.zeros_like(val)
            last[:, 0] = val[:, 0]
            variants.append(("key mask as a-mask, last layer's dO", mask, last))
        for variant, a_mask, values in variants:
            dws_args = (coords, coords, values, None, a_mask)
            got, again = attn._dist_weighted_sum(*dws_args), attn._dist_weighted_sum(*dws_args)
            want = attn._dist_weighted_sum_reference(*dws_args)
            torch.cuda.synchronize()
            abs_err, rel_err = _error(got, want)
            row = dict(shape=[bh, t, d], variant=variant, max_abs_err=abs_err, rel_err=rel_err)
            if not rel_err <= DWS_TOL:
                _fail(f"_dist_weighted_sum {row}: beyond {DWS_TOL}")
            if a_mask is not None and got[~a_mask].any():
                _fail(f"_dist_weighted_sum {row}: a row the a-mask drops is not zero")
            if not torch.equal(got, again):
                _fail(f"_dist_weighted_sum {row}: two runs differ")
            del got, again, want
            if t >= 4097 and a_mask is not None:
                # the pairs it needs: the kept rows a against the b with a
                # nonzero value; it reads both coordinate sets, the values
                # and the a-mask once and writes every row
                live_b = (values != 0).any(dim=-1)
                dws_pairs = (a_mask.sum(dim=1) * live_b.sum(dim=1)).sum().item()
                dws_bytes = 4 * (2 * coords.numel() + 2 * values.numel()) + a_mask.numel()
                bounds = _bounds(dws_bytes, {"fp32_dot": 2 * d * dws_pairs})
                bound_all, _ = _bound(dws_bytes, {"fp32_dot": 2 * d * bh * t * t})
                tm = _compare_timed(lambda: attn._dist_weighted_sum(*dws_args),
                                    lambda: attn._dist_weighted_sum_reference(*dws_args), iters=3)  # fmt: skip
                row |= dict(ms=tm["kernel"], plain_ms=tm["plain"], library_ms=None, **bounds,
                            bound_all_keys_ms=bound_all, bound_share=bounds["bound_ms"] / tm["kernel"],
                            tf32_tflops=3 * 2 * d * dws_pairs / tm["kernel"] / 1e9)  # fmt: skip
            print(f"[3c backward] dist_weighted_sum {json.dumps(row)} on {card}")
            rows["dist_weighted_sum"].append(row)
        del q, k, v, do, out, out_sm, dacc, lse, val
        torch.cuda.empty_cache()

    for case in BWD_SKIP_CASES:
        for name, row in _bwd_skip_case(card, gen, *case).items():
            rows[name].append(row)
        torch.cuda.empty_cache()

    # head width 48 through the autograd Functions (padded to 64, sliced
    # back) against the plain backward at the true width
    q, k, v, mask, coords, ds = _flash_inputs(gen, 8, 4097, 48)
    do = torch.randn(8, 4097, 48, device="cuda:0", generator=gen)
    for name in ("flash_mha_bwd", "flash_alibi_mha_bwd"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v, ds)]
        if name == "flash_mha_bwd":
            got = torch.autograd.grad(attn.flash_mha(*leaves[:3], mask), leaves[:3], do)
            out, lse = attn._flash_forward_reference(q, k, v, mask)
            want = attn._flash_backward_reference(q, k, v, mask, out, lse, do)
            errs = _rel_errs(got, want)
        else:
            got = torch.autograd.grad(attn.flash_alibi_mha(*leaves[:3], coords, coords, leaves[3], mask), leaves, do)
            out_sm, dacc, lse = attn._flash_alibi_forward_reference(q, k, v, coords, coords, mask)
            want = attn._flash_alibi_backward_reference(q, k, v, coords, coords, ds, mask, out_sm, dacc, lse, do)
            errs = _rel_errs(got[:3], want[:3]) + [_error(got[3], want[3])[1]]
        torch.cuda.synchronize()
        row = dict(shape=[8, 4097, 48], max_abs_err=max((a - b).abs().max().item() for a, b in zip(got, want)),
                   rel_errs=errs)  # fmt: skip
        print(f"[3c backward] {name} head width 48 {json.dumps(row)} on {card}")
        if not max(errs) <= BWD_TOL:
            _fail(f"{name} at head width 48 {row}: beyond {BWD_TOL}")
        rows[name].append(row)
    del q, k, v, do, got, want
    torch.cuda.empty_cache()
    return rows


def _write_train_cohort(root: Path) -> None:
    """Twelve patients' UNI2 feature files (fp16, the port's writer) on a
    256 µm grid, slide.csv and clini.csv; every other patient is positive,
    with a mean shift along one direction in 30% of its tiles."""
    import numpy as np
    import pandas as pd

    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(4)
    direction = rng.standard_normal(UNI2_DIM).astype(np.float32)
    direction /= np.linalg.norm(direction)
    rows = []
    for i, n in enumerate(TRAIN_TILES):
        label = "pos" if i % 2 == 0 else "neg"
        feats = rng.standard_normal((n, UNI2_DIM), dtype=np.float32)
        if label == "pos":
            feats[rng.choice(n, int(0.3 * n), replace=False)] += 2.0 * direction
        side = math.isqrt(n - 1) + 1
        idx = np.arange(n)
        coords = (np.stack([idx % side, idx // side], axis=1) * 256.0).astype(np.float32)
        write_tile_feats_atomic(
            output_path=root / "features" / f"pat{i:02d}.h5", feats=feats.astype(np.float16), coords_um=coords,
            extractor_id="uni2", tile_size_um=256.0, tile_size_px=224, code_hash="chip-smoke",
        )  # fmt: skip
        rows.append((f"pat{i:02d}.h5", f"pat{i:02d}", label))
    pd.DataFrame([r[:2] for r in rows], columns=["FILENAME", "PATIENT"]).to_csv(root / "slide.csv", index=False)
    pd.DataFrame([r[1:] for r in rows], columns=["PATIENT", "label"]).to_csv(root / "clini.csv", index=False)


_COUNTERS = (
    "FLASH_MHA_LAUNCHES", "FLASH_ALIBI_MHA_LAUNCHES", "FLASH_MHA_BWD_LAUNCHES",
    "FLASH_ALIBI_MHA_BWD_LAUNCHES", "DIST_WEIGHTED_SUM_LAUNCHES", "FLASH_MHA_DROPOUT_LAUNCHES",
    "FLASH_MHA_DROPOUT_BWD_LAUNCHES",
)  # fmt: skip
#: phase 7's runs: (variant, the ``vit`` model_params), reused by phases 15 (a) and 16 (a)
_TRAIN_VARIANTS = (
    ("vit", {"use_alibi": False}), ("alibi", {"use_alibi": True}),
    ("vit_dropout", {"use_alibi": False, "dropout": TRAIN_DROPOUT}),
)  # fmt: skip
#: ``ops/attention.py``'s counter of the ALiBi statistic's kernel (one launch a training forward)
_PAIR_SUMS = "ALIBI_PAIR_SUMS_LAUNCHES"
# the statistic's kernel against its plain version (relative, on the sum of
# distances): f32 sums of ≤ 4,096 distances a thread, added across blocks in
# f64, against a plain f32 sum of 512-row blocks; both within a few 1e-7 of
# the float64 sum at phase 7's buckets (tests/test_torch_cuda.py's
# PAIR_SUMS_RTOL holds the kernel to 1e-5 of it at 4.3·10⁹ pairs)
PAIR_SUMS_TOL = 1e-5


def _reset_training_launches() -> None:
    """The flash kernels' counters and the ALiBi statistic's to 0."""
    from stamp_tpu_torch.ops import attention, flash_attention

    for name in _COUNTERS:
        setattr(flash_attention, name, 0)
    setattr(attention, _PAIR_SUMS, 0)


def _training_launches() -> dict[str, int]:
    """The counters ``_reset_training_launches`` zeroes, by name."""
    from stamp_tpu_torch.ops import attention, flash_attention

    return {name: getattr(flash_attention, name) for name in _COUNTERS} | {_PAIR_SUMS: getattr(attention, _PAIR_SUMS)}


@contextlib.contextmanager
def _plain_flash():
    """The flash autograd Functions with their plain forward and backward,
    and the ALiBi statistic's kernel with its plain version (where the
    model looks it up)."""
    from stamp_tpu_torch.models import vision_transformer as vit
    from stamp_tpu_torch.ops import attention
    from stamp_tpu_torch.ops import flash_attention as attn

    def alibi_forward(q, k, v, coords_q, coords_k, dist_scale, key_mask, scale=None):
        out_sm, dacc, lse = attn._flash_alibi_forward_reference(q, k, v, coords_q, coords_k, key_mask, scale)
        return out_sm - dist_scale[:, None, None] * dacc, out_sm, dacc, lse

    names = ("_flash_forward", "_flash_alibi_forward", "_flash_backward", "_flash_alibi_backward")
    saved = [getattr(attn, n) for n in names]
    plain = (attn._flash_forward_plain, alibi_forward, attn._flash_backward_plain,
             attn._flash_alibi_backward_reference)  # fmt: skip
    for name, fn in zip(names, plain):
        setattr(attn, name, fn)
    vit.pairwise_distance_sums = attention.pairwise_distance_sums_reference
    try:
        yield
    finally:
        for name, fn in zip(names, saved):
            setattr(attn, name, fn)
        vit.pairwise_distance_sums = attention.pairwise_distance_sums


def _training_step(module, batch) -> tuple:
    """Loss and parameter gradients of one training step (no update); the
    dropout masks (if the model has dropout) from a generator seeded alike
    in every call."""
    import torch

    from stamp_tpu_torch.modeling.tasks import weighted_cross_entropy

    bags, coords, key_mask, targets, weights = batch
    module.zero_grad(set_to_none=True)
    generator = torch.Generator(device=bags.device).manual_seed(0)
    logits = module(bags, coords=coords, key_mask=key_mask, train=True, generator=generator)
    loss = weighted_cross_entropy(logits, targets, weights)
    loss.backward()
    torch.cuda.synchronize()
    return loss.detach(), {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def _step_against_plain(module, state: dict, batch) -> dict:
    """One training step from ``state`` on the kernel path and on the plain
    path: the loss's relative error and the worst gradient's max |Δ| /
    max |ref|, with the plain step's time."""
    module.load_state_dict(state)
    loss, grads = _training_step(module, batch)
    module.load_state_dict(state)
    with _plain_flash():
        t1 = time.perf_counter()
        plain_loss, plain_grads = _training_step(module, batch)
        plain_ms = (time.perf_counter() - t1) * 1e3
    # ALiBi's key bias gets a gradient that is 0 in exact arithmetic
    # (softmax ignores a shift shared by all keys): its size is rounding on
    # both paths, held against the largest gradient
    scale = max(g.abs().max().item() for g in plain_grads.values())
    grad_errs = {
        k: (grads[k] - plain_grads[k]).abs().max().item()
        / (scale if k.endswith("k_proj.bias") else max(plain_grads[k].abs().max().item(), 1e-30))
        for k in plain_grads
    }
    worst = max(grad_errs, key=grad_errs.get)
    return dict(loss=loss.item(), plain_loss=plain_loss.item(), plain_step_ms=plain_ms,
                loss_rel_err=abs(loss.item() - plain_loss.item()) / abs(plain_loss.item()),
                max_grad_rel_err=grad_errs[worst], worst_grad=worst)  # fmt: skip


def _whole_bag(path: Path, dev) -> tuple:
    """A patient's features as the trainer and deploy feed them: padded to
    their bucket, with coordinates and a key mask ([1, bucket, …])."""
    import torch

    from stamp_tpu_torch.io.h5 import read_feats
    from stamp_tpu_torch.modeling.train import _bucket_size

    feats, info = read_feats(path)
    n = len(feats)
    bucket = _bucket_size(n)
    bags = torch.zeros(1, bucket, feats.shape[1], device=dev)
    bags[0, :n] = torch.from_numpy(feats).to(dev)
    coords = torch.zeros(1, bucket, 2, device=dev)
    coords[0, :n] = torch.from_numpy(info.coords_um).to(dev)
    return bags, coords, (torch.arange(bucket, device=dev) < n)[None]


def _pair_sums_row(coords, mask) -> dict:
    """``pairwise_distance_sums`` (the ALiBi statistic's kernel) on [1, T, 2]
    coordinates and their mask against its plain version, on the same
    inputs, and against the same sums in float64; both timed in turns, with
    the kernel's bound (6 f32 operations a valid pair against the
    coordinates and mask read once, as ``alibi_pair_sums_roofline``
    counts)."""
    from stamp_tpu_torch.ops import attention

    total, pairs = attention.pairwise_distance_sums(coords, mask=mask)
    plain_total, plain_pairs = attention.pairwise_distance_sums_reference(coords, mask=mask)
    f64_total, f64_pairs = attention.pairwise_distance_sums_reference(coords.double(), mask=mask)
    err = abs(total.item() - plain_total.item()) / plain_total.item()
    row = dict(shape=list(coords.shape), valid=int(mask.sum()), rel_err=err, tol=PAIR_SUMS_TOL,
               rel_err_f64=abs(total.item() - f64_total.item()) / f64_total.item(),
               plain_rel_err_f64=abs(plain_total.item() - f64_total.item()) / f64_total.item())  # fmt: skip
    # the count exactly (an f64 count); the plain version counts in f32, inexact past 2²⁴ pairs
    if not (err <= PAIR_SUMS_TOL and pairs.item() == f64_pairs.item()
            and abs(plain_pairs.item() - pairs.item()) <= PAIR_SUMS_TOL * pairs.item()):  # fmt: skip
        _fail(f"alibi_pair_sums {row}: sums ({total.item()}, {pairs.item()}) against the plain version's "
              f"({plain_total.item()}, {plain_pairs.item()}), beyond {PAIR_SUMS_TOL}")  # fmt: skip
    timed = _compare_timed(lambda: attention.pairwise_distance_sums(coords, mask=mask),
                           lambda: attention.pairwise_distance_sums_reference(coords, mask=mask), iters=5)  # fmt: skip
    bound, by = _bound(9 * 2 * coords.shape[1], {"fp32": 6.0 * pairs.item()})
    return row | dict(ms=timed["kernel"], plain_ms=timed["plain"], bound_ms=bound, bound_by=by)


def phase_train(card: str) -> dict:
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    import torch.nn.functional as F

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.models import vision_transformer as vit
    from stamp_tpu_torch.utils import profiling

    root = WORK / "train"
    _write_train_cohort(root)
    dev = torch.device("cuda:0")
    result: dict = {"runs": {}}
    for variant, vit_params in _TRAIN_VARIANTS:
        use_alibi, dropping = vit_params["use_alibi"], "dropout" in vit_params
        out = root / variant
        config = root / f"{variant}.yaml"
        config.write_text(yaml.safe_dump({
            "training": {
                "output_dir": str(out), "clini_table": str(root / "clini.csv"), "slide_table": str(root / "slide.csv"),
                "feature_dir": str(root / "features"), "ground_truth_label": "label", "task": "classification",
            },
            "advanced_config": {
                "bag_size": None, "max_epochs": TRAIN_EPOCHS, "seed": 0, "accelerator": "cuda", "num_workers": 4,
                "model_params": {"vit": vit_params},
            },
        }))  # fmt: skip
        _reset_training_launches()
        t0 = time.perf_counter()
        _staged_cli(["-c", str(config), "train"])  # exits non-zero on failure
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _training_launches()
        step_s = profiling.timer.seconds["train/step"]

        metrics = pd.read_csv(out / "lightning_logs/version_0/metrics.csv")
        columns = ["validation_loss", "validation_auroc", "training_loss", "epoch", "step", "learning_rate"]
        if list(metrics.columns) != columns or len(metrics) != TRAIN_EPOCHS:
            _fail(f"{variant}: metrics.csv has {list(metrics.columns)} × {len(metrics)}, expected {columns} × {TRAIN_EPOCHS}")
        if not np.isfinite(metrics[["validation_loss", "training_loss", "learning_rate"]].to_numpy()).all():
            _fail(f"{variant}: losses or learning rates are not finite: {metrics.to_dict('list')}")
        steps = int(metrics["step"].iloc[-1])
        bwd = "FLASH_ALIBI_MHA_BWD_LAUNCHES" if use_alibi else "FLASH_MHA_BWD_LAUNCHES"
        expected = {name: 0 for name in _COUNTERS if "BWD" in name or "DIST" in name} | {_PAIR_SUMS: 0}
        if dropping:  # every bucket is at or above the flash threshold: every training attention call drops there
            bwd = "FLASH_MHA_DROPOUT_BWD_LAUNCHES"
            expected["FLASH_MHA_DROPOUT_LAUNCHES"] = MIL_LAYERS * steps
        else:
            expected["FLASH_MHA_DROPOUT_LAUNCHES"] = 0
        expected[bwd] = MIL_LAYERS * steps
        if use_alibi:  # the statistic once a training forward, for both layers
            expected["DIST_WEIGHTED_SUM_LAUNCHES"] = MIL_LAYERS * steps
            expected[_PAIR_SUMS] = steps
        if {name: launches[name] for name in expected} != expected:
            _fail(f"{variant}: training launches {launches}, expected {expected} ({MIL_LAYERS} layers × {steps} steps)")
        model, variables = load_model_from_ckpt(out / "model.ckpt")
        row = dict(variant=variant, steps=steps, launches=launches, wall_s=wall, train_step_s=step_s,
                   steps_per_s=steps / step_s, metrics=metrics.to_dict("list"))  # fmt: skip
        print(f"[7 train] {json.dumps(row)} on {card}")
        result["runs"][variant] = row

        # one whole-slide step per T on the kernel path (timed), and at
        # T = 8,193 against the plain path, from the trainer's initial
        # weights (seed 0, where the TF32 products decide the margin) and
        # from the trained ones (a confident model: small gradients)
        module = model.module
        vit.init_random_weights_(module, torch.Generator().manual_seed(0))
        initial = {k: t.to(dev, copy=True) for k, t in module.state_dict().items()}
        module.load_state_dict(vit.variables_from_jax(variables))
        module.to(dev)
        start = {k: t.clone() for k, t in module.state_dict().items()}
        weights = torch.tensor(model.class_weights, device=dev)
        for n in (TRAIN_TILES[0], TRAIN_TILES[4], TRAIN_TILES[-1]):
            i = TRAIN_TILES.index(n)
            bags, coords, key_mask = _whole_bag(root / "features" / f"pat{i:02d}.h5", dev)
            bucket = bags.shape[1]
            targets = torch.tensor([[1.0, 0.0] if i % 2 else [0.0, 1.0]], device=dev)
            batch = (bags, coords, key_mask, targets, weights)
            times = []
            for _ in range(4):  # the first call warms up
                module.load_state_dict(start)
                t1 = time.perf_counter()
                _training_step(module, batch)
                times.append((time.perf_counter() - t1) * 1e3)
            step_row = dict(variant=variant, tiles=n, seq_len=bucket + 1, step_ms=statistics.median(times[1:]))
            if use_alibi:  # the statistic's kernel on the model's coordinates and mask (the CLS at (0, 0) first)
                row = _pair_sums_row(F.pad(coords, (0, 0, 1, 0)), F.pad(key_mask, (1, 0), value=True))
                print(f"[7 train] alibi_pair_sums {json.dumps(row)} on {card}")
                result.setdefault("pair_sums", []).append(row)
            if bucket + 1 == 8193:
                for weights_from, state in (("initial", initial), ("trained", start)):
                    check = _step_against_plain(module, state, batch)
                    step_row[weights_from] = check
                    if not (check["loss_rel_err"] <= STEP_LOSS_TOL and check["max_grad_rel_err"] <= STEP_GRAD_TOL):
                        _fail(f"{variant} step at T = 8193 from the {weights_from} weights: kernel against plain path {check}")
            if bucket + 1 == 16385:
                module.load_state_dict(start)
                _profile_step(card, variant, lambda: _training_step(module, batch))
            print(f"[7 train] {json.dumps(step_row)} on {card}")
            result.setdefault("steps", []).append(step_row)
            del bags, coords
            torch.cuda.empty_cache()
        module.to("cpu")

    # the two trained checkpoints deploy as an ensemble on the cohort
    config = root / "deploy.yaml"
    config.write_text(yaml.safe_dump({"deployment": {
        "output_dir": str(root / "deploy"), "checkpoint_paths": [str(root / v / "model.ckpt") for v in ("vit", "alibi")],
        "clini_table": str(root / "clini.csv"), "slide_table": str(root / "slide.csv"),
        "feature_dir": str(root / "features"), "ground_truth_label": "label", "accelerator": "cuda",
    }}))  # fmt: skip
    main(["-c", str(config), "deploy"])
    preds = pd.read_csv(root / "deploy" / "patient-preds_95_confidence_interval.csv")
    probs = preds[["label_neg", "label_pos"]].to_numpy()
    if len(preds) != len(TRAIN_TILES) or not np.isfinite(probs).all():
        _fail(f"deploy of the trained checkpoints: {len(preds)} rows, finite {np.isfinite(probs).all()}")
    print(f"[7 train] trained checkpoints deployed on {len(preds)} patients on {card}")
    return result


def _profile_step(card: str, variant: str, fn) -> None:
    """Device time by kernel of one training step (``torch.profiler``)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    rows = [dict(kernel=e.key[:60], calls=e.count, device_ms=e.device_time_total / 1e3) for e in top]
    print(
        f"[7 train] profile {variant} step at T = 16385: wall {wall_ms:.3f} ms (profiled), device busy "
        f"{busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}); top kernels {json.dumps(rows)} on {card}"
    )


def phase_crossval(card: str) -> dict:
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.models import vision_transformer as vit

    root = WORK / "train"  # phase 7's cohort
    out = root / "crossval"
    config = root / "crossval.yaml"
    # six training patients a fold in batches of 2: 3 steps an epoch, 6 in
    # all (the one-cycle schedule is NaN below 4 steps, as in optax)
    config.write_text(yaml.safe_dump({
        "crossval": {
            "output_dir": str(out), "clini_table": str(root / "clini.csv"), "slide_table": str(root / "slide.csv"),
            "feature_dir": str(root / "features"), "ground_truth_label": "label", "task": "classification",
            "n_splits": 2,
        },
        "advanced_config": {
            "max_epochs": CROSSVAL_EPOCHS, "batch_size": 2, "seed": 0, "accelerator": "cuda", "num_workers": 4,
            "model_params": {"vit": {"use_alibi": True}},
        },
    }))  # fmt: skip
    _reset_training_launches()
    t0 = time.perf_counter()
    main(["-c", str(config), "crossval"])  # exits non-zero on failure
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _training_launches()
    folds = []
    for fold in range(2):
        split = out / f"split-{fold}"
        if not (split / "model.ckpt").is_file() or not (split / "patient-preds.csv").is_file():
            _fail(f"crossval: {split} lacks model.ckpt or patient-preds.csv")
        metrics = pd.read_csv(split / "lightning_logs/version_0/metrics.csv")
        logged = metrics[["validation_loss", "training_loss", "learning_rate"]].to_numpy()
        if len(metrics) != CROSSVAL_EPOCHS or not np.isfinite(logged).all():
            _fail(f"crossval: {split} metrics.csv not finite over {CROSSVAL_EPOCHS} epochs: {metrics.to_dict('list')}")
        preds = pd.read_csv(split / "patient-preds.csv")
        probs = preds[["label_neg", "label_pos"]].to_numpy()
        if not np.isfinite(probs).all() or not np.allclose(probs.sum(axis=1), 1.0, atol=1e-5):
            _fail(f"crossval: {split} probabilities not finite or not summing to 1: {probs}")
        folds.append(dict(patients=len(preds), steps=int(metrics["step"].iloc[-1]), metrics=metrics.to_dict("list")))
    if sum(f["patients"] for f in folds) != len(TRAIN_TILES):
        _fail(f"crossval: fold predictions cover {folds} patients, expected {len(TRAIN_TILES)} in all")
    # training at 512 tiles stays on the einsum path; validation (every
    # epoch) and the fold exports run every held-out bag (T ≥ 4,097)
    # through the kernels
    expected = MIL_LAYERS * len(TRAIN_TILES) * (CROSSVAL_EPOCHS + 1)
    if (launches["FLASH_ALIBI_MHA_LAUNCHES"] != expected or launches["FLASH_ALIBI_MHA_BWD_LAUNCHES"]
            or launches["FLASH_MHA_DROPOUT_LAUNCHES"] or launches["FLASH_MHA_DROPOUT_BWD_LAUNCHES"]):  # fmt: skip
        _fail(f"crossval: launches {launches}, expected {expected} forward, no backward, no dropout")
    # the ALiBi statistic runs on the card in every training forward, on the einsum path too
    steps = sum(f["steps"] for f in folds)
    if launches[_PAIR_SUMS] != steps:
        _fail(f"crossval: {launches[_PAIR_SUMS]} launches of the ALiBi statistic's kernel, expected {steps} (one a step)")

    # fold 0's exported probabilities against its checkpoint on the kernel
    # path and on the plain path
    dev = torch.device("cuda:0")
    task_model, variables = load_model_from_ckpt(out / "split-0" / "model.ckpt")
    module = task_model.module
    module.load_state_dict(vit.variables_from_jax(variables))
    module.to(dev).eval()
    written = pd.read_csv(out / "split-0" / "patient-preds.csv").set_index("PATIENT")
    max_diff = 0.0
    for patient in written.index:
        bags, coords, key_mask = _whole_bag(root / "features" / f"{patient}.h5", dev)
        probs, _ = _forward_probs(module, bags, coords, key_mask)
        plain, _ = _forward_probs(module, bags, coords, key_mask, plain=True)
        csv = written.loc[patient, ["label_neg", "label_pos"]].to_numpy(float)
        if not np.abs(probs - csv).max() <= 1e-5:
            _fail(f"crossval: {patient}'s kernel-path probabilities {probs} differ from split-0's CSV {csv}")
        max_diff = max(max_diff, float(np.abs(probs - plain).max()))
        del bags, coords
    if not max_diff <= PROB_TOL:
        _fail(f"crossval: fold 0's export, kernel path against plain path {max_diff} > {PROB_TOL}")
    module.to("cpu")
    torch.cuda.empty_cache()
    row = dict(folds=folds, launches=launches, wall_s=wall, fold0_prob_max_abs_diff=max_diff)
    print(f"[8 crossval] {json.dumps(row)} on {card}")
    return row


def _write_titan_cohort(root: Path) -> None:
    """CONCH1.5 tile features (768-d fp16, ``extractor=conch1_5``, the
    port's writer) of slide-shaped tissue regions on a 256 µm grid, and a
    slide table with one patient of two slides."""
    import numpy as np
    import pandas as pd

    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(6)
    for name, n in TITAN_TILES.items():
        write_tile_feats_atomic(
            output_path=root / "features" / f"{name}.h5",
            feats=rng.standard_normal((n, 768), dtype=np.float32).astype(np.float16),
            coords_um=(_tissue_grid(n) * 256.0).astype(np.float32), extractor_id="conch1_5",
            tile_size_um=256.0, tile_size_px=224, code_hash="chip-smoke",
        )  # fmt: skip
    pd.DataFrame({"PATIENT": ["patient-A"] * 2, "FILENAME": [f"{s}.h5" for s in TITAN_PATIENT]}).to_csv(
        root / "slide.csv", index=False
    )


def phase_titan(card: str) -> dict:
    """9: ``encode_slides`` and ``encode_patients`` with ``encoder: titan``
    through the CLI at full width (random weights): the h5 contract, 12
    ``flash_alibi2d_mha`` launches for every slide or patient of ≥ 2,048
    tiles and none below; the 4,096-tile embedding on the kernel path
    against the plain path; seconds per slide, and a ``torch.profiler``
    split of the 16,384-tile slide."""
    import numpy as np
    import torch
    import yaml

    from stamp_tpu_torch.encoding.encoder.titan import Titan
    from stamp_tpu_torch.io.h5 import read_feats, read_h5
    from stamp_tpu_torch.models import slide_encoders
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.utils import profiling

    root = WORK / "titan"
    _write_titan_cohort(root)
    os.environ["STAMP_RANDOM_WEIGHTS"] = "1"
    runs = {}
    for command, section in (("encode_slides", "slide_encoding"), ("encode_patients", "patient_encoding")):
        fields = {"encoder": "titan", "output_dir": str(root / "out"), "feat_dir": str(root / "features"),
                  "device": "cuda", "generate_hash": False}  # fmt: skip
        if command == "encode_patients":
            fields["slide_table"] = str(root / "slide.csv")
        (root / f"{command}.yaml").write_text(yaml.safe_dump({section: fields}))
        attn.FLASH_ALIBI2D_LAUNCHES = 0
        t0 = time.perf_counter()
        _staged_cli(["-c", str(root / f"{command}.yaml"), command])  # exits non-zero on failure
        torch.cuda.synchronize()
        runs[command] = dict(launches=attn.FLASH_ALIBI2D_LAUNCHES, wall_s=time.perf_counter() - t0,
                             forward_s=profiling.timer.seconds["encode/forward"])  # fmt: skip
    large = sum(n >= 2048 for n in TITAN_TILES.values())
    expected = {"encode_slides": TITAN_LAYERS * large, "encode_patients": TITAN_LAYERS}
    if {c: r["launches"] for c, r in runs.items()} != expected:
        _fail(f"flash_alibi2d_mha launches {runs}, expected {expected} (12 layers × slides and patients ≥ 2,048 tiles)")
    outputs = {p.stem: read_h5(p) for p in sorted((root / "out").rglob("*.h5"))}
    if set(outputs) != {*TITAN_TILES, "patient-A"}:
        _fail(f"encoded files {sorted(outputs)}, expected {sorted(TITAN_TILES)} and patient-A")
    for name, (datasets, attrs) in outputs.items():
        feat_type = "patient" if name == "patient-A" else "slide"
        if (datasets["feats"].shape != (768,) or not np.isfinite(datasets["feats"]).all()
                or attrs["encoder"] != "titan" or attrs["feat_type"] != feat_type
                or attrs["precision"] != "torch.float32"):  # fmt: skip
            _fail(f"{name}: feats {datasets['feats'].shape}, attrs {attrs}")

    # per slide: the encoder on the kernel path (timed; deterministic, so it
    # repeats the CLI's embedding) and, at 4,096 tiles, on the plain path
    encoder = Titan()
    dev = torch.device("cuda:0")
    per_slide = []
    for name, n in TITAN_TILES.items():
        feats, coords = read_feats(root / "features" / f"{name}.h5")
        embed = lambda: encoder._generate_slide_embedding(feats, dev, coords=coords)  # noqa: E731
        embed()  # warm-up
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            got = embed()
            times.append(time.perf_counter() - t1)
        row = dict(slide=name, tiles=n, kernel_path=n >= 2048, seconds=statistics.median(times),
                   cli_max_abs_diff=float(np.abs(got - outputs[name][0]["feats"]).max()))  # fmt: skip
        if n == 4096:
            saved = slide_encoders.flash_alibi2d_mha
            slide_encoders.flash_alibi2d_mha = attn.flash_alibi2d_mha_reference
            try:
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                plain = embed()
                row["plain_seconds"] = time.perf_counter() - t1
            finally:
                slide_encoders.flash_alibi2d_mha = saved
            abs_err, rel_err = _error(torch.from_numpy(got), torch.from_numpy(plain))
            cos = float(np.dot(got, plain) / (np.linalg.norm(got) * np.linalg.norm(plain)))
            row |= dict(vs_plain_max_abs_err=abs_err, vs_plain_rel_err=rel_err, vs_plain_cosine=cos)
            if not (rel_err <= TITAN_TOL and cos >= TITAN_COSINE_MIN):
                _fail(f"TITAN at 4,096 tiles, kernel against plain path: {row}")
        if row["cli_max_abs_diff"] > 1e-5:
            _fail(f"{name}: the encoder's embedding differs from the CLI's: {row}")
        if n == max(TITAN_TILES.values()):
            _profile_forward(card, f"TITAN {name}, largest slide", lambda: (None, 1e3 * _timed(embed)), tag="9 titan")
        print(f"[9 titan] {json.dumps(row)} on {card}")
        per_slide.append(row)
    encoder.model.to("cpu")
    torch.cuda.empty_cache()
    summary = dict(runs=runs, slides=per_slide)
    print(f"[9 titan] {json.dumps(runs)} on {card}")
    return summary


@contextlib.contextmanager
def _kept_warnings():
    """The messages of the warnings the ``stamp`` logger emits meanwhile."""
    import logging

    records: list[str] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: records.append(record.getMessage())
    logger = logging.getLogger("stamp")
    logger.addHandler(handler)
    try:
        yield records
    finally:
        logger.removeHandler(handler)


def _figures_accounted(figures: list[Path], warnings: list[str]) -> None:
    """Each figure is written, or (without matplotlib) named in a warning;
    without matplotlib none is written."""
    from stamp_tpu_torch.utils.figures import pyplot

    has_matplotlib = pyplot() is not None
    for figure in figures:
        named = any(str(figure) in w and "matplotlib is not installed" in w for w in warnings)
        if figure.is_file() == named or (not has_matplotlib and not named):
            _fail(f"{figure}: written {figure.is_file()}, named in the warning {named}, matplotlib {has_matplotlib}")


def _write_outcome_csvs(root: Path) -> tuple[Path, Path]:
    """Seeded synthetic predictions of 60 patients: a regression CSV
    (``t``, ``pred``) and a survival one (``day``, ``status``,
    ``pred_score`` and deploy's ``cut_off=…`` marker column)."""
    import numpy as np
    import pandas as pd

    rng = np.random.default_rng(8)
    n = 60
    patients = [f"p{i:02d}" for i in range(n)]
    truth = rng.uniform(0.0, 50.0, n)
    regression = root / "regression" / "patient-preds.csv"
    regression.parent.mkdir(parents=True, exist_ok=True)
    pd.DataFrame({"PATIENT": patients, "t": truth, "pred": truth + rng.normal(0.0, 5.0, n)}).to_csv(
        regression, index=False
    )
    risk = rng.normal(0.0, 1.0, n)
    survival = root / "survival" / "patient-preds.csv"
    survival.parent.mkdir(parents=True, exist_ok=True)
    df = pd.DataFrame({"PATIENT": patients, "day": np.round(np.maximum(1, 900 - 250 * risk + rng.normal(0, 90, n))),
                       "status": rng.choice([0, 1], n, p=[0.3, 0.7]), "pred_score": risk})  # fmt: skip
    df["cut_off=0.05"] = None
    df.to_csv(survival, index=False)
    return regression, survival


def _rank_auroc(is_positive, scores) -> float:
    """AUROC by the Mann–Whitney rank formula (ties take their average
    rank), independent of the port's ``roc_auc_score``."""
    import numpy as np
    from scipy.stats import rankdata

    is_positive = np.asarray(is_positive, bool)
    n_pos, n_neg = int(is_positive.sum()), int((~is_positive).sum())
    ranks = rankdata(np.asarray(scores, float))
    return float((ranks[is_positive].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def phase_statistics(card: str) -> dict:
    """10: ``python -m stamp_tpu_torch -c config.yaml statistics`` in-process
    on phase 6's deploy CSVs (the ``vit`` + ALiBi ensemble), phase 8's
    crossval folds, and seeded regression and survival predictions: every
    table exists and is finite, each AUROC is the Mann–Whitney rank AUROC
    of its CSV, and each figure is written or named in the no-matplotlib warning."""
    import numpy as np
    import pandas as pd
    import yaml

    from stamp_tpu_torch.__main__ import main

    root = WORK / "statistics"
    regression, survival = _write_outcome_csvs(root)
    deploy = WORK / "deploy" / "out"
    crossval = WORK / "train" / "crossval"
    runs = {
        "deploy": dict(task="classification", ground_truth_label="isup", true_class="high",
                       pred_csvs=[deploy / f"patient-preds-{i}.csv" for i in range(2)]),
        "crossval": dict(task="classification", ground_truth_label="label", true_class="pos",
                         pred_csvs=[crossval / f"split-{i}" / "patient-preds.csv" for i in range(2)]),
        "regression": dict(task="regression", ground_truth_label="t", pred_csvs=[regression]),
        "survival": dict(task="survival", time_label="day", status_label="status", pred_csvs=[survival]),
    }  # fmt: skip
    rows = {}
    for name, fields in runs.items():
        out = root / "out" / name
        config = root / f"{name}.yaml"
        config.write_text(yaml.safe_dump({"statistics": {
            **fields, "output_dir": str(out), "pred_csvs": [str(p) for p in fields["pred_csvs"]]}}))  # fmt: skip
        t0 = time.perf_counter()
        with _kept_warnings() as warnings:
            main(["-c", str(config), "statistics"])  # exits non-zero on failure
        row = dict(run=name, wall_s=time.perf_counter() - t0)
        keys = [f"{p.parent.name}_{p.stem}" for p in fields["pred_csvs"]]
        if fields["task"] == "classification":
            gt, true_class = fields["ground_truth_label"], fields["true_class"]
            individual = pd.read_csv(out / f"{gt}_categorical-stats_individual.csv", index_col=[0, 1])
            aggregated = pd.read_csv(out / f"{gt}_categorical-stats_aggregated.csv", header=[0, 1], index_col=0)
            tables = [individual, aggregated]
            aurocs = {}
            for key, csv in zip(keys, fields["pred_csvs"]):
                preds = pd.read_csv(csv)
                for cls in sorted(preds[gt].unique()):
                    want = _rank_auroc((preds[gt] == cls).to_numpy(), preds[f"{gt}_{cls}"].to_numpy(float))
                    got = float(individual.loc[(key, cls), "roc_auc_score"])
                    if not abs(got - want) <= 1e-12:
                        _fail(f"statistics {name}: AUROC of {key}, {cls} is {got} in the table, {want} from the CSV")
                    aurocs[f"{key}/{cls}"] = got
            row["auroc"] = aurocs
            figures = [out / f"{stem}_{gt}={true_class}.svg" for stem in ("roc-curve", "pr-curve")]
        elif fields["task"] == "regression":
            tables = [pd.read_csv(out / f"t_regression-stats_{kind}.csv", index_col=0)
                      for kind in ("individual", "aggregated")]  # fmt: skip
            row["r2_score"] = float(tables[0]["r2_score"].iloc[0])
            figures = [out / "plots" / f"fold_{k}_scatter.svg" for k in keys]
        else:
            tables = [pd.read_csv(out / "survival-stats_individual.csv", index_col=0)]
            row["c_index"] = float(tables[0]["c_index"].iloc[0])
            figures = [out / "plots" / f"fold_{k}_km_curve.svg" for k in keys]
        for table in tables:
            values = table.select_dtypes("number").to_numpy(float)
            if not values.size or not np.isfinite(values).all():
                _fail(f"statistics {name}: a table is empty or not finite:\n{table}")
        _figures_accounted(figures, warnings)
        row["figures_not_written"] = sum(not f.is_file() for f in figures)
        print(f"[10 statistics] {json.dumps(row)} on {card}")
        rows[name] = row
    return rows


def _write_heatmap_slides(root: Path) -> None:
    """Synthetic TIFF slides (``HEATMAP_MPP`` µm/px) of ``HEATMAP_TILES``
    tiles on a square grid of 256 µm, and their UNI2 feature files (1,536
    wide, fp16, the port's writer)."""
    import numpy as np
    from PIL import Image

    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(9)
    px = int(256.0 / HEATMAP_MPP)
    for n in HEATMAP_TILES:
        side = math.isqrt(n - 1) + 1
        cells = np.stack([np.arange(n) % side, np.arange(n) // side], axis=1)
        image = np.full((side * px, side * px, 3), 255, np.uint8)
        image[: (n // side) * px] = rng.integers(60, 200, ((n // side) * px, side * px, 3), dtype=np.uint8)
        (root / "wsi").mkdir(parents=True, exist_ok=True)
        Image.fromarray(image).save(root / "wsi" / f"slide-{n}.tif")
        write_tile_feats_atomic(
            output_path=root / "features" / f"slide-{n}.h5",
            feats=rng.standard_normal((n, UNI2_DIM), dtype=np.float32).astype(np.float16),
            coords_um=(cells * 256.0).astype(np.float32), extractor_id="uni2", tile_size_um=256.0,
            tile_size_px=224, code_hash="chip-smoke",
        )  # fmt: skip


def _top_sets_agree(cam, plain, k: int, tol: float) -> tuple[bool, int]:
    """(agree, tested): the k highest tiles of each category are the same set
    on both paths wherever the plain cam's gap at rank k exceeds ``tol`` ·
    max |plain|; ``tested`` counts the categories where it does."""
    import numpy as np

    tested = 0
    for got, want in zip(cam, plain):
        order = np.argsort(-want)
        if want[order[k - 1]] - want[order[k]] > tol * np.abs(plain).max():
            tested += 1
            if set(order[:k]) != set(np.argsort(-got)[:k]):
                return False, tested
    return True, tested


def _profile_gradcam(card: str, what: str, fn) -> dict:
    """Device time of one Grad-CAM (``torch.profiler``): the flash forward's
    kernels, the distance-weighted sum's, each backward kernel, the rest
    (GEMMs, elementwise), and the host time (wall − device busy)."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    wall_ms = (time.perf_counter() - t0) * 1e3
    device = {e.key: (e.device_time_total / 1e3, e.count) for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA") and e.device_time_total > 0}  # fmt: skip
    parts = ({f"fwd_{k}": v for k, v in _FWD_KERNELS.items()} | _DWS_KERNELS
             | {f"bwd_{k}": v for k, v in _BWD_KERNELS.items()})  # fmt: skip
    split = {}
    for part, tag in parts.items():
        hits = [(ms, n) for key, (ms, n) in device.items() if tag in key]
        split[f"{part}_ms"] = sum(ms for ms, _ in hits)
        split[f"{part}_calls"] = sum(n for _, n in hits)
    busy = sum(ms for ms, _ in device.values())
    split |= dict(other_device_ms=busy - sum(split[f"{p}_ms"] for p in parts), device_busy_ms=busy,
                  wall_ms=wall_ms, host_ms=wall_ms - busy)  # fmt: skip
    print(f"[11 heatmaps] profile {what} (profiled wall): {json.dumps(split)} on {card}")
    return split


def _alibi_softmax_branch_cam(module, feats, coords, n_categories: int) -> dict:
    """The ALiBi cam with every block's ``bias_scale`` zeroed, kernel path
    against plain path: the distance term then adds nothing, so the cam
    comes through the softmax branch of rows 6 and 7 alone (in the whole
    model's cam the distance term, about T times larger, hides it).  Rows
    6, 7 and 8 still launch, which the counters show."""
    import numpy as np
    import torch

    from stamp_tpu_torch.heatmaps import generate as gen
    from stamp_tpu_torch.ops import flash_attention as attn

    scales = [m.bias_scale for m in module.modules() if hasattr(m, "bias_scale")]
    kept = [p.detach().clone() for p in scales]
    try:
        with torch.no_grad():
            for p in scales:
                p.zero_()
        for name in _COUNTERS:
            setattr(attn, name, 0)
        _, cam = gen._cams(module, feats, coords)
        counts = {name: getattr(attn, name) for name in _COUNTERS if getattr(attn, name)}
        with _plain_flash():
            _, plain = gen._cams(module, feats, coords)
    finally:
        with torch.no_grad():
            for p, value in zip(scales, kept):
                p.copy_(value)
    err = float(np.abs(cam - plain).max() / np.abs(plain).max())
    top, tested = _top_sets_agree(cam, plain, HEATMAP_TOPK, CAM_TOL)
    expected = {"FLASH_ALIBI_MHA_LAUNCHES": MIL_LAYERS, "FLASH_ALIBI_MHA_BWD_LAUNCHES": MIL_LAYERS * n_categories,
                "DIST_WEIGHTED_SUM_LAUNCHES": MIL_LAYERS * n_categories}  # fmt: skip
    ok = err <= CAM_TOL and top and counts == expected and bool(np.isfinite(cam).all())
    return dict(cam_rel_err=err, cam_tol=CAM_TOL, top_sets_agree=top, top_categories_tested=tested,
                launches=counts, ok=ok)  # fmt: skip


def phase_heatmaps(card: str) -> dict:
    """11: ``python -m stamp_tpu_torch -c config.yaml --profile heatmaps``
    in-process, per slide, with phase 7's trained checkpoints (``vit`` and
    ``vit`` + ALiBi at the default width) on synthetic UNI2 slides of
    ``HEATMAP_TILES`` tiles: the ``plots/``, ``raw/`` and ``tiles/`` tree;
    2 forward launches and 2 × C backward launches per slide of T ≥ 4,096
    and none below; the pre-softmax cam on the kernel path against the
    plain path at T = 6,001 and 20,001 (``CAM_TOL``, and the top-k tile
    sets), at T = 20,001 for ALiBi also with ``bias_scale`` zeroed (the
    softmax branch alone); each category's cam bitwise the same alone and
    after another's backward (the retained graph); seconds per slide and a
    ``torch.profiler`` split of the 20,000-tile ALiBi slide's Grad-CAM."""
    import numpy as np
    import torch
    import yaml

    from stamp_tpu_torch.heatmaps import generate as gen
    from stamp_tpu_torch.io.h5 import read_feats
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.models import vision_transformer as vit
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.utils import profiling

    root = WORK / "heatmaps"
    _write_heatmap_slides(root)
    dev = torch.device("cuda:0")
    launches = {name: 0 for name in _COUNTERS}
    slides, checks = [], []
    for variant in ("vit", "alibi"):
        ckpt = WORK / "train" / variant / "model.ckpt"  # phase 7's
        model, variables = load_model_from_ckpt(ckpt)
        categories = list(model.categories)
        for n in HEATMAP_TILES:
            stem = f"slide-{n}"
            out = root / "out" / variant
            config = root / f"{variant}-{n}.yaml"
            config.write_text(yaml.safe_dump({"heatmaps": {
                "output_dir": str(out), "feature_dir": str(root / "features"), "wsi_dir": str(root / "wsi"),
                "checkpoint_path": str(ckpt), "slide_paths": [f"{stem}.tif"], "device": "cuda",
                "default_slide_mpp": HEATMAP_MPP, "topk": HEATMAP_TOPK, "bottomk": HEATMAP_TOPK,
            }}))  # fmt: skip
            for name in _COUNTERS:
                setattr(attn, name, 0)
            t0 = time.perf_counter()
            with _kept_warnings() as warnings:
                _staged_cli(["-c", str(config), "heatmaps"])  # exits non-zero on failure
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = {name: getattr(attn, name) for name in _COUNTERS}
            flash = n + 1 >= vit.FLASH_ATTENTION_MIN_SEQ
            fwd, bwd = ("FLASH_ALIBI_MHA_LAUNCHES", "FLASH_ALIBI_MHA_BWD_LAUNCHES") if variant == "alibi" else (
                "FLASH_MHA_LAUNCHES", "FLASH_MHA_BWD_LAUNCHES")  # fmt: skip
            expected = {name: 0 for name in _COUNTERS}
            if flash:
                expected[fwd] = MIL_LAYERS
                expected[bwd] = MIL_LAYERS * len(categories)
                if variant == "alibi":
                    expected["DIST_WEIGHTED_SUM_LAUNCHES"] = MIL_LAYERS * len(categories)
            if counts != expected:
                _fail(f"heatmaps {variant} {stem}: launches {counts}, expected {expected} "
                      f"({MIL_LAYERS} layers, {len(categories)} categories, T = {n + 1})")  # fmt: skip
            for name in _COUNTERS:
                launches[name] += counts[name]

            # the tree: raw/ and tiles/ complete, plots/ as matplotlib allows
            slide_dir = out / stem
            raw = {p.name for p in (slide_dir / "raw").iterdir()}
            panels = {f"{stem}-{c}" for c in categories}
            want_raw = {f"thumbnail-{stem}.png", f"{stem}-classmap.png",
                        *(f"raw-overlay-{stem}-{c}.png" for c in categories)}  # fmt: skip
            probability_panels = {r.split("=")[0] for r in raw if "=" in r}  # {stem}-{category}={p}.png
            if not want_raw <= raw or probability_panels != panels or len(raw) != len(want_raw) + len(panels):
                _fail(f"heatmaps {variant} {stem}: raw/ holds {sorted(raw)}")
            tiles = list((slide_dir / "tiles").iterdir())
            if len(tiles) != 2 * HEATMAP_TOPK:
                _fail(f"heatmaps {variant} {stem}: {len(tiles)} tile crops, expected {2 * HEATMAP_TOPK}")
            figures = [slide_dir / "plots" / f"overview-{stem}.png",
                       *(slide_dir / "plots" / f"overlay-{stem}-{c}.png" for c in categories)]  # fmt: skip
            _figures_accounted(figures, warnings)
            stages = {k.split("/")[1]: v for k, v in profiling.timer.seconds.items() if k.startswith("heatmaps/")}
            row = dict(variant=variant, tiles=n, seq_len=n + 1, seconds=wall,
                       launches={k: v for k, v in counts.items() if v}, stages_s=stages)  # fmt: skip
            print(f"[11 heatmaps] {json.dumps(row)} on {card}")
            slides.append(row)

        # Grad-CAM on the kernel path against the plain path, and the
        # retained graph, on the whole-slide bags
        module = model.module
        module.load_state_dict(vit.variables_from_jax(variables))
        module.to(dev).eval()
        for n in HEATMAP_TILES:
            if n + 1 < vit.FLASH_ATTENTION_MIN_SEQ:
                continue
            feats, info = read_feats(root / "features" / f"slide-{n}.h5")
            coords = info.coords_um
            t1 = time.perf_counter()
            logits, cam = gen._cams(module, feats, coords)
            cam_ms = (time.perf_counter() - t1) * 1e3
            with _plain_flash():
                t1 = time.perf_counter()
                plain_logits, plain = gen._cams(module, feats, coords)
                plain_ms = (time.perf_counter() - t1) * 1e3
            err = float(np.abs(cam - plain).max() / np.abs(plain).max())
            top, top_tested = _top_sets_agree(cam, plain, HEATMAP_TOPK, CAM_TOL)
            _, last_alone = gen._cams(module, feats, coords, [len(categories) - 1])
            bitwise = bool(np.array_equal(last_alone[0], cam[-1]))
            row = dict(variant=variant, seq_len=n + 1, cam_rel_err=err, cam_tol=CAM_TOL, top_k=HEATMAP_TOPK,
                       top_sets_agree=top, top_categories_tested=top_tested, retained_graph_bitwise=bitwise,
                       gradcam_ms=cam_ms, plain_gradcam_ms=plain_ms,
                       logits_max_abs_diff=float(np.abs(logits - plain_logits).max()))  # fmt: skip
            ok = err <= CAM_TOL and top and bitwise and np.isfinite(cam).all()
            if variant == "alibi" and n == max(HEATMAP_TILES):
                row["softmax_branch"] = _alibi_softmax_branch_cam(module, feats, coords, len(categories))
                ok = ok and row["softmax_branch"]["ok"]
            print(f"[11 heatmaps] {json.dumps(row)} on {card}")
            if not ok:
                _fail(f"heatmaps {variant} T = {n + 1}: Grad-CAM kernel path against plain path {row}")
            checks.append(row)
            if variant == "alibi" and n == max(HEATMAP_TILES):
                row["profile"] = _profile_gradcam(card, f"ALiBi Grad-CAM at T = {n + 1}",
                                                  lambda: gen._cams(module, feats, coords))  # fmt: skip
        module.to("cpu")
        torch.cuda.empty_cache()
    return dict(launches=launches, slides=slides, checks=checks)


def _zoo_run(config: Path, command: str, *, allowed: tuple[str, ...] = ()) -> dict:
    """``python -m stamp_tpu_torch -c config command`` in-process with every
    launch count set to 0 before it: (wall s, the counts).  Fails if a
    counter outside ``allowed`` grew."""
    import torch

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.ops import flash_attention as attn

    counters = (*_COUNTERS, "FLASH_ALIBI2D_LAUNCHES")
    for name in counters:
        setattr(attn, name, 0)
    t0 = time.perf_counter()
    main(["-c", str(config), command])  # exits non-zero on failure
    torch.cuda.synchronize()
    launches = {name: getattr(attn, name) for name in counters}
    if stray := {k: v for k, v in launches.items() if v and k not in allowed}:
        _fail(f"{config.name} {command}: kernels of rows 4–9 launched where none should: {stray}")
    return dict(wall_s=time.perf_counter() - t0, launches=launches)


def _yaml(path: Path, body: dict) -> Path:
    import yaml

    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(body))
    return path


def _probs_ok(csv: Path, columns: list[str], rows: int):
    """The CSV as a DataFrame; fails unless its probability ``columns`` have
    ``rows`` rows, finite, each head's summing to 1."""
    import numpy as np
    import pandas as pd

    df = pd.read_csv(csv)
    probs = df[columns].to_numpy(float)
    heads = {c.rsplit("_", 1)[0] for c in columns}
    sums = [df[[c for c in columns if c.rsplit("_", 1)[0] == h]].to_numpy(float).sum(axis=1) for h in heads]
    if len(df) != rows or not np.isfinite(probs).all() or not np.allclose(sums, 1.0, atol=1e-5):
        _fail(f"{csv}: {len(df)} rows (expected {rows}), probabilities {probs}")
    return df


def _device_pair(ckpt: Path):
    """(task model with its module on the card, a CPU copy of the module)
    of one checkpoint."""
    import copy

    import torch

    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.models import weights

    model, variables = load_model_from_ckpt(ckpt)
    weights.load_variables_(model.module, variables).eval()
    cpu = copy.deepcopy(model.module)
    model.module.to(torch.device(ZOO_DEVICE))
    return model, cpu


def _zoo_probs(model, module, batch, device):
    """The class probabilities (every head, concatenated) of one host batch
    through ``module`` on ``device``, padded and masked as deploy does."""
    import numpy as np
    import torch

    from stamp_tpu_torch.modeling.train import _bucket_size, _pad_tile_batch, forward_batch, host_outputs

    key_mask = None
    if model.pads_bags:
        batch, key_mask = _pad_tile_batch(batch, _bucket_size(batch[0].shape[1]))
    saved, model.module = model.module, module
    try:
        with torch.inference_mode():
            out = host_outputs(forward_batch(model, batch, key_mask, device))
    finally:
        model.module = saved
    exps = [np.exp(v - v.max(-1, keepdims=True)) for v in (out.values() if isinstance(out, dict) else [out])]
    return np.concatenate([e / e.sum(-1, keepdims=True) for e in exps], axis=-1)


def _card_vs_cpu(model, cpu_module, batch) -> float:
    """max |Δ| of the class probabilities of one host batch, on the card and
    on the CPU."""
    import numpy as np
    import torch

    card = _zoo_probs(model, model.module, batch, torch.device(ZOO_DEVICE))
    return float(np.abs(card - _zoo_probs(model, cpu_module, batch, torch.device("cpu"))).max())


def _write_zoo_slides(root: Path) -> None:
    """CONCH1.5 tile features of ``ZOO_SLIDE_TILES`` (768 wide, fp16, the
    port's writer), a slide table per level (each slide its own patient;
    two slides a patient) and their clini tables (alternating labels)."""
    import numpy as np
    import pandas as pd

    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(12)
    slides = [f"zoo-{i:02d}" for i in range(len(ZOO_SLIDE_TILES))]
    for name, n in zip(slides, ZOO_SLIDE_TILES):
        write_tile_feats_atomic(
            output_path=root / "features" / f"{name}.h5",
            feats=rng.standard_normal((n, 768), dtype=np.float32).astype(np.float16),
            coords_um=(_tissue_grid(n) * 256.0).astype(np.float32), extractor_id="conch1_5",
            tile_size_um=256.0, tile_size_px=224, code_hash="chip-smoke",
        )  # fmt: skip
    patients = [f"zoo-patient-{i // 2:02d}" for i in range(len(slides))]
    labels = ["neg", "pos"]
    pd.DataFrame({"PATIENT": slides, "FILENAME": [f"{s}.h5" for s in slides]}).to_csv(root / "slide.csv", index=False)
    pd.DataFrame({"PATIENT": slides, "label": [labels[i % 2] for i in range(len(slides))]}).to_csv(
        root / "clini-slide.csv", index=False
    )
    pd.DataFrame({"PATIENT": patients, "FILENAME": [f"{s}.h5" for s in slides]}).to_csv(
        root / "patients.csv", index=False
    )
    unique = sorted(set(patients))
    pd.DataFrame({"PATIENT": unique, "label": [labels[i % 2] for i in range(len(unique))]}).to_csv(
        root / "clini-patient.csv", index=False
    )


def _zoo_slide_and_patient_level(card: str, root: Path) -> dict:
    """12a: TITAN ``encode_slides`` and ``encode_patients``, then ``train``
    and ``deploy`` of ``mlp`` and ``linear`` on the slide features, of
    ``mlp`` on the patient features, and the slide-level ``mlp`` deployed on
    the patient features."""
    import numpy as np

    _write_zoo_slides(root)
    os.environ["STAMP_RANDOM_WEIGHTS"] = "1"
    result: dict = {}
    for command, section in (("encode_slides", "slide_encoding"), ("encode_patients", "patient_encoding")):
        fields = {"encoder": "titan", "output_dir": str(root / "encoded"), "feat_dir": str(root / "features"),
                  "device": ZOO_DEVICE, "generate_hash": False}  # fmt: skip
        if command == "encode_patients":
            fields["slide_table"] = str(root / "patients.csv")
        run = _zoo_run(_yaml(root / f"{command}.yaml", {section: fields}), command,
                       allowed=("FLASH_ALIBI2D_LAUNCHES",))  # fmt: skip
        big = sum(n >= 2048 for n in ZOO_SLIDE_TILES) if command == "encode_slides" else len(ZOO_SLIDE_TILES) // 2
        if run["launches"]["FLASH_ALIBI2D_LAUNCHES"] != TITAN_LAYERS * big:
            _fail(f"{command}: flash_alibi2d_mha launches {run['launches']}, expected {TITAN_LAYERS} × {big}")
        result[command] = dict(wall_s=run["wall_s"], flash_alibi2d_launches=TITAN_LAYERS * big)
    slide_feats, patient_feats = root / "encoded" / "titan-slide", root / "encoded" / "titan-pat"
    n_slides, n_patients = len(ZOO_SLIDE_TILES), len(ZOO_SLIDE_TILES) // 2

    def train_and_deploy(name: str, model_name: str, feats: Path, clini: Path, slide_table: Path, rows: int) -> Path:
        advanced = {"model_name": model_name, "batch_size": 4, "max_epochs": ZOO_EPOCHS, "seed": 0,
                    "accelerator": ZOO_DEVICE, "num_workers": 4, "model_params": {}}  # fmt: skip
        train = _zoo_run(_yaml(root / f"{name}-train.yaml", {"training": {
            "output_dir": str(root / name), "clini_table": str(clini), "slide_table": str(slide_table),
            "feature_dir": str(feats), "ground_truth_label": "label", "task": "classification",
        }, "advanced_config": advanced}), "train")  # fmt: skip
        deploy = _deploy_zoo(root, f"{name}-deploy", root / name / "model.ckpt", feats, clini, slide_table, "label")
        _probs_ok(deploy["csv"], ["label_neg", "label_pos"], rows)
        result[name] = dict(train_s=train["wall_s"], deploy_s=deploy["wall_s"])
        return root / name / "model.ckpt"

    mlp = train_and_deploy("slide-mlp", "mlp", slide_feats, root / "clini-slide.csv", root / "slide.csv", n_slides)
    linear = train_and_deploy("slide-linear", "linear", slide_feats, root / "clini-slide.csv", root / "slide.csv",
                              n_slides)  # fmt: skip
    patient_mlp = train_and_deploy("patient-mlp", "mlp", patient_feats, root / "clini-patient.csv",
                                   root / "patients.csv", n_patients)  # fmt: skip
    across = _deploy_zoo(root, "slide-mlp-on-patients", mlp, patient_feats, root / "clini-patient.csv",
                         root / "patients.csv", "label")  # fmt: skip
    _probs_ok(across["csv"], ["label_neg", "label_pos"], n_patients)
    result["slide-mlp-on-patients"] = dict(deploy_s=across["wall_s"])

    from stamp_tpu_torch.io.h5 import read_h5

    for name, ckpt, path in (("slide-mlp", mlp, slide_feats / "zoo-23.h5"), ("slide-linear", linear, slide_feats / "zoo-23.h5"),
                             ("patient-mlp", patient_mlp, patient_feats / "zoo-patient-11.h5")):  # fmt: skip
        model, cpu = _device_pair(ckpt)
        feats = read_h5(path)[0]["feats"].astype(np.float32)[None]
        diff = _card_vs_cpu(model, cpu, (feats, None))
        result[name] |= dict(card_vs_cpu_prob_max_abs_diff=diff)
        if not diff <= ZOO_PROB_TOL:
            _fail(f"{name}: card against CPU probabilities {diff} > {ZOO_PROB_TOL}")
    print(f"[12a zoo slide/patient] {json.dumps(result)} on {card}")
    return result


def _deploy_zoo(root: Path, name: str, ckpt: Path, feats: Path, clini: Path, slide_table: Path, label) -> dict:
    run = _zoo_run(_yaml(root / f"{name}.yaml", {"deployment": {
        "output_dir": str(root / name), "checkpoint_paths": [str(ckpt)], "clini_table": str(clini),
        "slide_table": str(slide_table), "feature_dir": str(feats), "ground_truth_label": label,
        "accelerator": ZOO_DEVICE,
    }}), "deploy")  # fmt: skip
    return dict(wall_s=run["wall_s"], csv=root / name / "patient-preds.csv")


def _write_multi_target_clini(root: Path) -> Path:
    """Phase 7's twelve patients with ``ZOO_TARGETS``, assigned in each of
    the two folds the port draws (``KFold``, shuffled, seed 0) so that every
    class is in both training halves (a fold's head has the classes of its
    training patients, in both packages)."""
    import numpy as np
    import pandas as pd

    from stamp_tpu_torch.modeling.splits import KFold

    patients = np.array([f"pat{i:02d}" for i in range(len(TRAIN_TILES))])
    values = {target: np.empty(len(patients), object) for target in ZOO_TARGETS}
    for _, test in KFold(n_splits=2, shuffle=True, random_state=0).split(patients):
        for target, classes in ZOO_TARGETS.items():
            values[target][test] = [classes[j % len(classes)] for j in range(len(test))]
    path = root / "clini-multi.csv"
    pd.DataFrame({"PATIENT": patients, **values}).to_csv(path, index=False)
    return path


def _zoo_tile_level(card: str, root: Path) -> dict:
    """12b: ``crossval`` (2 folds, 2 epochs, ``bag_size`` 512) and ``deploy``
    (fold 0's checkpoint, full bags) of ``trans_mil`` and of multi-target
    ``barspoon`` on phase 7's cohort, ``statistics`` of the barspoon CSV;
    no launch of rows 4–8.  The card against the CPU on the 2,100-tile
    patient, a training step at bag 512 and a forward at 12,000 tiles."""
    import numpy as np
    import pandas as pd
    import torch

    from stamp_tpu_torch.modeling.data import BagDataset
    from stamp_tpu_torch.modeling.train import forward_batch

    cohort = WORK / "train"  # phase 7's
    multi_clini = _write_multi_target_clini(root)
    runs = {
        "trans_mil": dict(clini=cohort / "clini.csv", label="label", columns=["label_neg", "label_pos"]),
        "barspoon": dict(clini=multi_clini, label=list(ZOO_TARGETS),
                         columns=[f"{t}_{c}" for t, classes in ZOO_TARGETS.items() for c in classes]),
    }  # fmt: skip
    result: dict = {}
    for model_name, run in runs.items():
        out = root / f"{model_name}-crossval"
        cv = _zoo_run(_yaml(root / f"{model_name}-crossval.yaml", {"crossval": {
            "output_dir": str(out), "clini_table": str(run["clini"]), "slide_table": str(cohort / "slide.csv"),
            "feature_dir": str(cohort / "features"), "ground_truth_label": run["label"], "task": "classification",
            "n_splits": 2,
        }, "advanced_config": {
            "model_name": model_name, "max_epochs": ZOO_EPOCHS, "batch_size": 2, "seed": 0, "accelerator": ZOO_DEVICE,
            "num_workers": 4, "model_params": {},
        }}), "crossval")  # fmt: skip
        held_out = sum(len(_probs_ok(out / f"split-{f}" / "patient-preds.csv", run["columns"], 6)) for f in range(2))
        if held_out != len(TRAIN_TILES):
            _fail(f"{model_name} crossval: folds export {held_out} patients, expected {len(TRAIN_TILES)}")
        ckpt = out / "split-0" / "model.ckpt"
        deploy = _deploy_zoo(root, f"{model_name}-deploy", ckpt, cohort / "features", run["clini"],
                             cohort / "slide.csv", run["label"])  # fmt: skip
        df = _probs_ok(deploy["csv"], run["columns"], len(TRAIN_TILES))
        row = dict(crossval_s=cv["wall_s"], deploy_s=deploy["wall_s"], csv_columns=list(df.columns))

        model, cpu = _device_pair(ckpt)
        dev = torch.device(ZOO_DEVICE)

        def whole_bag(patient: str):
            ds = BagDataset(bags=[[cohort / "features" / f"{patient}.h5"]], ground_truths=np.zeros((1, 1)))
            feats, coords, size, _ = ds[0]
            return feats[None], coords[None], np.array([size]), None

        row["card_vs_cpu_prob_max_abs_diff"] = _card_vs_cpu(model, cpu, whole_bag("pat00"))
        if not row["card_vs_cpu_prob_max_abs_diff"] <= ZOO_PROB_TOL:
            _fail(f"{model_name}: card against CPU probabilities {row} > {ZOO_PROB_TOL}")
        largest = whole_bag(f"pat{len(TRAIN_TILES) - 1:02d}")  # 12,000 tiles
        row["deploy_forward_ms_12000_tiles"] = statistics.median(
            _time_ms(lambda: _zoo_probs(model, model.module, largest, dev), 3)
        )
        _profile_forward(card, f"{model_name} deploy forward at 12,000 tiles",
                         lambda: (None, 1e3 * _timed(lambda: _zoo_probs(model, model.module, largest, dev))),
                         tag="12b zoo tile")  # fmt: skip

        # one training step at bag 512, batch 2 (forward, loss, backward, update)
        rng = np.random.default_rng(13)
        bags = rng.standard_normal((2, 512, UNI2_DIM), dtype=np.float32)
        coords = (rng.integers(0, 100, (2, 512, 2)) * 256.0).astype(np.float32)
        if model_name == "barspoon":
            targets = {t: torch.eye(len(c), device=dev)[:2] for t, c in ZOO_TARGETS.items()}
        else:
            targets = torch.eye(2, device=dev)
        optimizer = model.make_optimizer(model.module.parameters())
        generator = torch.Generator(dev).manual_seed(0)

        def step():
            loss = model.loss(forward_batch(model, (bags, coords, None, None), None, dev, train=True,
                                            generator=generator), targets)  # fmt: skip
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()

        row["train_step_ms_bag_512"] = statistics.median(_time_ms(step, 5))
        _profile_forward(card, f"{model_name} training step at bag 512", lambda: (None, 1e3 * _timed(step)),
                         tag="12b zoo tile")  # fmt: skip
        model.module.to("cpu")
        del cpu, optimizer
        torch.cuda.empty_cache()
        result[model_name] = row
        print(f"[12b zoo tile] {model_name} {json.dumps(row)} on {card}")

    stats = _zoo_run(_yaml(root / "statistics.yaml", {"statistics": {
        "task": "classification", "ground_truth_label": list(ZOO_TARGETS), "output_dir": str(root / "statistics"),
        "pred_csvs": [str(root / "barspoon-deploy" / "patient-preds.csv")],
    }}), "statistics")  # fmt: skip
    for target in ZOO_TARGETS:
        table = pd.read_csv(root / "statistics" / f"{target}_categorical-stats_individual.csv", index_col=[0, 1])
        if len(table) != len(ZOO_TARGETS[target]) or not np.isfinite(table["roc_auc_score"].to_numpy(float)).all():
            _fail(f"statistics of the multi-target CSV, {target}:\n{table}")
    result["statistics_s"] = stats["wall_s"]
    return result


def _zoo_heatmaps(card: str, root: Path) -> dict:
    """12c: ``heatmaps`` of phase 11's 6,000-tile slide with 12b's fold-0
    ``trans_mil`` and multi-target ``barspoon`` checkpoints: one file tree
    per target, no launch of rows 4–8, the cams on the card against the
    CPU."""
    import numpy as np
    import torch

    from stamp_tpu_torch.heatmaps import generate as gen
    from stamp_tpu_torch.io.h5 import read_feats
    from stamp_tpu_torch.models.barspoon import sanitize

    slides = WORK / "heatmaps"  # phase 11's
    stem = f"slide-{HEATMAP_TILES[1]}"  # 6,000 tiles
    feats, info = read_feats(slides / "features" / f"{stem}.h5")
    result: dict = {}
    for model_name in ("trans_mil", "barspoon"):
        ckpt = root / f"{model_name}-crossval" / "split-0" / "model.ckpt"
        out = root / "heatmaps" / model_name
        run = _zoo_run(_yaml(root / f"{model_name}-heatmaps.yaml", {"heatmaps": {
            "output_dir": str(out), "feature_dir": str(slides / "features"), "wsi_dir": str(slides / "wsi"),
            "checkpoint_path": str(ckpt), "slide_paths": [f"{stem}.tif"], "device": ZOO_DEVICE,
            "default_slide_mpp": HEATMAP_MPP, "topk": HEATMAP_TOPK, "bottomk": HEATMAP_TOPK,
        }}), "heatmaps")  # fmt: skip
        targets = ZOO_TARGETS if model_name == "barspoon" else {None: ["neg", "pos"]}
        raw = {p.name for p in (out / stem / "raw").iterdir()}
        for target, classes in targets.items():
            tstem = stem if target is None else f"{stem}-{sanitize(target)}"
            want = {f"thumbnail-{tstem}.png", f"{tstem}-classmap.png", *(f"raw-overlay-{tstem}-{c}.png" for c in classes)}
            panels = {r.split("=")[0] for r in raw if r.startswith(f"{tstem}-") and "=" in r}
            if not want <= raw or panels != {f"{tstem}-{c}" for c in classes}:
                _fail(f"heatmaps {model_name}: raw/ lacks the set of {tstem}: {sorted(raw)}")
        tiles = len(list((out / stem / "tiles").iterdir()))
        if tiles != 2 * HEATMAP_TOPK * len(targets):
            _fail(f"heatmaps {model_name}: {tiles} tile crops, expected {2 * HEATMAP_TOPK * len(targets)}")

        model, cpu = _device_pair(ckpt)
        outputs = [(t, i) for t, c in ZOO_TARGETS.items() for i in range(len(c))] if model_name == "barspoon" else None
        coords = info.coords_um

        def rel(a, b) -> float:
            return float(np.abs(a - b).max() / np.abs(b).max())

        _, cam = gen._cams(model.module, feats, coords, outputs)
        _, cpu_cam = gen._cams(cpu, feats, coords, outputs)
        row = dict(seconds_per_slide=run["wall_s"], tiles=len(feats), cam_rows=len(cam),
                   finite=bool(np.isfinite(cam).all()), cam_card_vs_cpu_rel_err=rel(cam, cpu_cam))  # fmt: skip
        err = row["cam_card_vs_cpu_rel_err"]
        if model_name == "barspoon":
            # barspoon's f32 cam is ill-conditioned: the CPU's own cam moves
            # by this much when every feature moves by one ulp, so the card
            # is held to the CPU in f64 (the same code on both devices), and
            # the f32 distances are printed
            # (the first category of each target: the CPU's f64 backward
            # passes are the slow part of the phase)
            held = [outputs.index((t, 0)) for t in ZOO_TARGETS]
            _, nudged = gen._cams(cpu, feats * np.float32(1 + 2**-23), coords, [outputs[i] for i in held])
            _, cam64 = gen._cams(model.module.double(), feats, coords, [outputs[i] for i in held])
            _, cpu_cam64 = gen._cams(cpu.double(), feats, coords, [outputs[i] for i in held])
            row |= dict(cam_f32_cpu_one_ulp_sensitivity=rel(nudged, cpu_cam[held]),
                        cam_f64_card_vs_cpu_rel_err=rel(cam64, cpu_cam64), cam_f64_rows=len(held))  # fmt: skip
            # why the encoding's powers are taken on the CPU: the card's f32
            # pow of the same exponents, against the CPU's
            exponents = torch.arange(ZOO_WIDTH // 4, dtype=torch.float32) / ZOO_WIDTH
            card_pow = (100_000 ** exponents.to(ZOO_DEVICE)).cpu()
            row["encoding_powers_differing_on_the_card"] = int((card_pow != 100_000**exponents).sum())
            err = row["cam_f64_card_vs_cpu_rel_err"]
        model.module.to("cpu")
        if not (err <= ZOO_CAM_TOL and row["finite"]):
            _fail(f"heatmaps {model_name}: cams card against CPU {row}")
        print(f"[12c zoo heatmaps] {model_name} {json.dumps(row)} on {card}")
        result[model_name] = row
    return result


def _zoo_interop(card: str, root: Path) -> dict:
    """12d: ``export_ckpt`` of 12b's fold-0 checkpoints to Lightning
    ``.ckpt``, ``deploy`` from each (its CSV equal to the npz deploy's to
    1e-6), and ``export_ckpt`` back (variables bitwise the original's)."""
    import numpy as np
    import pandas as pd

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
    from stamp_tpu_torch.models import weights

    cohort = WORK / "train"
    result: dict = {}
    for model_name, clini, label in (("trans_mil", cohort / "clini.csv", "label"),
                                     ("barspoon", root / "clini-multi.csv", list(ZOO_TARGETS))):  # fmt: skip
        npz = root / f"{model_name}-crossval" / "split-0" / "model.ckpt"
        lightning = root / f"{model_name}.lightning.ckpt"
        main(["export_ckpt", str(npz), str(lightning)])
        deploy = _deploy_zoo(root, f"{model_name}-lightning-deploy", lightning, cohort / "features", clini,
                             cohort / "slide.csv", label)  # fmt: skip
        got = pd.read_csv(deploy["csv"]).set_index("PATIENT").sort_index()
        want = pd.read_csv(root / f"{model_name}-deploy" / "patient-preds.csv").set_index("PATIENT").sort_index()
        numeric = want.select_dtypes("number").columns
        diff = float(np.abs(got[numeric].to_numpy(float) - want[numeric].to_numpy(float)).max())
        if list(got.columns) != list(want.columns) or not diff <= 1e-6:
            _fail(f"{model_name}: the .ckpt deploy differs from the npz one by {diff}: {list(got.columns)}")
        main(["export_ckpt", str(lightning), str(root / f"{model_name}.back.ckpt")])
        before = weights.flatten(load_checkpoint(npz)["variables"])
        after = weights.flatten(load_checkpoint(root / f"{model_name}.back.ckpt")["variables"])
        bitwise = before.keys() == after.keys() and all(np.array_equal(before[k], after[k]) for k in before)
        if not bitwise:
            _fail(f"{model_name}: export_ckpt there and back changed the variables")
        result[model_name] = dict(lightning_vs_npz_csv_max_abs_diff=diff, round_trip_bitwise=bitwise)
    print(f"[12d zoo interop] {json.dumps(result)} on {card}")
    return result


def phase_zoo(card: str) -> dict:
    """12: the other backbones, slide and patient features, multi-target and
    the Lightning format, through the CLI at full width (random weights,
    synthetic features from fixed seeds), with the TF32 flags as PyTorch
    leaves them for the CLI (matmul off, cuDNN on: TransMIL's convolutions
    are no cuDNN calls)."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    root = WORK / "zoo"
    try:
        result = dict(
            slide_and_patient=_timed_phase("12a zoo slide/patient", _zoo_slide_and_patient_level, card, root),
            tile=_timed_phase("12b zoo tile", _zoo_tile_level, card, root),
            heatmaps=_timed_phase("12c zoo heatmaps", _zoo_heatmaps, card, root),
            interop=_timed_phase("12d zoo interop", _zoo_interop, card, root),
        )
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    return result


# 13: the other tile-extractor families (extractor/{coca_beit3,clip_like,
# ticon,swin,empty}.py) and Macenko, through ``preprocess`` on phase 4's slide
EXTRACTOR_FAMILIES = {  # name → feature width
    "conch": 512, "conch1_5": 768, "keep": 768, "ticon": 1536, "ctranspath": 768,
    "chief-ctranspath": 768, "plip": 512, "musk": 2048, "empty": 0,
}  # fmt: skip
#: the families whose towers carry rows 1–3: (blocks, LayerNorm-fed sites a
#: block, tokens) — qkv and fc1, and SwiGLU's fc2 in H-Optimus-1 (TICON's
#: tile tower); the tokens as ``ZOO_LN_SITES`` gives them below
KERNEL_FAMILIES = {"conch": (12, 2, 785), "conch1_5": (24, 2, 785), "keep": (24, 2, 197), "ticon": (40, 3, 261)}
#: GFLOP a tile at 448 px, N = 785: matmuls 2·N·12·d² a block plus attention
#: 4·N²·d (CONCH: d = 768, 12 blocks; CONCH1.5: d = 1024, 24 blocks)
TILE_GFLOP = {"conch": 156.0, "conch1_5": 536.0}
#: rows 2 and 3 at the LayerNorm-fed sites the kernel families' towers give
#: them at batch 64 (M, K, N): CoCa's 785 tokens, KEEP's 197 (ViT-L/16 at
#: 224 px), TICON's 261 (H-Optimus-1: 256 patches, CLS, 4 registers; SwiGLU
#: hidden 8,192, its inner norm → fc2 at K = 4,096)
ZOO_LN_SITES = (
    ("CONCH qkv", BATCH * 785, 768, 2304), ("CONCH fc1", BATCH * 785, 768, 3072),
    ("CONCH1.5 qkv", BATCH * 785, 1024, 3072), ("CONCH1.5 fc1", BATCH * 785, 1024, 4096),
    ("KEEP qkv", BATCH * 197, 1024, 3072), ("KEEP fc1", BATCH * 197, 1024, 4096),
    ("TICON qkv", BATCH * 261, 1536, 4608), ("TICON fc1", BATCH * 261, 1536, 8192),
    ("TICON fc2", BATCH * 261, 4096, 1536),
)  # fmt: skip
#: row 1 at KEEP's and TICON's attention (B, N, heads; d = 64), one-pass;
#: CONCH's and CONCH1.5's two-pass shapes are ``_two_pass``'s
ZOO_ATTENTION = (("KEEP", BATCH, 197, 16), ("TICON", BATCH, 261, 24))
#: the ViT arch of each family whose blocks carry LayerScale: the check
#: against the plain path builds them with γ = 1, as phase 5(b) does, since
#: at the random init's 1e-5 the blocks barely move the residual stream
LAYERSCALE_ARCH = {"keep": "uni", "ticon": "h_optimus"}
#: least per-tile cosine of phase 13's bf16 features (and ImageViT outputs)
#: on the card against the plain path or the port's CPU forward
ZOO_COSINE_MIN = 0.999
#: the same in int8.  W8A8 turns a rounding-sized change of a site's input
#: into a few activations one quantization step off, a larger change in L2;
#: in TICON's 40-block tile tower at γ = 1 that makes the plain attention
#: alone (0.99964 in bf16) part the int8 output by ~0.009 in cosine.  Rows 2
#: and 3 are held at these very shapes to KERNEL_TOL and one step
#: (``_zoo_sites``)
ZOO_INT8_COSINE_MIN = 0.99
#: TICON's int8 features: its W8A8 encoder re-rolls its quantization error
#: on any change in the tile embedding, so they part by about what int8
#: parts from bf16 (INT8_COSINE_MIN, phase 4's bound of that)
TICON_INT8_COSINE_MIN = INT8_COSINE_MIN
#: Macenko on tiles of uniform noise (phase 4's slide): the most the 99th
#: percentile of |Δ| may reach, card against the CPU and f32 against f64,
#: which rounding alone passes (tests/test_macenko_groundtruth.py's p99).
#: The max is printed, not bounded: such a tile's OD covariance is nearly
#: isotropic, so the f32 summation order of the covariance can turn its
#: stain plane (see ``_macenko_on_card``)
MACENKO_P99 = 2
#: CONCH's tokens: (448 / 16)² patches + CLS
CONCH_TOKENS = 785
#: tiles the card's features are held to the CPU's for the families without a kernel
ZOO_CPU_TILES = {"musk": 1}


def _zoo_counts() -> dict:
    """Every launch counter of rows 1–9, by name."""
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd

    counts = {"fused_qkv_mha": attn.LAUNCHES, "fused_qkv_long": attn.LONG_LAUNCHES, "ln_dense": lnd.LAUNCHES,
              "ln_quant_dense": lnd.QUANT_LAUNCHES}  # fmt: skip
    return counts | {name: getattr(attn, name) for name in (*_COUNTERS, "FLASH_ALIBI2D_LAUNCHES")}


def _zero_counts() -> None:
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd

    attn.LAUNCHES = attn.LONG_LAUNCHES = lnd.LAUNCHES = lnd.QUANT_LAUNCHES = 0
    for name in (*_COUNTERS, "FLASH_ALIBI2D_LAUNCHES"):
        setattr(attn, name, 0)


def _extract_run(card: str, family: str, root: Path, slides: Path, *, int8: bool = False, macenko: bool = False):
    """``preprocess`` of ``family`` through the CLI in-process (random weights,
    batch 64) with every launch count set to 0 before it: the h5 contract,
    the counts, the forward's seconds."""
    import numpy as np
    import torch

    from stamp_tpu_torch.io.h5 import read_h5
    from stamp_tpu_torch.preprocessing import extract

    out = root / f"{family}{'-int8' if int8 else ''}{'-macenko' if macenko else ''}"
    section = {"output_dir": str(out), "wsi_dir": str(slides), "extractor": family, "device": "cuda",
               "generate_hash": False, "default_slide_mpp": 1.0, "max_workers": 4,
               "extractor_precision": "int8" if int8 else "bfloat16", "macenko_normalization": macenko}  # fmt: skip
    config = _yaml(root / f"{out.name}.yaml", {"preprocessing": section})
    _zero_counts()
    t0 = time.perf_counter()
    _staged_cli(["-c", str(config), "preprocess"])  # exits non-zero on failure
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _zoo_counts()
    h5s = sorted(out.rglob("*.h5"))
    dir_name = family + ("-int8" if int8 else "")
    if len(h5s) != 1 or h5s[0].parent.name != dir_name:
        _fail(f"{family}: expected one h5 under {out / dir_name}, found {h5s}")
    datasets, attrs = read_h5(h5s[0])
    feats, coords = _sorted_by_coords(datasets)
    n, width = len(coords), EXTRACTOR_FAMILIES[family]
    if datasets["feats"].dtype != np.float16 or feats.shape != (n, width) or not np.isfinite(feats).all():
        _fail(f"{family}: feats {datasets['feats'].dtype} {feats.shape}, expected finite float16 [{n}, {width}]")
    if width and not np.abs(feats).max() > 0:
        _fail(f"{family}: all-zero features")
    if attrs["extractor"] != family or attrs.get("precision") != ("int8" if int8 else None):
        _fail(f"{family}: attrs {attrs}")
    timer = extract.profiling.timer.seconds
    row = dict(family=family, precision="int8" if int8 else "bfloat16", macenko=macenko, tiles=n,
               batches=math.ceil(n / BATCH), launches={k: v for k, v in launches.items() if v}, wall_s=wall,
               forward_s=timer["extract/forward"], macenko_s=timer.get("preprocess/macenko"))  # fmt: skip
    print(f"[13 extractor zoo] preprocess {json.dumps(row)} on {card}")
    return row, feats, coords


def _expected_counts(family: str, batches: int, int8: bool) -> dict:
    """Rows 1–3's launches of one ``preprocess``: attention at every block
    of every forward (the int8 calibration forward too; a family of more
    than ``ONE_PASS_MAX_N`` tokens through the two-pass kernel,
    ``fused_qkv_long``: CONCH's and CONCH1.5's 785, 12 and 24 a batch), the
    LayerNorm-fed sites through ``ln_dense`` or, in int8,
    ``ln_quant_dense``."""
    from stamp_tpu_torch.ops import flash_attention as attn

    blocks, sites, tokens = KERNEL_FAMILIES.get(family, (0, 0, 0))
    forwards = batches + (1 if int8 and blocks else 0)
    long_form = tokens > attn.ONE_PASS_MAX_N
    return {"fused_qkv_mha": blocks * forwards, "fused_qkv_long": blocks * forwards if long_form else 0,
            "ln_dense": 0 if int8 else blocks * sites * batches,
            "ln_quant_dense": blocks * sites * batches if int8 else 0}  # fmt: skip


def _family_extractor(family: str, device, int8: bool = False):
    from stamp_tpu_torch.preprocessing.extractor import set_int8_extraction
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    set_int8_extraction(int8)
    try:
        return resolve_extractor(family, device)
    finally:
        set_int8_extraction(None)


def _cosines(got, want) -> tuple[float, float]:
    import torch

    got, want = torch.as_tensor(got).double().cpu(), torch.as_tensor(want).double().cpu()
    return torch.nn.functional.cosine_similarity(got, want, dim=-1).min().item(), (got - want).abs().max().item()


@contextlib.contextmanager
def _layerscale_one(family: str):
    """Extractors of ``family`` built within the block get LayerScale γ = 1
    in every block (``LAYERSCALE_ARCH``)."""
    from stamp_tpu_torch.models.vit_image import VIT_CONFIGS

    arch = LAYERSCALE_ARCH.get(family)
    if arch is None:
        yield
        return
    saved = VIT_CONFIGS[arch]
    VIT_CONFIGS[arch] = dataclasses.replace(saved, init_values=1.0)
    try:
        yield
    finally:
        VIT_CONFIGS[arch] = saved


def _forward_and_vit(ext, tiles):
    """``ext.forward(tiles)`` and, where the extractor's blocks are an
    ``ImageViT`` (KEEP's trunk, TICON's tile tower), what that tower
    returned for these tiles in the last of its forwards (None else)."""
    import torch

    from stamp_tpu_torch.models.vit_image import ImageViT

    seen = []

    def hook(module, args, output):
        if isinstance(module, ImageViT):
            seen.append(output)

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    try:
        feats = ext.forward(tiles)
    finally:
        handle.remove()
    return feats, (seen[-1][: len(tiles)].float() if seen else None)


def _zoo_against_plain(card: str, family: str, int8: bool) -> dict:
    """A kernel family's extractor on the card: 8 tiles on the kernel path
    against the plain path (the same weights, LayerScale γ = 1, and, in
    int8, the same calibration, on its first batch padded to 64).  The
    features, and the ImageViT's output where there is one, per-tile
    cosine ≥ ``ZOO_COSINE_MIN`` (bf16) or ``ZOO_INT8_COSINE_MIN`` (int8);
    TICON's int8 features ≥ ``TICON_INT8_COSINE_MIN`` (see there)."""
    import numpy as np
    import torch

    from stamp_tpu_torch.models import vit_image

    with _layerscale_one(family):
        ext = _family_extractor(family, torch.device("cuda:0"), int8)
    px = ext.input_px
    tiles = np.random.default_rng(2).integers(60, 200, (8, px, px, 3), dtype=np.uint8)
    got, got_vit = _forward_and_vit(ext, tiles)  # in int8, the first forward calibrates, then runs the int8 tower
    with vit_image.plain_kernels():
        want, want_vit = _forward_and_vit(ext, tiles)
    cos, diff = _cosines(got, want)
    row = dict(family=family, precision="int8" if int8 else "bfloat16", tiles=8, min_cosine=cos, max_abs_diff=diff,
               max_abs_ref=want.abs().max().item())  # fmt: skip
    if got_vit is not None:
        row["vit_min_cosine"], row["vit_max_abs_diff"] = _cosines(got_vit, want_vit)
    print(f"[13 extractor zoo] kernel against plain path {json.dumps(row)} on {card}")
    vit_least = ZOO_INT8_COSINE_MIN if int8 else ZOO_COSINE_MIN
    least = TICON_INT8_COSINE_MIN if (family, int8) == ("ticon", True) else vit_least
    if not (cos >= least and row.get("vit_min_cosine", 1.0) >= vit_least):
        _fail(f"{family} ({row['precision']}): kernel against plain path, min cosine {cos} (limit {least}), "
              f"its ImageViT's {row.get('vit_min_cosine')} (limit {vit_least})")  # fmt: skip
    del ext
    torch.cuda.empty_cache()
    return row


def _zoo_sites(card: str) -> dict:
    """Rows 1–3 at the shapes phase 13's kernel families give them
    (``ZOO_LN_SITES``, ``ZOO_ATTENTION``), each against its plain version
    at ``KERNEL_TOL``; ``ln_quant_dense``'s int8 activations also within
    one step of the plain quantization."""
    import torch

    from stamp_tpu_torch.models.vit_image import _quantized_dense_site
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(7)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=gen)).to(torch.bfloat16)

    rows = []
    for what, b, n, h in ZOO_ATTENTION:
        qkv = randn(b, n, 3 * h * 64)
        abs_err, rel_err = _error(attn.fused_qkv_mha(qkv, h), attn.fused_qkv_mha_reference(qkv, h))
        rows.append(dict(kernel="fused_qkv_mha", site=what, shape=[b, n, 3 * h * 64], heads=h, max_abs_err=abs_err,
                         rel_err=rel_err))  # fmt: skip
        del qkv
    for what, m, k, n in ZOO_LN_SITES:
        x, beta, w, bias = randn(m, k), randn(k, scale=0.1), randn(n, k, scale=k**-0.5), randn(n, scale=0.1)
        g = (1.0 + 0.1 * torch.randn(k, device=dev, generator=gen)).to(torch.bfloat16)
        abs_err, rel_err = _error(lnd.ln_dense(x, g, beta, w, bias), lnd.ln_dense_reference(x, g, beta, w, bias))
        rows.append(dict(kernel="ln_dense", site=what, m=m, k=k, n=n, max_abs_err=abs_err, rel_err=rel_err))
        quant = _quantized_dense_site(w, None)
        s_x = lnd.layer_norm_f32(x, g, beta, 1e-6).abs().max().float().clamp_min(1e-6) * 1.05  # calibrated, 5% headroom
        args = (x, g, beta, s_x, quant["weight_q"], quant["w_scale"], bias)
        abs_err, rel_err = _error(lnd.ln_quant_dense(*args), lnd.ln_quant_dense_reference(*args))
        xq = lnd.quantize_activation(lnd.layer_norm_f32(x, g, beta, 1e-6).to(torch.bfloat16), s_x)
        step = (_identity_readback(lnd, x, g, beta, s_x) - xq.int()).abs().max().item()
        rows.append(dict(kernel="ln_quant_dense", site=what, m=m, k=k, n=n, max_abs_err=abs_err, rel_err=rel_err,
                         q_max_step=step))  # fmt: skip
        del x, w, quant, args, xq
    torch.cuda.empty_cache()
    for row in rows:
        print(f"[13 extractor zoo] site {json.dumps(row)} on {card}")
    bad = [row for row in rows if not row["rel_err"] <= KERNEL_TOL or row.get("q_max_step", 0) > 1]
    if bad:
        _fail(f"rows 1–3 at phase 13's shapes: beyond {KERNEL_TOL}, or a quantized value off by more than one step: {bad}")
    return {"checked": len(rows), "max_rel_err": max(row["rel_err"] for row in rows)}


def _zoo_against_cpu(card: str, family: str) -> dict:
    """A family without a kernel: the card's features against the port's
    CPU forward of the same random weights on the same tiles."""
    import numpy as np
    import torch

    n = ZOO_CPU_TILES.get(family, 2)
    saved = os.environ["STAMP_EXTRACT_BATCH"]
    os.environ["STAMP_EXTRACT_BATCH"] = str(n)  # no padding on the CPU
    try:
        card_ext = _family_extractor(family, torch.device("cuda:0"))
        tiles = np.random.default_rng(3).integers(60, 200, (n, card_ext.input_px, card_ext.input_px, 3), dtype=np.uint8)
        got = card_ext.forward(tiles).cpu()
        del card_ext
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        want = _family_extractor(family, torch.device("cpu")).forward(tiles)
        cpu_s = time.perf_counter() - t0
    finally:
        os.environ["STAMP_EXTRACT_BATCH"] = saved
    row = dict(family=family, tiles=n, cpu_s=cpu_s)
    if got.shape[1]:
        cos, diff = _cosines(got, want)
        row |= dict(min_cosine=cos, max_abs_diff=diff, max_abs_ref=want.abs().max().item())
        if not cos >= ZOO_COSINE_MIN:
            _fail(f"{family}: card against CPU, min cosine {cos} < {ZOO_COSINE_MIN}")
    elif got.shape != want.shape:
        _fail(f"{family}: card {tuple(got.shape)}, CPU {tuple(want.shape)}")
    print(f"[13 extractor zoo] card against CPU {json.dumps(row)} on {card}")
    return row


def _conch_rates(card: str) -> dict:
    """CONCH and CONCH1.5 at batch 64, steady state: tiles/s and MFU over
    the H100's dense bf16 peak (``TILE_GFLOP`` a tile)."""
    import numpy as np
    import torch

    rates = {}
    for family in ("conch", "conch1_5"):
        ext = _family_extractor(family, torch.device("cuda:0"))
        px = ext.input_px
        tiles = np.random.default_rng(4).integers(60, 200, (BATCH, px, px, 3), dtype=np.uint8)
        ms = statistics.median(_time_ms(lambda: ext.forward(tiles), iters=5))
        tiles_per_s = BATCH / ms * 1e3
        rates[family] = dict(batch=BATCH, ms=ms, tiles_per_s=tiles_per_s, gflop_per_tile=TILE_GFLOP[family],
                             mfu=tiles_per_s * TILE_GFLOP[family] * 1e9 / PEAK_FLOPS["bf16"])  # fmt: skip
        del ext
        torch.cuda.empty_cache()
    print(f"[13 extractor zoo] steady-state forward {json.dumps(rates)} on {card}")
    return rates


#: the share of row 1′'s outputs bitwise equal to its plain version's.  The
#: 1e-2 limit cannot tell the JAX package's order (p normalized in f32, then
#: cast to bf16 for P·V) from p cast first and O·(1/l) after P·V; the share
#: can: 99.83% for the kernel, 50.1% for the other order
#: (``scripts/fused_qkv_attn_probe.py`` on an NVIDIA H100 80GB HBM3, 700 W).
TWO_PASS_EQUAL_MIN = 0.95


def _two_pass(card: str) -> list[dict]:
    """Row 1 at CONCH's shapes (N = 785 > ``ONE_PASS_MAX_N``: the two-pass
    kernel, ``csrc/fused_qkv_long.cu``), batch 64, against its plain version
    and SDPA bf16 (timed, never called by the port), one sync around each
    call and back to back; its bound (4 products), the design's floor (6
    products at the bf16 peak; 2 ex2 a score at 16 a clock an SM at the
    card's top SM clock), its useful and executed TFLOP/s, the share of its
    outputs bitwise equal to the plain version's (≥ ``TWO_PASS_EQUAL_MIN``)
    and a bitwise repeat."""
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.ops import flash_attention as attn

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)  # fmt: skip
    max_sm_hz = float(smi.stdout.split()[0]) * 1e6
    rows = []
    for h in (12, 16):  # CONCH, CONCH1.5
        b, n, d = BATCH, CONCH_TOKENS, 64
        qkv = torch.randn(b, n, 3 * h * d, device=dev, generator=gen).to(torch.bfloat16)
        before = attn.LONG_LAUNCHES
        got = attn.fused_qkv_mha(qkv, h)
        if attn.LONG_LAUNCHES != before + 1:
            _fail(f"fused_qkv_mha at N = {n} did not launch the two-pass kernel")
        ref = attn.fused_qkv_mha_reference(qkv, h)
        abs_err, rel_err = _error(got, ref)
        equal_share = (got == ref).float().mean().item()
        repeat = torch.equal(got, attn.fused_qkv_mha(qkv, h))
        del ref

        def sdpa(qkv=qkv, h=h):
            q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, h * d)

        kernel = lambda: attn.fused_qkv_mha(qkv, h)  # noqa: E731
        t = _compare_timed(kernel, lambda: attn.fused_qkv_mha_reference(qkv, h), sdpa)
        b2b = _compare_timed(kernel, None, sdpa, reps=B2B_REPS)
        flops = 4 * b * h * n * n * d  # q·kᵀ and P·V
        bound, by = _bound(b * n * 4 * h * d * 2, {"bf16": flops})
        floor_products = 1.5 * flops / PEAK_FLOPS["bf16"] * 1e3  # q·kᵀ twice
        floor_ex2 = 2 * b * h * n * n / (16 * sms * max_sm_hz) * 1e3
        row = dict(shape=[b, n, 3 * h * d], heads=h, head_dim=d, max_abs_err=abs_err, rel_err=rel_err,
                   equal_share=equal_share, bitwise_repeat=repeat, ms=t["kernel"], plain_ms=t["plain"],
                   sdpa_bf16_ms=t["control"],
                   ms_b2b=b2b["kernel"], sdpa_bf16_ms_b2b=b2b["control"], bound_ms=bound, bound_by=by,
                   bound_share=bound / t["kernel"], floor_products_ms=floor_products, floor_ex2_ms=floor_ex2,
                   tflops=flops / t["kernel"] / 1e9, executed_tflops=1.5 * flops / t["kernel"] / 1e9,
                   vs_sdpa=t["kernel"] / t["control"])  # fmt: skip
        print(f"[13 extractor zoo] fused_qkv_mha two-pass {json.dumps(row)} on {card}")
        if not rel_err <= KERNEL_TOL:
            _fail(f"fused_qkv_mha {row['shape']}: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}")
        if not repeat:
            _fail(f"fused_qkv_mha {row['shape']}: two calls differ")
        if equal_share < TWO_PASS_EQUAL_MIN:
            _fail(f"fused_qkv_mha {row['shape']}: {equal_share:.4f} of outputs equal the plain version's "
                  f"< {TWO_PASS_EQUAL_MIN} (the operation order: p normalized in f32, then cast)")  # fmt: skip
        rows.append(row)
        del qkv, got
    torch.cuda.empty_cache()
    return rows


def _he_tiles(n: int, size: int, seed: int):
    """H&E-like uint8 tiles: two smooth stain-concentration fields through
    Beer–Lambert with stain vectors off the reference, plus noise (the
    recipe of ``tests/test_macenko_groundtruth.py``'s tile).  A tile of
    uniform noise is no stain image: its optical-density covariance is
    nearly isotropic, so its stain plane, and the tile after Macenko, turn
    on the last bits of ``eigh``."""
    import numpy as np

    from stamp_tpu_torch.ops.macenko import HE_REF

    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.linspace(0, 1, size), np.linspace(0, 1, size))
    tiles = []
    for _ in range(n):
        (hx, hy), (ex, ey) = rng.uniform(0.2, 0.8, (2, 2))
        c_h = 0.9 * np.exp(-((xx - hx) ** 2 + (yy - hy) ** 2) * 6) + 0.15
        c_e = 0.7 * np.exp(-((xx - ex) ** 2 + (yy - ey) ** 2) * 8) + 0.1
        stains = np.asarray(HE_REF) + rng.normal(scale=0.05, size=(3, 2))
        stains /= np.linalg.norm(stains, axis=0, keepdims=True)
        img = (240.0 * np.exp(-stains @ np.stack([c_h.ravel(), c_e.ravel()]))).T.reshape(size, size, 3)
        tiles.append(np.clip(img + rng.normal(scale=2.0, size=img.shape), 0, 255).astype(np.uint8))
    return np.stack(tiles)


def _macenko_on_card(card: str) -> dict:
    """Macenko on the card against the golden tile and the port's CPU path
    (64 H&E-like tiles of 224 px), and its ms per batch of them."""
    import numpy as np
    import torch

    from stamp_tpu_torch.ops.macenko import macenko_normalize

    golden = np.load(REPO / "tests" / "data" / "macenko_golden.npz")
    dev = torch.device("cuda:0")
    tiles = _he_tiles(BATCH, 224, seed=6)
    got_golden = macenko_normalize(torch.from_numpy(golden["input"][None]).to(dev)).cpu().numpy()[0]
    got = macenko_normalize(torch.from_numpy(tiles).to(dev)).cpu().numpy()
    want = macenko_normalize(torch.from_numpy(tiles)).numpy()
    row = {}
    for what, a, b in (("golden", got_golden, golden["normalized"]), ("cpu", got, want)):
        diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
        row[f"vs_{what}_p99"], row[f"vs_{what}_max"] = float(np.percentile(diff, 99)), int(diff.max())
        if not (row[f"vs_{what}_p99"] <= 2 and row[f"vs_{what}_max"] <= 6):  # tests/test_macenko_groundtruth.py
            _fail(f"Macenko on the card against the {what}: {row}")
    images = torch.from_numpy(tiles).to(dev)
    row["ms_per_batch"] = statistics.median(_time_ms(lambda: macenko_normalize(images), iters=5))
    row["batch"] = BATCH
    # uniform noise, as phase 4's slide is (and as preprocess normalizes it
    # in phase 13's PLIP run): the card and the CPU in f32, each against
    # the CPU in f64
    noise = np.random.default_rng(6).integers(60, 200, (BATCH, 224, 224, 3), dtype=np.uint8)
    on_card = macenko_normalize(torch.from_numpy(noise).to(dev)).cpu().numpy().astype(np.int32)
    on_cpu = macenko_normalize(torch.from_numpy(noise)).numpy().astype(np.int32)
    on_cpu_f64 = macenko_normalize(torch.from_numpy(noise), torch.float64).numpy().astype(np.int32)
    for what, a, b in (("noise_vs_cpu", on_card, on_cpu), ("noise_cpu_vs_f64", on_cpu, on_cpu_f64),
                       ("noise_vs_f64", on_card, on_cpu_f64)):  # fmt: skip
        diff = np.abs(a - b)
        row[f"{what}_p99"], row[f"{what}_max"] = float(np.percentile(diff, 99)), int(diff.max())
        row[f"{what}_tiles_over_6"] = int((diff.reshape(BATCH, -1).max(axis=1) > 6).sum())
    print(f"[13 extractor zoo] macenko {json.dumps(row)} on {card}")
    if not max(row[f"{what}_p99"] for what in ("noise_vs_cpu", "noise_cpu_vs_f64", "noise_vs_f64")) <= MACENKO_P99:
        _fail(f"Macenko on uniform noise: a 99th percentile of |Δ| above {MACENKO_P99}: {row}")
    return row


def _conch1_5_to_titan(card: str, root: Path) -> dict:
    """``encode_slides`` with TITAN on the CONCH1.5 features this phase
    extracted."""
    import numpy as np
    import torch

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.io.h5 import read_h5

    fields = {"encoder": "titan", "output_dir": str(root / "titan"), "feat_dir": str(root / "conch1_5" / "conch1_5"),
              "device": "cuda", "generate_hash": False}  # fmt: skip
    config = _yaml(root / "titan.yaml", {"slide_encoding": fields})
    t0 = time.perf_counter()
    main(["-c", str(config), "encode_slides"])  # exits non-zero on failure
    torch.cuda.synchronize()
    (h5,) = sorted((root / "titan").rglob("*.h5")) or [None]
    if h5 is None:
        _fail("TITAN wrote no slide embedding for the CONCH1.5 features")
    datasets, attrs = read_h5(h5)
    if datasets["feats"].shape != (768,) or not np.isfinite(datasets["feats"]).all() or attrs["encoder"] != "titan":
        _fail(f"TITAN on CONCH1.5 features: feats {datasets['feats'].shape}, attrs {attrs}")
    row = dict(slide=h5.stem, wall_s=time.perf_counter() - t0, norm=float(np.linalg.norm(datasets["feats"])))
    print(f"[13 extractor zoo] CONCH1.5 → TITAN {json.dumps(row)} on {card}")
    return row


def phase_extractor_zoo(card: str) -> dict:
    """13: every other tile-extractor family through ``preprocess`` on
    phase 4's slide (144 tiles, batch 64, random weights at full width):
    bf16, and int8 for the four whose towers carry rows 1–3 (CONCH,
    CONCH1.5, KEEP, TICON), with each run's launches checked (rows 1–3 at
    every block of those four, none of rows 1–9 elsewhere); each family's
    features on the card against its plain path (rows 1–3's plain versions)
    or, without a kernel, the port's CPU forward; CONCH and CONCH1.5 tiles/s
    and MFU; row 1's two-pass kernel at CONCH's shapes; Macenko on the
    card (also through ``preprocess``); TITAN on the CONCH1.5 features."""
    import torch

    root = WORK / "extractors"
    slides = WORK / "slides"
    if not (slides / "synthetic.tif").is_file():
        slides.mkdir(parents=True, exist_ok=True)
        _write_slide(slides / "synthetic.tif")
    os.environ["STAMP_RANDOM_WEIGHTS"] = "1"
    os.environ["STAMP_EXTRACT_BATCH"] = str(BATCH)
    sites = _zoo_sites(card)
    runs, checks = [], []
    for family in EXTRACTOR_FAMILIES:
        for int8 in (False, True) if family in KERNEL_FAMILIES else (False,):
            row, _, _ = _extract_run(card, family, root, slides, int8=int8)
            expected = _expected_counts(family, row["batches"], int8)
            if {k: v for k, v in row["launches"].items()} != {k: v for k, v in expected.items() if v}:
                _fail(f"{family} ({row['precision']}): launches {row['launches']}, expected {expected}")
            runs.append(row)
            torch.cuda.empty_cache()
        if family in KERNEL_FAMILIES:
            checks += [_zoo_against_plain(card, family, int8) for int8 in (False, True)]
        else:
            checks.append(_zoo_against_cpu(card, family))
    macenko_run, _, _ = _extract_run(card, "plip", root, slides, macenko=True)
    if macenko_run["launches"] or not macenko_run["macenko_s"]:
        _fail(f"plip with Macenko: {macenko_run}")
    runs.append(macenko_run)
    return dict(
        runs=runs,
        checks=checks,
        sites=sites,
        rates=_conch_rates(card),
        two_pass=_two_pass(card),
        macenko=_macenko_on_card(card),
        titan=_conch1_5_to_titan(card, root),
    )


#: phase 14's runs: label → (encoder, the extractor of its tile features, EAGLE's
#: aggregation extractor); every extractor's features share one tile set a slide
ENCODER_RUNS = {
    "gigapath": ("gigapath", "gigapath", None),
    "prism": ("prism", "virchow-full", None),
    "cobra": ("cobra", "virchow2", None),
    "cobra-conch": ("cobra", "conch", None),
    "madeleine": ("madeleine", "conch", None),
    "chief": ("chief", "chief-ctranspath", None),
    "eagle": ("eagle", "ctranspath", "virchow2"),
}
ENCODER_WIDTHS = {"gigapath": 1536, "virchow-full": 2560, "virchow2": 2560, "conch": 512, "chief-ctranspath": 768,
                  "ctranspath": 768}  # fmt: skip
#: the width of each run's embedding (COBRA's and EAGLE's are their raw features')
ENCODER_OUT = {"gigapath": 768, "prism": 1280, "cobra": 2560, "cobra-conch": 512, "madeleine": 512, "chief": 768,
               "eagle": 2560}  # fmt: skip
#: each encoder's embedding on the card against the port's CPU forward of the
#: same weights on the 1,500-tile slide, max |Δ| / max |CPU|.  Both sides are
#: f32 (TF32 off): at full width the port's CPU forward in f32 reads at most
#: 7.5e-7 against its own f64 forward, and with the matmuls' operands rounded
#: to TF32 (10-bit mantissa) 1.6e-4 to 9.4e-4 (GigaPath 4.2e-4; both from
#: ``scripts/slide_encoder_rounding.py`` on the CPU).  1e-5 holds the one and
#: refuses the other; the GigaPath forward with matmul TF32 on must fail it.
ENCODER_TOL = 1e-5
#: cosine of the two; TF32 moves it by 3.2e-7 at most (the same script), so it
#: is a sanity check only and cannot see TF32
ENCODER_COSINE_MIN = 0.99999
#: EAGLE's top-25 sets must be equal unless the CPU's rank-25 gap is under this
#: many times the largest card-to-CPU score difference
EAGLE_GAP_FACTOR = 10.0


def _write_encoder_cohort(root: Path) -> None:
    """Tile features of every extractor phase 14 reads (fp16, the port's
    writer) on the slide-shaped grids of phase 9's slide names, and a slide
    table with one patient of the two 10,000-tile slides."""
    import numpy as np
    import pandas as pd

    from stamp_tpu_torch.io.h5 import write_tile_feats_atomic

    rng = np.random.default_rng(14)
    for name, n in TITAN_TILES.items():
        coords = (_tissue_grid(n) * 256.0).astype(np.float32)
        for extractor, width in ENCODER_WIDTHS.items():
            write_tile_feats_atomic(
                output_path=root / extractor / f"{name}.h5",
                feats=rng.standard_normal((n, width), dtype=np.float32).astype(np.float16), coords_um=coords,
                extractor_id=extractor, tile_size_um=256.0, tile_size_px=224, code_hash="chip-smoke",
            )  # fmt: skip
    pd.DataFrame({"PATIENT": ["patient-A"] * 2, "FILENAME": [f"{s}.h5" for s in TITAN_PATIENT]}).to_csv(
        root / "slide.csv", index=False
    )


def _encoder_embedding(label: str, encoder, root: Path, names: tuple[str, ...]):
    """``embed(device)`` of the slide (one name) or the patient (two) as the
    CLI computes it, its inputs read beforehand."""
    import numpy as np

    from stamp_tpu_torch.io.h5 import read_feats

    _, extractor, agg = ENCODER_RUNS[label]
    if agg is not None:  # EAGLE: CTransPath scores, Virchow2 features
        read = encoder._paired_reader(root / extractor, root / agg)
        pairs = [read(root / extractor / f"{n}.h5")[0] for n in names]
        ctp, vir2 = (np.concatenate([p[i] for p in pairs]) for i in (0, 1))
        return lambda dev: encoder._eagle_embedding(ctp, vir2, dev)
    if label == "gigapath":  # coordinates; a patient is a virtual slide
        if len(names) == 1:
            feats, coords = read_feats(root / extractor / f"{names[0]}.h5")
        else:
            files = [f"{n}.h5" for n in names]
            feats, coords = encoder._assemble_virtual_slide(root / extractor, files, patient_id="p")
        return lambda dev: encoder._generate_slide_embedding(feats, dev, coords=coords)
    feats = [read_feats(root / extractor / f"{n}.h5")[0] for n in names]
    if len(names) == 1:
        return lambda dev: encoder._generate_slide_embedding(feats[0], dev)
    return lambda dev: encoder._generate_patient_embedding(feats, dev)


def _encoder_cli(label: str, root: Path) -> dict:
    """``encode_slides`` (and, but for COBRA on CONCH, ``encode_patients``)
    through the CLI with ``--profile``, every launch count 0 before each and
    checked 0 after; the h5 contract; skip-if-exists on a rerun."""
    import numpy as np
    import torch
    import yaml

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.io.h5 import read_h5
    from stamp_tpu_torch.utils import profiling

    encoder, extractor, agg = ENCODER_RUNS[label]
    out = root / "out" / label
    runs = {}
    commands = [("encode_slides", "slide_encoding")]
    if label != "cobra-conch":
        commands.append(("encode_patients", "patient_encoding"))
    for command, section in commands:
        fields = {"encoder": encoder, "output_dir": str(out), "feat_dir": str(root / extractor), "device": "cuda",
                  "generate_hash": False}  # fmt: skip
        if agg is not None:
            fields["agg_feat_dir"] = str(root / agg)
        if command == "encode_patients":
            fields["slide_table"] = str(root / "slide.csv")
        config = root / f"{label}-{command}.yaml"
        config.write_text(yaml.safe_dump({section: fields}))
        _zero_counts()
        t0 = time.perf_counter()
        _staged_cli(["-c", str(config), command])  # exits non-zero on failure
        torch.cuda.synchronize()
        launched = {k: v for k, v in _zoo_counts().items() if v}
        if launched:
            _fail(f"{label} {command} launched kernels of rows 1–9: {launched}")
        runs[command] = dict(wall_s=time.perf_counter() - t0) | {
            stage.split("/")[1] + "_s": profiling.timer.seconds.get(stage, 0.0)
            for stage in ("encode/read", "encode/forward", "encode/h5_write")
        }
    kind = {"encode_slides": "slide", "encode_patients": "pat"}
    outputs = {p.stem: read_h5(p) for c in runs for p in sorted((out / f"{encoder}-{kind[c]}").glob("*.h5"))}
    expected = {*TITAN_TILES} | ({"patient-A"} if "encode_patients" in runs else set())
    if set(outputs) != expected:
        _fail(f"{label}: encoded files {sorted(outputs)}, expected {sorted(expected)}")
    precision = "torch.float16" if encoder in ("gigapath", "prism") else "torch.float32"
    for name, (datasets, attrs) in outputs.items():
        feat_type = "patient" if name == "patient-A" else "slide"
        if (datasets["feats"].shape != (ENCODER_OUT[label],) or not np.isfinite(datasets["feats"]).all()
                or attrs["encoder"] != encoder or attrs["feat_type"] != feat_type or attrs["precision"] != precision
                or "source_precision" in attrs):  # fmt: skip
            _fail(f"{label} {name}: feats {datasets['feats'].shape}, attrs {attrs}")
    written = {p: p.stat().st_mtime_ns for p in out.rglob("*.h5")}
    main(["-c", str(root / f"{label}-encode_slides.yaml"), "encode_slides"])
    if {p: p.stat().st_mtime_ns for p in out.rglob("*.h5")} != written:
        _fail(f"{label}: a rerun of encode_slides rewrote its files (skip-if-exists)")
    return dict(runs=runs, outputs={name: datasets["feats"] for name, (datasets, _) in outputs.items()})


def _eagle_top_sets(card: str, encoder, root: Path) -> list[dict]:
    """EAGLE's top-25 tile set on the card against the CPU's, each slide,
    with the CPU's rank-25 gap and the largest card-to-CPU score difference."""
    import numpy as np

    from stamp_tpu_torch.io.h5 import read_feats

    rows = []
    for name in TITAN_TILES:
        ctp, _ = read_feats(root / "ctranspath" / f"{name}.h5")
        scores = {dev: encoder.net.scores_and_feature(ctp, dev)[0] for dev in ("cuda:0", "cpu")}
        ranked = np.sort(scores["cpu"])[::-1]
        gap = float(ranked[24] - ranked[25])
        diff = float(np.abs(scores["cuda:0"] - scores["cpu"]).max())
        equal = set(encoder.top_tiles(ctp, "cuda:0").tolist()) == set(encoder.top_tiles(ctp, "cpu").tolist())
        row = dict(slide=name, equal_sets=equal, rank25_gap=gap, max_score_diff=diff)
        print(f"[14 encoder zoo] EAGLE top-25 {json.dumps(row)} on {card}")
        if not equal and gap >= EAGLE_GAP_FACTOR * diff:
            _fail(f"EAGLE's top-25 set on the card differs from the CPU's with a clear gap: {row}")
        rows.append(row)
    return rows


def phase_encoder_zoo(card: str) -> dict:
    """14: the other slide and patient encoders (GigaPath, PRISM, COBRA on
    Virchow2 and on CONCH, MADELEINE, CHIEF, EAGLE) through ``encode_slides``
    and ``encode_patients`` in-process at published width (random weights;
    phase 9's slide sizes and patient): the h5 contract and skip-if-exists,
    no launch of rows 1–9; each encoder on the card against the port's CPU
    forward on the 1,500-tile slide (``ENCODER_TOL``, and GigaPath with TF32
    on refused by it); EAGLE's top-25 sets; seconds per slide and patient
    and the CLI's stages; ``torch.profiler`` splits and peak memory at
    16,384 tiles."""
    import importlib

    import numpy as np
    import torch

    root = WORK / "encoders"
    t0 = time.perf_counter()
    _write_encoder_cohort(root)
    print(f"[14 encoder zoo] cohort written in {time.perf_counter() - t0:.1f} s on {card}")
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True  # as PyTorch leaves them
    os.environ["STAMP_RANDOM_WEIGHTS"] = "1"
    classes = {"gigapath": "Gigapath", "prism": "Prism", "cobra": "Cobra", "madeleine": "Madeleine", "chief": "CHIEF",
               "eagle": "Eagle"}  # fmt: skip
    dev = torch.device("cuda:0")
    largest = max(TITAN_TILES, key=TITAN_TILES.get)
    summary = {}
    try:
        for label, (name, _, _) in ENCODER_RUNS.items():
            row = _encoder_cli(label, root)
            cli = row.pop("outputs")
            encoder = getattr(importlib.import_module(f"stamp_tpu_torch.encoding.encoder.{name}"), classes[name])()
            units = {n: (n,) for n in TITAN_TILES} | ({} if label == "cobra-conch" else {"patient-A": TITAN_PATIENT})
            row["seconds"] = {}
            for unit, names in units.items():
                embed = _encoder_embedding(label, encoder, root, names)
                got = embed(dev)  # warm-up; the CLI's embedding again
                abs_err, rel_err = _error(torch.from_numpy(got), torch.from_numpy(cli[unit]))
                if rel_err > ENCODER_TOL:
                    _fail(f"{label} {unit}: the encoder's embedding differs from the CLI's by {rel_err}")
                times = []
                for _ in range(3):
                    times.append(_timed(lambda: embed(dev)))
                row["seconds"][unit] = statistics.median(times)
                if unit == largest:
                    torch.cuda.reset_peak_memory_stats()
                    embed(dev)
                    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
                    if label in ("gigapath", "prism", "cobra"):
                        _profile_forward(card, f"{label} {unit}", lambda: (None, 1e3 * _timed(lambda: embed(dev))),
                                         tag="14 encoder zoo")  # fmt: skip
                if unit == "slide-1500":
                    cpu = embed("cpu")
                    abs_err, rel_err = _error(torch.from_numpy(got), torch.from_numpy(cpu))
                    cos = float(np.dot(got, cpu) / (np.linalg.norm(got) * np.linalg.norm(cpu)))
                    row["vs_cpu"] = dict(max_abs_err=abs_err, rel_err=rel_err, cosine=cos)
                    if not (rel_err <= ENCODER_TOL and cos >= ENCODER_COSINE_MIN):
                        _fail(f"{label} at 1,500 tiles, card against CPU: {row['vs_cpu']}")
                    if label == "gigapath":
                        torch.backends.cuda.matmul.allow_tf32 = True
                        try:
                            tf32 = embed(dev)
                        finally:
                            torch.backends.cuda.matmul.allow_tf32 = False
                        _, tf32_err = _error(torch.from_numpy(tf32), torch.from_numpy(cpu))
                        row["vs_cpu"]["tf32_rel_err"] = tf32_err
                        if tf32_err <= ENCODER_TOL:
                            _fail(f"GigaPath with TF32 on reads {tf32_err} against the CPU: ENCODER_TOL {ENCODER_TOL} "
                                  "cannot see TF32")  # fmt: skip
            if label == "eagle":
                row["top25"] = _eagle_top_sets(card, encoder, root)
            print(f"[14 encoder zoo] {label} {json.dumps(row)} on {card}")
            summary[label] = row
            (encoder.net if name in ("chief", "eagle") else encoder.model).to("cpu")
            del encoder
            torch.cuda.empty_cache()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    shutil.rmtree(root, ignore_errors=True)
    return summary


# --- phase 15: the parallel layer ---------------------------------------------------

#: (a) and (b)'s whole-slide runs hold their parameters to max |param| times this
MESH_PARAM_TOL = 1e-6
#: (b)'s bag-512 run against the single rank: the gradient's sum order differs
MESH_BAG_TOL = 1e-5
#: (d) each fold's probabilities against the single-process runs
FLEET_PROB_TOL = 1e-6
#: (c) the extraction fleet's cohort: slides of 3×3 and 3×4 tiles of 256 µm
FLEET_SLIDES = 4


def _ckpt_diff(got: Path, want: Path) -> tuple[float, float]:
    """(max |Δ|, max |value| of ``want``) of two ``model.ckpt``, in the
    collection where the ratio is worst: the parameters, or the ALiBi
    statistics (µm, four orders above the weights)."""
    import numpy as np

    from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
    from stamp_tpu_torch.models.weights import flatten

    g, w = (flatten(load_checkpoint(p)["variables"]) for p in (got, want))
    if set(g) != set(w):
        _fail(f"{got} and {want} hold different variables")
    by_collection = {}
    for collection in {k[0] for k in w}:
        keys = [k for k in w if k[0] == collection]
        by_collection[collection] = (
            max(float(np.abs(g[k].astype(np.float64) - w[k]).max()) for k in keys),
            max(float(np.abs(w[k]).max()) for k in keys),
        )
    worst = by_collection["params"]
    for diff, scale in by_collection.values():
        if diff / scale > worst[0] / worst[1]:
            worst = (diff, scale)
    return worst


def _train_yaml(root: Path, name: str, **advanced) -> Path:
    """Phase 7's ``train`` config on its cohort, into ``root/name``."""
    body = {"bag_size": None, "max_epochs": TRAIN_EPOCHS, "seed": 0, "accelerator": "cuda", "num_workers": 4}
    return _yaml(root / f"{name}.yaml", {
        "training": {
            "output_dir": str(root / name), "clini_table": str(root / "clini.csv"),
            "slide_table": str(root / "slide.csv"), "feature_dir": str(root / "features"),
            "ground_truth_label": "label", "task": "classification",
        },
        "advanced_config": body | advanced,
    })  # fmt: skip


def _epoch_feed(readings: list, feed):
    """``feed`` (the prefetching one or a synchronous one) timed from the
    epoch's first batch request to its last step's end, with the device's
    kernel time in that window (``torch.profiler``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed(iterable, *, size, device):
        prof = profile(activities=[ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        prof.start()
        t0 = time.perf_counter()
        yield from feed(iterable, size=size, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.stop()
        events = [e for e in prof.key_averages() if str(e.device_type).endswith("CUDA") and e.device_time_total > 0]
        copies = sum(e.device_time_total for e in events if "memcpy" in e.key.lower()) / 1e6
        kernels = sum(e.device_time_total for e in events) / 1e6 - copies
        readings.append(dict(epoch_s=wall, kernels_s=kernels, copies_s=copies, idle_share=1 - kernels / wall))

    return timed


def _synchronous_feed(iterable, *, size, device):
    """The feed before the prefetching one: each batch copied (pinned) to
    the card when the step asks for it."""
    from stamp_tpu_torch.modeling import train
    from stamp_tpu_torch.parallel.prefetch import _map

    for batch in iterable:
        yield _map(batch, lambda x: train._to_device(x, device))


def _write_fleet_slides(root: Path) -> None:
    import numpy as np
    from PIL import Image

    root.mkdir(parents=True)
    rng = np.random.default_rng(15)
    for i in range(FLEET_SLIDES):
        arr = rng.integers(60, 200, (768, 768 + 256 * (i % 2), 3), dtype=np.uint8)
        Image.fromarray(arr).save(root / f"fleet{i}.tif", format="TIFF", compression="tiff_lzw",
                                  resolution=10000.0, resolution_unit=3)  # fmt: skip


def _fleet_features(out: Path) -> dict:
    """slide stem → (feats, coords) sorted by coordinate."""
    import numpy as np

    from stamp_tpu_torch.io.h5 import read_h5

    result = {}
    for path in sorted(out.rglob("*.h5")):
        datasets, _ = read_h5(path)
        order = np.lexsort((datasets["coords"][:, 1], datasets["coords"][:, 0]))
        result[path.stem] = (datasets["feats"][order], datasets["coords"][order])
    return result


def _extraction_fleet(card: str, root: Path) -> dict:
    """(c): ``preprocess`` (UNI2 bf16) as a fleet of two ranks on the card,
    against one process; then a crashed rank and its pickup."""
    import numpy as np

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd
    from stamp_tpu_torch.parallel import distributed
    from stamp_tpu_torch.parallel._extract_fleet_dryrun import launch_extract_fleet

    slides = root / "slides"
    _write_fleet_slides(slides)

    def config(name: str) -> Path:
        return _yaml(root / f"{name}.yaml", {"preprocessing": {
            "output_dir": str(root / name), "wsi_dir": str(slides), "extractor": "uni2", "device": "cuda",
            "generate_hash": False, "default_slide_mpp": 1.0, "max_workers": 4,
        }})  # fmt: skip

    attn.LAUNCHES = attn.LONG_LAUNCHES = lnd.LAUNCHES = 0
    t0 = time.perf_counter()
    main(["-c", str(config("single")), "preprocess"])
    single_s = time.perf_counter() - t0
    want = _fleet_features(root / "single")
    stems = sorted(want)
    if len(stems) != FLEET_SLIDES or any(len(f) > BATCH for f, _ in want.values()):
        _fail(f"extraction fleet: the single run wrote {stems}, or a slide needs more than one batch")

    crashed = config("crashed")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the fleet and the crashed one at once: each rank builds UNI2's weights
        fleet = pool.submit(launch_extract_fleet, config("fleet"), timeout=300)
        crash = pool.submit(launch_extract_fleet, crashed, crash_pid=1, timeout=300)
        log, crash_log = fleet.result(), crash.result()
    fleets_s = time.perf_counter() - t0
    got = _fleet_features(root / "fleet")
    takes = [f"extraction fleet: process {r}/2 takes {FLEET_SLIDES // 2} slides" for r in range(2)]
    if sorted(got) != stems or not all(t in log for t in takes):
        _fail(f"extraction fleet: wrote {sorted(got)} of {stems}, shares logged {[t in log for t in takes]}")
    for stem in stems:
        if not (np.array_equal(got[stem][0], want[stem][0]) and np.array_equal(got[stem][1], want[stem][1])):
            _fail(f"extraction fleet: {stem}'s features differ from the single process's")

    paths = sorted(slides.glob("*.tif"))
    shares = [sorted(p.stem for p in distributed.shard_worklist(paths, index=r, count=2)) for r in range(2)]
    if set(shares[0]) & set(shares[1]) or sorted(shares[0] + shares[1]) != stems:
        _fail(f"extraction fleet: shares {shares} are not a partition of {stems}")

    left = sorted(_fleet_features(root / "crashed"))
    if "[1] simulated crash before extraction" not in crash_log or left != shares[0]:
        _fail(f"extraction fleet: with rank 1 crashed the directory holds {left}, expected rank 0's {shares[0]}")
    main(["-c", str(crashed), "preprocess"])  # one process picks the rest up
    launches = {"fused_qkv_mha": attn.LAUNCHES, "ln_dense": lnd.LAUNCHES}  # the single run and the pickup
    picked = _fleet_features(root / "crashed")
    if sorted(picked) != stems or not all(np.array_equal(picked[s][0], want[s][0]) for s in stems):
        _fail(f"extraction fleet: the pickup left {sorted(picked)} or its features differ")
    batches = FLEET_SLIDES + len(shares[1])  # one batch a slide
    if launches != {"fused_qkv_mha": 24 * batches, "ln_dense": 72 * batches} or attn.LONG_LAUNCHES:
        _fail(f"extraction fleet: launches {launches} in this process, expected rows 1–2 at 24 blocks × {batches}")
    return dict(slides=FLEET_SLIDES, tiles=sum(len(c) for _, c in want.values()), shares=shares, bitwise=True,
                launches=launches, single_s=single_s, fleets_s=fleets_s, crash_left=left)  # fmt: skip


def phase_parallel(card: str, trained: dict) -> dict:
    """15: the parallel layer (``stamp_tpu_torch.parallel``) on the card.

    (a) ``train`` with ``mesh_shape: {dp: 1}`` (a process group of one, NCCL)
    on phase 7's cohort and configs (``vit``, ALiBi and ``vit`` with
    attention dropout, 512 wide, 8 heads, 2 layers, whole slides): its
    ``model.ckpt`` against phase 7's (the same
    run without a mesh), rows 4–8 and the ALiBi statistic's kernel launched
    as in phase 7.  (b) an explicit
    fleet of two ranks sharing the card (gloo, collectives staged through
    pinned host memory): whole-slide ``train`` of both variants with
    ``{dp: 2}`` (a batch of one cycled to two rows: both ranks hold the same
    bag) against (a), and ALiBi at ``bag_size: 512``, ``batch_size: 4``
    (9 training patients: batches of 4, 4 and 1, the last cycled to 2)
    against a run without a mesh.  (c) ``preprocess`` with UNI2 bf16 as a
    fleet of two ranks on four small slides (9 and 12 tiles, one batch
    each) into one directory: the union is the cohort, the shares are
    ``shard_worklist``'s, the features bitwise a single process's; a rank
    crashed before extracting, and its share picked up by one process.
    (d) ``crossval`` (phase 8's config: 2 folds, ``bag_size`` 512, batches
    of 2) as a fleet of two ranks without a mesh: each rank one fold, each
    fold's ``patient-preds.csv`` against a single-process run that reaches
    it with the other fold done (a fold's bags depend on the folds one
    process trained before it, in both packages), every process with
    ``PYTHONHASHSEED=0`` (the fold's patient order is a set's).  (e) phase
    7's training epoch (2 epochs cut to 1) with the prefetching feed, then
    with the synchronous one: the epoch's wall time and the device's idle
    share (``torch.profiler`` kernel time in the epoch).

    Cut for time (most of it the fleets' start-up and UNI2's random
    weights, made once a process): (c) four slides of 9–12 tiles instead of
    phase 4's 144-tile slide; (e) one epoch a run, one run a feed.  Runs
    that do not depend on each other overlap: (b)'s single-rank bag-512 run
    in this process while the fleet runs, (c)'s fleet and crashed fleet at
    once, and (d)'s two single processes while (c) runs.  Widths are phase
    7's, 4's and 8's."""
    import numpy as np
    import pandas as pd
    import torch
    import yaml

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.modeling import train
    from stamp_tpu_torch.parallel._dist_dryrun import launch_local_fleet
    from stamp_tpu_torch.parallel.prefetch import prefetch_to_device

    cohort = WORK / "train"  # phase 7's
    root = WORK / "parallel"
    root.mkdir()
    os.environ["STAMP_RANDOM_WEIGHTS"] = "1"  # (c)'s UNI2, as in phase 4
    os.environ["STAMP_EXTRACT_BATCH"] = str(BATCH)
    result: dict = {}

    # (a) a mesh of one rank
    for variant, vit_params in _TRAIN_VARIANTS:
        config = _train_yaml(cohort, f"{variant}-dp1", mesh_shape={"dp": 1}, model_params={"vit": vit_params})
        _reset_training_launches()
        t0 = time.perf_counter()
        main(["-c", str(config), "train"])  # exits non-zero on failure
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _training_launches()
        if launches != trained["runs"][variant]["launches"]:
            _fail(f"(a) {variant} dp=1: launches {launches}, phase 7's {trained['runs'][variant]['launches']}")
        diff, scale = _ckpt_diff(cohort / f"{variant}-dp1" / "model.ckpt", cohort / variant / "model.ckpt")
        if not diff <= MESH_PARAM_TOL * scale:
            _fail(f"(a) {variant} dp=1: model.ckpt differs from phase 7's by {diff} (max |param| {scale})")
        row = dict(variant=variant, launches=launches, wall_s=wall, max_param_diff=diff, max_param=scale,
                   bitwise=diff == 0.0)  # fmt: skip
        print(f"[15a mesh of one rank] {json.dumps(row)} on {card}")
        result.setdefault("dp1", []).append(row)

    # (b) and (d): one fleet of two ranks on the card
    alibi = {"vit": {"use_alibi": True}}
    configs = [
        _train_yaml(cohort, "vit-dp2", mesh_shape={"dp": 2}, model_params={"vit": {"use_alibi": False}}),
        _train_yaml(cohort, "alibi-dp2", mesh_shape={"dp": 2}, model_params=alibi),
        _train_yaml(cohort, "bag512-dp2", mesh_shape={"dp": 2}, model_params=alibi, bag_size=512, batch_size=4),
    ]
    crossval = _yaml(cohort / "crossval-fleet.yaml", {
        "crossval": {
            "output_dir": str(cohort / "crossval-fleet"), "clini_table": str(cohort / "clini.csv"),
            "slide_table": str(cohort / "slide.csv"), "feature_dir": str(cohort / "features"),
            "ground_truth_label": "label", "task": "classification", "n_splits": 2,
        },
        "advanced_config": {"max_epochs": CROSSVAL_EPOCHS, "batch_size": 2, "seed": 0, "accelerator": "cuda",
                            "num_workers": 4, "model_params": alibi},
    })  # fmt: skip
    args = [a for c in configs for a in (str(c), "train")] + [str(crossval), "crossval"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:  # (b)'s single-rank reference in this process meanwhile
        fleet = pool.submit(launch_local_fleet, ["cli", *args], timeout=600, env_extra={"PYTHONHASHSEED": "0"})
        bag512 = _train_yaml(cohort, "bag512-single", model_params=alibi, bag_size=512, batch_size=4)
        main(["-c", str(bag512), "train"])
        log = fleet.result()
    fleet_s = time.perf_counter() - t0
    (root / "fleet.log").write_text(log)
    staged = "staged through pinned host tensors" in log
    backend = "backend gloo (2 ranks share 1 card(s)" in log
    print(f"[15b fleet] two ranks on the card: gloo {backend}, collectives staged through pinned host memory "
          f"{staged}, {fleet_s:.1f} s for three train runs and a crossval (and the single-rank bag-512 run in "
          f"this process meanwhile) on {card}")  # fmt: skip
    if not (staged and backend):
        _fail(f"(b) the fleet did not run on gloo with staged collectives: see {root / 'fleet.log'}")
    for variant in ("vit", "alibi"):
        diff, scale = _ckpt_diff(cohort / f"{variant}-dp2" / "model.ckpt", cohort / f"{variant}-dp1" / "model.ckpt")
        row = dict(variant=variant, max_param_diff=diff, max_param=scale, bitwise=diff == 0.0)
        print(f"[15b dp=2 whole slides] {json.dumps(row)} on {card}")
        if not diff <= MESH_PARAM_TOL * scale:
            _fail(f"(b) {variant} dp=2: model.ckpt differs from (a)'s by {diff} (max |param| {scale})")
        result.setdefault("dp2", []).append(row)
    diff, scale = _ckpt_diff(cohort / "bag512-dp2" / "model.ckpt", cohort / "bag512-single" / "model.ckpt")
    row = dict(variant="alibi bag 512, batch 4", max_param_diff=diff, max_param=scale)
    print(f"[15b dp=2 bag 512] {json.dumps(row)} on {card}")
    if not diff <= MESH_BAG_TOL * scale:
        _fail(f"(b) bag 512 dp=2: model.ckpt differs from the single rank's by {diff} (max |param| {scale})")
    result["dp2_bag512"] = row

    # (d) each fold against a single process that reaches it with the other done: both processes run
    # while (c) runs, and are checked after it
    fleet_dir = cohort / "crossval-fleet"
    if not all(f"skipping split {1 - r}: assigned to process {1 - r} of the fleet" in log for r in range(2)):
        _fail(f"(d) the crossval fleet did not partition its folds: see {root / 'fleet.log'}")
    procs, errs = [], []
    for fold in (0, 1):
        single = cohort / f"crossval-single{fold}"
        (single / f"split-{1 - fold}").mkdir(parents=True)
        shutil.copy(fleet_dir / "splits.json", single)
        shutil.copy(fleet_dir / f"split-{1 - fold}" / "patient-preds.csv", single / f"split-{1 - fold}")
        body = yaml.safe_load(crossval.read_text())
        body["crossval"]["output_dir"] = str(single)
        errs.append(open(root / f"crossval-single{fold}.err", "w+"))  # a file: no pipe to fill meanwhile
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "stamp_tpu_torch", "-c", str(_yaml(single.with_suffix(".yaml"), body)), "crossval"],
            cwd=REPO, env=os.environ | {"PYTHONHASHSEED": "0"}, stdout=subprocess.DEVNULL, stderr=errs[-1],
        ))  # fmt: skip
    try:
        # (c) the extraction fleet
        row = _extraction_fleet(card, root / "extract")
        print(f"[15c extraction fleet] {json.dumps(row)} on {card}")
        result["extract"] = row
        for proc in procs:
            proc.wait(timeout=300)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    folds = []
    for fold, proc in enumerate(procs):
        errs[fold].seek(0)
        err = errs[fold].read()
        errs[fold].close()
        if proc.returncode != 0:
            _fail(f"(d) the single-process crossval of fold {fold} failed:\n{err[-3000:]}")
        got = pd.read_csv(fleet_dir / f"split-{fold}" / "patient-preds.csv").set_index("PATIENT").sort_index()
        want = pd.read_csv(cohort / f"crossval-single{fold}" / f"split-{fold}" / "patient-preds.csv")
        want = want.set_index("PATIENT").sort_index()
        columns = ["label_neg", "label_pos"]
        if list(got.index) != list(want.index):
            _fail(f"(d) fold {fold}: the fleet predicted {list(got.index)}, one process {list(want.index)}")
        diff = float(np.abs(got[columns].to_numpy() - want[columns].to_numpy()).max())
        folds.append(dict(fold=fold, patients=len(got), max_prob_diff=diff))
        if not diff <= FLEET_PROB_TOL:
            _fail(f"(d) fold {fold}: the fleet's probabilities differ from one process's by {diff}")
    print(f"[15d crossval fleet] {json.dumps(folds)} on {card}")
    result["crossval"] = folds

    # (e) the prefetching feed against the synchronous one, in turns
    readings: dict = {}
    try:
        for variant, use_alibi in (("vit", False), ("alibi", True)):
            for i, (feed_name, feed) in enumerate((("prefetch", prefetch_to_device), ("synchronous", _synchronous_feed))):
                samples = readings.setdefault(variant, {}).setdefault(feed_name, [])
                train.prefetch_to_device = _epoch_feed(samples, feed)
                config = _train_yaml(cohort, f"{variant}-epoch{i}", max_epochs=1,
                                     model_params={"vit": {"use_alibi": use_alibi}})  # fmt: skip
                main(["-c", str(config), "train"])
    finally:
        train.prefetch_to_device = prefetch_to_device
    for variant, by_feed in readings.items():
        row = {"variant": variant} | {feed: runs[0] for feed, runs in by_feed.items()}
        print(f"[15e prefetch] {json.dumps(row)} on {card}")
        result.setdefault("prefetch", []).append(row)
    return result


#: (a) a model.ckpt trained on {sp: 2} against phase 7's, over max |param|: the
#: sequence group sums each step's gradient in two parts and the ALiBi
#: statistic in two, which moves f32 sums by an ulp or so a step; phase 15b
#: measured 5.6e-7 for the same kind of reordering (rows) over 9 steps, so
#: 1e-5 leaves an order of magnitude for 18 steps.  The attention key biases
#: are held apart: their gradient is 0 in exact arithmetic (softmax ignores a
#: shift shared by all keys), so both runs step them on rounding noise, which
#: Adam scales up towards lr a step; they are held to 2 · max_lr · steps
SP_PARAM_TOL = 1e-5
#: (b) the sequence-sharded forward against the single-process one (the JAX
#: package's make_sp_eval_forward test's atol)
SP_EVAL_ATOL = 1e-5
#: (b) a whole-slide bag on the flash path: 16,384 tiles + CLS
SP_EVAL_TILES = 16384
#: (a) one sharded training step on the card at phase 7's widths: a bag of
#: this many tiles (T = 4,097 with CLS, the flash path)
SP_STEP_TILES = 4096
#: (a) that step's all-reduced gradients against one process's step on the
#: card: max |Δ| of each tensor within SP_GRAD_TOL of the tensor's largest
#: |gradient|, at least SP_GRAD_FLOOR of the model's largest (a gradient
#: that cancels keeps the rounding of its terms); the attention key biases,
#: whose gradient is rounding noise, SP_GRAD_TOL of the model's.  Both steps
#: run the same kernels at the same precision; only the split of the
#: queries and the order of the sums differ (the CPU tests read ≤ 1e-5).
#: A gradient counted twice is off by its own size, 1,000 times the limit:
#: the check also runs on the doubled gradients and must fail there.
SP_GRAD_TOL = 1e-3
SP_GRAD_FLOOR = 1e-5
#: (c) device operations printed from the trace
TRACE_TOP = 5
#: the card phase 16 computes on in this process and in (b)'s ranks
SEQ_DEVICE = "cuda:0"


def _sp_ckpt_diff(got: Path, want: Path) -> dict:
    """Two ``model.ckpt`` compared: max |Δ| over the parameters but the
    attention key biases (``in_proj``'s middle third, ``k_proj``) and max
    |param|; max |Δ| of the key biases; the ALiBi statistics' largest
    relative difference (0 without them)."""
    import numpy as np

    from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
    from stamp_tpu_torch.models.weights import flatten

    g, w = (flatten(load_checkpoint(p)["variables"]) for p in (got, want))
    rest, walk, stats = 0.0, 0.0, 0.0
    for key, value in w.items():
        delta = np.abs(g[key].astype(np.float64) - value)
        if key[0] != "params":
            stats = max(stats, float((delta / np.abs(value)).max()))
        elif key[-2:] == ("in_proj", "bias"):
            third = len(delta) // 3
            walk = max(walk, float(delta[third : 2 * third].max()))
            rest = max(rest, float(delta[:third].max()), float(delta[2 * third :].max()))
        elif key[-2:] == ("k_proj", "bias"):
            walk = max(walk, float(delta.max()))
        else:
            rest = max(rest, float(delta.max()))
    scale = max(float(np.abs(v).max()) for k, v in w.items() if k[0] == "params")
    return dict(max_param_diff=rest, max_param=scale, ratio=rest / scale, key_bias_diff=walk, stats_rel_diff=stats)


def _trace_summary(trace: Path) -> dict:
    """From a ``--profile`` Chrome trace of ``train``: the device
    operations (kernels, copies, memsets) that took the most time, and per
    epoch (first to last ``train/step`` range, split at ``train/eval``) the
    device's idle share: 1 − (union of device operations in the window) /
    window."""
    events = json.loads(trace.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and "dur" in e]
    totals: dict = {}
    for e in device:
        name = e["name"]
        total, calls = totals.get(name, (0.0, 0))
        totals[name] = (total + e["dur"], calls + 1)
    top = sorted(totals.items(), key=lambda kv: -kv[1][0])[:TRACE_TOP]
    ranges = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                    if e.get("cat") == "user_annotation" and e.get("name") in ("train/step", "train/eval"))  # fmt: skip
    epochs, current = [], []
    for start, end, name in ranges:
        if name == "train/step":
            current.append((start, end))
        elif current:
            epochs.append((current[0][0], current[-1][1], len(current)))
            current = []
    if current:
        epochs.append((current[0][0], current[-1][1], len(current)))
    intervals = sorted((e["ts"], e["ts"] + e["dur"]) for e in device)
    rows = []
    for start, end, steps in epochs:
        busy, reach = 0.0, start
        for a, b in intervals:
            a, b = max(a, reach), min(b, end)
            if b > a:
                busy += b - a
                reach = b
        rows.append(dict(steps=steps, epoch_ms=(end - start) / 1e3, device_busy_ms=busy / 1e3,
                         idle_share=1 - busy / (end - start)))  # fmt: skip
    steps = [end - start for start, end, name in ranges if name == "train/step"]
    return dict(events=len(events), device_events=len(device), epochs=rows,
                step_ms=sum(steps) / max(len(steps), 1) / 1e3,
                top=[dict(op=name[:80], calls=calls, device_ms=total / 1e3) for name, (total, calls) in top])  # fmt: skip


def _sp_step_job(root: Path, variant: str) -> tuple[dict, dict]:
    """(job, inputs) of one ``{sp: 2}`` training step on the card at phase
    7's widths (``_dist_dryrun``'s ``step`` job): random weights and one
    bag of ``SP_STEP_TILES`` tiles on a grid, from a seed."""
    import numpy as np
    import torch

    from stamp_tpu_torch.models import weights
    from stamp_tpu_torch.parallel._dist_dryrun import task_model

    spec = dict(task="classification", model_name="vit", dim_input=UNI2_DIM, total_steps=4,
                model=dict(dim_model=512, n_layers=2, n_heads=8, dim_feedforward=512, use_alibi=variant == "alibi"),
                mesh_shape={"sp": 2}, device="cuda")  # fmt: skip
    model = task_model(spec)
    weights.init_weights_(model.module, torch.Generator().manual_seed(16))
    rng = np.random.default_rng(16)
    side = math.isqrt(SP_STEP_TILES)
    idx = np.arange(SP_STEP_TILES)
    arrays = dict(bags=rng.standard_normal((1, SP_STEP_TILES, UNI2_DIM), dtype=np.float32),
                  coords=(np.stack([idx % side, idx // side], axis=1)[None] * 256.0).astype(np.float32),
                  sizes=np.array([SP_STEP_TILES], np.int32), targets=np.eye(2, dtype=np.float32)[[1]],
                  **{f"state/{k}": v.numpy() for k, v in model.module.state_dict().items()})  # fmt: skip
    job = root / f"step-{variant}"
    job.mkdir()
    np.savez(job / "inputs.npz", **arrays)
    return dict(kind="step", spec=spec, dir=str(job)), arrays


def _single_step_grads(spec: dict, arrays: dict) -> tuple[float, dict]:
    """(loss, gradients) of the same step in this process on the card, on
    the whole bag."""
    import torch

    from stamp_tpu_torch.modeling.train import forward_batch
    from stamp_tpu_torch.parallel._dist_dryrun import _tensors, batch_of, task_model
    from stamp_tpu_torch.parallel.mesh import make_dp_train_step

    dev = torch.device(SEQ_DEVICE)
    model = task_model(spec)
    model.module.load_state_dict({k.removeprefix("state/"): torch.from_numpy(v) for k, v in arrays.items()
                                  if k.startswith("state/")})  # fmt: skip
    model.module.to(dev)
    step = make_dp_train_step(
        model, model.make_optimizer(model.module.parameters()), None, schedule=model.lr_schedule(),
        forward=lambda batch, key_mask, group: forward_batch(model, batch, key_mask, dev, train=True, group=group),
    )  # fmt: skip
    loss, _ = step(_tensors(batch_of(arrays), dev), None, 0)
    return float(loss), {n: p.grad.double().cpu().numpy() for n, p in model.module.named_parameters()}


def _sp_grad_worst(got: dict, want: dict, factor: float = 1.0) -> tuple[float, str]:
    """The largest max |factor · got − want| over its limit (``SP_GRAD_TOL``,
    ``SP_GRAD_FLOOR``), and the tensor or part where it is."""
    import numpy as np

    scale = max(float(np.abs(w).max()) for w in want.values())
    worst = (0.0, "")
    for name, w in want.items():
        g = factor * got[name].astype(np.float64)
        parts = [(name, w, g, name.endswith("k_proj.bias"))]
        if name.endswith("in_proj.bias"):  # q | k | v: the key third is the key bias
            t = len(w) // 3
            parts = [(f"{name}[{p}]", w[i * t : (i + 1) * t], g[i * t : (i + 1) * t], p == "k")
                     for i, p in enumerate("qkv")]  # fmt: skip
        for part, wp, gp, walking in parts:
            limit = SP_GRAD_TOL * scale if walking else max(SP_GRAD_TOL * float(np.abs(wp).max()), SP_GRAD_FLOOR * scale)
            worst = max(worst, (float(np.abs(gp - wp).max()) / limit, part))
    return worst


def phase_sequence(card: str, trained: dict) -> dict:
    """16: sequence parallelism, ``--profile``'s trace and several cards in
    one ``preprocess``, on the one card.

    (a) a fleet of two ranks sharing the card (gloo, collectives staged
    through pinned host memory): whole-slide ``train`` of phase 7's ``vit``,
    ALiBi and dropout configs with ``mesh_shape: {sp: 2}`` (each rank half of every
    bucket-padded bag: Tq = T/2 + 1 queries against the T + 1 gathered
    keys), each ``model.ckpt`` against phase 7's (``SP_PARAM_TOL`` of max
    |param|), each rank's launches of rows 4–8 and of the ALiBi statistic's
    kernel (its rows against the whole sequence's keys, once a step;
    counted in the ranks, set to 0 before each command) equal to phase 7's
    run, their sum
    ``sp_launches``; both ranks run with ``--profile``, and each rank's
    trace gives its mean ``train/step`` and the share of each epoch its own
    kernels leave idle (the card's other rank is in another trace), beside
    the trace of the same config's run in this process, (c)'s (``vit`` and
    ALiBi).  In the same fleet, one ``{sp: 2}`` step of ``vit`` and of ALiBi at phase 7's widths on a bag of
    ``SP_STEP_TILES`` tiles on the card, its all-reduced gradients against
    the same step in this process (``SP_GRAD_TOL``; Adam's first update,
    lr·sign(g), would hide a gradient counted twice from the checkpoints).
    (b) in the same fleet, ``make_sp_eval_forward`` of
    phase 7's trained ``vit`` on a 16,384-tile bag (T = 16,385, the flash
    path) against this process's single forward (``SP_EVAL_ATOL``), the
    output equal on both ranks.  (c) ``--profile train`` of phase 7's
    ``vit`` and ALiBi configs in this process: the trace under
    ``<output_dir>/profile/``, its CUDA events naming the flash kernels
    (a trace without CUDA activity must come with the warning, the CPU
    side and the step ranges), the stage table in the log, ``model.ckpt``
    bitwise equal to the same run without ``--profile`` (run before it and
    again after it); the mean step with and without the trace, the trace's top device operations and the
    device's idle share per epoch.  (d) phase 4's ``preprocess`` with
    the visible card count patched to 2 in this process only: two ranks
    share the card, and the h5 equals phase 4's, bitwise.

    Widths are phase 7's and 4's; one card shared by two ranks shows no
    speed-up, only that the sharded path runs and agrees."""
    import numpy as np
    import torch
    import yaml

    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.io.h5 import read_h5
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt
    from stamp_tpu_torch.models import weights
    from stamp_tpu_torch.parallel._dist_dryrun import launch_local_fleet

    cohort = WORK / "train"  # phase 7's
    root = WORK / "sequence"
    root.mkdir()
    result: dict = {}

    # (a) and (b): one fleet of two ranks on the card
    configs = {variant: _train_yaml(cohort, f"{variant}-sp2", mesh_shape={"sp": 2}, model_params={"vit": vit_params})
               for variant, vit_params in _TRAIN_VARIANTS}  # fmt: skip
    rng = np.random.default_rng(16)
    side = math.isqrt(SP_EVAL_TILES)
    idx = np.arange(SP_EVAL_TILES)
    bag = dict(bags=rng.standard_normal((1, SP_EVAL_TILES, UNI2_DIM), dtype=np.float32),
               coords=(np.stack([idx % side, idx // side], axis=1)[None] * 256.0).astype(np.float32),
               key_mask=np.ones((1, SP_EVAL_TILES), bool))  # fmt: skip
    eval_dir = root / "sp-eval"
    eval_dir.mkdir()
    np.savez(eval_dir / "inputs.npz", **bag)
    dev = torch.device(SEQ_DEVICE)
    spec = dict(ckpt=str(cohort / "vit" / "model.ckpt"), device=dev.type, mesh_shape={"sp": 2})
    jobs = [dict(kind="cli", spec=dict(config=str(configs[v]), command="train", flags=["--profile"])) for v in configs]
    jobs.append(dict(kind="sp_eval", spec=spec, dir=str(eval_dir)))
    step_jobs = {variant: _sp_step_job(root, variant) for variant in ("vit", "alibi")}
    jobs += [job for job, _ in step_jobs.values()]
    (root / "jobs.json").write_text(json.dumps(jobs))
    t0 = time.perf_counter()
    log = launch_local_fleet(["jobs", str(root / "jobs.json")], timeout=600)
    fleet_s = time.perf_counter() - t0
    (root / "fleet.log").write_text(log)
    staged = "staged through pinned host tensors" in log
    backend = "backend gloo (2 ranks share 1 card(s)" in log
    if not (staged and backend):
        _fail(f"(16a) the fleet did not run on gloo with staged collectives: see {root / 'fleet.log'}")
    ranks = [json.loads(line.split(" ", 2)[2]) | {"rank": int(line.split(" ", 2)[1])}
             for line in log.splitlines() if line.startswith("LAUNCHES ")]  # fmt: skip
    sp_launches = {name: 0 for name in (*_COUNTERS, _PAIR_SUMS)}
    for variant, config in configs.items():
        runs = [r for r in ranks if r["config"] == str(config)]
        want = trained["runs"][variant]["launches"]
        for r in runs:
            got = {name: r[name] for name in want}
            if got != want:
                _fail(f"(16a) {variant} sp=2 rank {r['rank']}: launches {got}, phase 7's {want}")
            for name in sp_launches:
                sp_launches[name] += got[name]
        if len(runs) != 2:
            _fail(f"(16a) {variant}: {len(runs)} ranks reported their launches, expected 2")
        diff = _sp_ckpt_diff(cohort / f"{variant}-sp2" / "model.ckpt", cohort / variant / "model.ckpt")
        walk_limit = 2 * 1e-4 * trained["runs"][variant]["steps"]  # max_lr (the config's default) a step
        row = dict(variant=variant, **diff, limit=SP_PARAM_TOL, key_bias_limit=walk_limit, launches_per_rank=want)
        print(f"[16a sp=2 whole slides] {json.dumps(row)} on {card}")
        if not (diff["ratio"] <= SP_PARAM_TOL and diff["stats_rel_diff"] <= SP_PARAM_TOL
                and diff["key_bias_diff"] <= walk_limit):  # fmt: skip
            _fail(f"(16a) {variant} sp=2: model.ckpt differs from phase 7's: {row}")
        result.setdefault("train", []).append(row)
    if not all(sp_launches.values()):
        _fail(f"(16a) a kernel of rows 4–8 never ran under sp: {sp_launches}")
    result["sp_launches"] = sp_launches
    print(f"[16a sp=2] sp_launches {json.dumps(sp_launches)}; fleet {fleet_s:.1f} s for three train runs, (b) and "
          f"two steps, gloo {backend}, staged {staged} on {card}")  # fmt: skip
    # one sharded step on the card: its all-reduced gradients against one process's
    for variant, (job, arrays) in step_jobs.items():
        sharded = dict(np.load(Path(job["dir"]) / "result.npz"))
        loss, want = _single_step_grads(job["spec"], arrays)
        got = {k.removeprefix("grad/"): v for k, v in sharded.items() if k.startswith("grad/")}
        if set(got) != set(want):
            _fail(f"(16a) {variant} sp=2 step: gradients of {sorted(set(got) ^ set(want))} on one side only")
        worst, where = _sp_grad_worst(got, want)
        doubled, _ = _sp_grad_worst(got, want, factor=2.0)
        row = dict(variant=variant, tiles=SP_STEP_TILES, loss=float(sharded["loss"]), single_loss=loss,
                   worst_over_limit=worst, worst_at=where, doubled_over_limit=doubled,
                   grad_tol=SP_GRAD_TOL, grad_floor=SP_GRAD_FLOOR)  # fmt: skip
        print(f"[16a sp=2 step gradients] {json.dumps(row)} on {card}")
        if not (worst <= 1.0 < doubled and abs(row["loss"] - loss) <= 1e-5 * abs(loss)):
            _fail(f"(16a) {variant} sp=2 step: gradients or loss differ from one process's on the card: {row}")
        result.setdefault("step", []).append(row)

    sharded = dict(np.load(eval_dir / "result.npz"))
    model, variables = load_model_from_ckpt(cohort / "vit" / "model.ckpt")
    weights.load_variables_(model.module, variables)
    module = model.module.to(dev)
    bags, coords, key_mask = (torch.from_numpy(bag[k]).to(dev) for k in ("bags", "coords", "key_mask"))
    with torch.inference_mode():
        single = module(bags, coords=coords, key_mask=key_mask).float().cpu().numpy()
    del module, bags, coords, key_mask
    err = float(np.abs(sharded["out"] - single).max())
    row = dict(tiles=SP_EVAL_TILES, seq_len=SP_EVAL_TILES + 1, max_abs_err=err, atol=SP_EVAL_ATOL,
               rank_spread=float(sharded["rank_spread"]), logits=single.tolist())  # fmt: skip
    print(f"[16b sp eval] {json.dumps(row)} on {card}")
    if not (err <= SP_EVAL_ATOL and row["rank_spread"] == 0.0):
        _fail(f"(16b) the sharded forward differs from the single one by {err} (ranks by {row['rank_spread']})")
    result["eval"] = row

    # (c) --profile train in this process, and the same run without it (the
    # stage timer on), for both of phase 7's configs
    from stamp_tpu_torch.utils import profiling

    def step_ms() -> float:  # the mean train/step of the run that just ended
        return 1e3 * profiling.timer.seconds["train/step"] / profiling.timer.calls["train/step"]

    result["profile"] = []
    for variant in ("vit", "alibi"):
        params = {"vit": {"use_alibi": variant == "alibi"}}
        plain = _train_yaml(cohort, f"{variant}-plain16", model_params=params)
        profiled = _train_yaml(cohort, f"{variant}-profile16", model_params=params)
        again = _train_yaml(cohort, f"{variant}-again16", model_params=params)
        _staged_cli(["-c", str(plain), "train"])
        plain_step_ms = step_ms()
        t0 = time.perf_counter()
        main(["-c", str(profiled), "--profile", "train"])
        profiled_s = time.perf_counter() - t0
        traced_step_ms = step_ms()
        _staged_cli(["-c", str(again), "train"])  # untraced again: the step's drift between runs
        again_step_ms = step_ms()
        out = cohort / f"{variant}-profile16"
        trace = out / "profile" / "stamp.pt.trace.json"
        log = (out / "logfile.log").read_text()
        warnings = [line for line in log.splitlines()
                    if any(w in line for w in ("tracing unavailable", "device trace failed", "torch.profiler:",
                                               "no CUDA activity"))]  # fmt: skip
        if not trace.is_file():
            _fail(f"(16c) {variant}: no trace at {trace}; the log says {warnings}")
        if "profile — per-stage wall time" not in log or "train/step" not in log:
            _fail(f"(16c) {variant}: the stage table is not in the log")
        for other in (out, cohort / f"{variant}-again16"):
            diff, scale = _ckpt_diff(other / "model.ckpt", cohort / f"{variant}-plain16" / "model.ckpt")
            if diff != 0.0:
                _fail(f"(16c) {variant}: {other.name}'s model.ckpt differs from the plain run's by {diff} "
                      f"(max |param| {scale})")  # fmt: skip
        summary = _trace_summary(trace)
        events = json.loads(trace.read_text())["traceEvents"]
        names = {t["op"] for t in summary["top"]} | {e["name"] for e in events if e.get("cat") == "kernel"}
        wanted = {**_FWD_KERNELS, **_BWD_KERNELS, **(_DWS_KERNELS if variant == "alibi" else {})}
        kernels = {k: any(v in n for n in names) for k, v in wanted.items()}
        # what the trace costs: the mean step (stage timer) of the untraced
        # runs before and after the traced one, and of the traced one
        row = dict(variant=variant, trace=str(trace.relative_to(WORK)), trace_mb=trace.stat().st_size / 2**20,
                   wall_s=profiled_s, plain_step_ms=[plain_step_ms, again_step_ms], traced_step_ms=traced_step_ms,
                   kernels_named=kernels, **summary)  # fmt: skip
        if not summary["device_events"]:  # the profiler could not trace the card: the CPU side and the warning
            print(f"[16c profile] the trace holds no CUDA activity; the command's log says: {warnings}")
            cpu_ops = sum(e.get("cat") == "cpu_op" for e in events)
            if not (any("no CUDA activity" in line for line in warnings) and cpu_ops and summary["epochs"]):
                _fail(f"(16c) a trace without CUDA activity must come with the warning, cpu_op events ({cpu_ops}) "
                      f"and the train/step ranges ({summary['epochs']})")  # fmt: skip
            row["cuda_activity"] = False
        elif not all(kernels.values()):
            _fail(f"(16c) {variant}: the trace's CUDA events do not name every flash kernel: {kernels}")
        print(f"[16c profile] {json.dumps(row)} on {card}")
        result["profile"].append(row)

    # (a)'s steps on the shared card against the same config's run in one
    # process, both traced (the sp ranks ran with --profile; 16c's runs)
    for row, single in zip(result["train"][:2], result["profile"], strict=True):
        variant = row["variant"]
        timing = {"single (16c)": _trace_summary(cohort / f"{variant}-profile16" / "profile" / "stamp.pt.trace.json")}
        for r in range(2):
            timing[f"sp rank {r}"] = _trace_summary(cohort / f"{variant}-sp2" / "profile" / f"rank{r}.pt.trace.json")
        timing = {k: dict(step_ms=v["step_ms"], epochs=v["epochs"], top=v["top"]) for k, v in timing.items()}
        run = trained["runs"][variant]  # its stage timer's train/step total over its steps
        timing["phase 7 (untraced)"] = dict(step_ms=1e3 * run["train_step_s"] / run["steps"])
        print(f"[16a sp=2 steps] {variant}: {json.dumps(timing)} on {card}")
        row["timing"] = timing

    # (d) phase 4's preprocess with two cards seen by this process
    body = yaml.safe_load((WORK / "config.yaml").read_text())
    body["preprocessing"]["output_dir"] = str(root / "features")
    config = _yaml(root / "preprocess.yaml", body)
    real_count = torch.cuda.device_count
    torch.cuda.device_count = lambda: 2
    try:
        t0 = time.perf_counter()
        main(["-c", str(config), "preprocess"])
        preprocess_s = time.perf_counter() - t0
    finally:
        torch.cuda.device_count = real_count
    plog = (root / "features" / "logfile.log").read_text()
    launched = "2 cards: running this command as 2 local ranks" in plog
    if not (launched and "backend gloo (2 ranks share 1 card(s)" in plog):
        _fail(f"(16d) preprocess did not run as two ranks sharing the card: see {root / 'features' / 'logfile.log'}")
    got, want = (sorted(d.rglob("*.h5")) for d in (root / "features", WORK / "features"))
    if [p.name for p in got] != [p.name for p in want]:
        _fail(f"(16d) the ranks wrote {got}, phase 4 {want}")
    for g, w in zip(got, want):
        gd, wd = read_h5(g)[0], read_h5(w)[0]
        if not all(np.array_equal(a, b) for a, b in zip(_sorted_by_coords(gd), _sorted_by_coords(wd))):
            _fail(f"(16d) {g.name} differs from phase 4's")
    shares = [line.split("\t")[-1] for line in plog.splitlines() if "extraction fleet: process" in line]
    row = dict(files=[p.name for p in got], bitwise=True, wall_s=preprocess_s, shares=shares)
    print(f"[16d preprocess on two cards] {json.dumps(row)} on {card}")
    result["preprocess"] = row
    return result


# 17: UNI2 at full width with LayerScale γ = 1 (at UNI2's 1e-5 the blocks
# barely move the residual stream, which would hide a fault of the sharded
# blocks, as phase 5b says) and random biases and LayerNorm γ, β
# (``_dist_dryrun.VIT_AFFINE_STD``), a batch of 64 tiles, two ranks sharing
# the card
MP_RANKS = 2
MP_MICROBATCHES = 4
MP_RAGGED = 61
# per-tile cosine against the one-rank forward: TP sums the row-sharded
# sites' partial sums in another order (f32, then one bf16 rounding), which
# over 24 blocks of random weights at γ = 1 moves bf16 outputs by rounding
# steps; in int8 the i32 sums are exact and only SwiGLU's statistics
# (all-reduced, another order) move, but a value they move across a
# quantization step moves by a whole step, which the blocks amplify: the
# one-rank forward with TP's statistics at fc2 (``_tp_statistics``) moves
# as far from the plain one-rank forward, and TP's int8 output must equal
# that control (``MP_CONTROL_COSINE_MIN``; bitwise expected)
MP_COSINE_MIN = {"off": 0.999, "int8": 0.98}
MP_CONTROL_COSINE_MIN = 0.9999
# the faults these limits must reject, planted in the one-rank forward with
# TP's statistics (what TP with the fault computes): each row-sharded
# site's bias added on every rank, and rank 0's slice of SwiGLU's inner
# LayerNorm γ and β on every rank
MP_FAULTS = ("bias_on_every_rank", "rank0_norm_slice")
# M, K, N of UNI2's fc2 under TP at tp = 2: K = 4,096 / 2
MP_FORM_SHAPE = (BATCH * UNI2_TOKENS, 2048, 1536)
MCP_TOOLS = 13
SHAPECHECK_REPS = 8


def _mp_model(cfg, spec: dict, job_dir: Path, dev):
    """The one-rank ImageViT of a phase-17 job's weights on the card."""
    import torch

    from stamp_tpu_torch.models import vit_image
    from stamp_tpu_torch.parallel._dist_dryrun import vit_state

    with torch.device("meta"):
        model = vit_image.ImageViT(cfg)
    model.load_state_dict(vit_state(spec, job_dir, dev), assign=True)
    return model.eval()


@contextlib.contextmanager
def _tp_statistics(k: int):
    """Within the block, the one-rank ImageViT's LayerNorm GEMMs over K = ``k``
    (SwiGLU's inner norm → fc2) take the row statistics TP computes over
    two ranks: each K half's sums, added, in two passes
    (``ops.ln_dense.row_stats`` in each rank, its sums all-reduced)."""
    import torch

    from stamp_tpu_torch.models import vit_image

    def tp_stats(x, eps: float):  # two ranks: each sums its slice, the all-reduce adds the two
        a, b = (p.float() for p in x.reshape(-1, k).chunk(2, dim=-1))
        mean = (a.sum(dim=-1) + b.sum(dim=-1)) / k
        ca, cb = a - mean[:, None], b - mean[:, None]
        var = (ca * ca).sum(dim=-1) + (cb * cb).sum(dim=-1)
        return torch.stack([mean, torch.rsqrt(var / k + eps)])

    def with_stats(fn):
        def call(x, *args, eps: float = 1e-6, **kwargs):
            if x.shape[-1] == k:
                kwargs["stats"] = tp_stats(x, eps)
            return fn(x, *args, eps=eps, **kwargs)

        return call

    real = {name: getattr(vit_image, name) for name in ("ln_dense", "ln_quant_dense")}
    for name, fn in real.items():
        setattr(vit_image, name, with_stats(fn))
    try:
        yield
    finally:
        for name, fn in real.items():
            setattr(vit_image, name, fn)


@contextlib.contextmanager
def _planted_fault(model, fault: str):
    """Within the block, the one-rank ``model`` computes what TP over
    ``MP_RANKS`` ranks computes with ``fault`` (``MP_FAULTS``)."""
    import torch

    saved = []
    with torch.no_grad():
        for block in model.blocks:
            if fault == "bias_on_every_rank":
                for site in (block.attn.proj, block.mlp.fc2):
                    saved.append((site.bias, site.bias.clone()))
                    site.bias.mul_(MP_RANKS)
            else:
                for t in (block.mlp.norm.weight, block.mlp.norm.bias):
                    saved.append((t, t.clone()))
                    t.copy_(t[: t.shape[0] // MP_RANKS].repeat(MP_RANKS))
    try:
        yield
    finally:
        with torch.no_grad():
            for t, value in saved:
                t.copy_(value)


def _mp_agreement(got, want) -> dict:
    """max |Δ| / max |ref|, the least per-tile cosine and bitwise equality."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
    return dict(rel_err=float(np.abs(got - want).max() / np.abs(want).max()), min_cosine=float(cos.min()),
                bitwise=bool(np.array_equal(got, want)), max_abs_err=float(np.abs(got - want).max()))  # fmt: skip


def _mp_expected(parallel: str, quant: str) -> tuple[dict, dict]:
    """A rank's launches of rows 1–3 in one UNI2 forward (24 blocks): by the
    counters, and by the profiler's kernel names.  A TP rank runs every
    block on the whole batch, a PP stage its 12 blocks on each of the
    microbatches."""
    blocks = 24 if parallel == "tp" else 24 // MP_RANKS * MP_MICROBATCHES
    name = "ln_dense" if quant == "off" else "ln_quant_dense"
    partial = blocks if parallel == "tp" else 0  # fc2 in the partial-sum form
    counts = {"fused_qkv_mha": blocks, "ln_dense": 0, "ln_dense_partial": 0, "ln_quant_dense": 0,
              "ln_quant_dense_partial": 0} | {name: 3 * blocks, f"{name}_partial": partial}  # fmt: skip
    profiled = {"fused_qkv_attn": blocks, "ln_dense": 0, "ln_dense_partial": 0, "ln_quant_dense": 0,
                "ln_quant_dense_partial": 0, "ln_normalize": 3 * blocks} | {
        name: 3 * blocks - partial, f"{name}_partial": partial}  # fmt: skip
    return counts, profiled


def _mp_forms(card: str) -> dict:
    """17a: the two new entry forms of rows 2 and 3 at UNI2's fc2 under TP
    (``MP_FORM_SHAPE``), the caller's statistics and the partial-sum
    epilogue, against their plain versions, timed (one sync a call) beside
    the library control (``layer_norm`` + ``linear`` in bf16;
    ``torch._int_mm`` on the pre-quantized activation) and their bound; and
    row 1 at the heads a rank holds under TP (12 and 6 of UNI2's 24)."""
    import torch
    import torch.nn.functional as F

    from stamp_tpu_torch.models.vit_image import _quantized_dense_site
    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.ops import ln_dense as lnd

    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(17)

    def randn(*shape, scale=1.0):
        return (scale * torch.randn(*shape, device=dev, generator=gen)).to(torch.bfloat16)

    m, k, n = MP_FORM_SHAPE
    x, beta, bias = randn(m, k), randn(k, scale=0.1), randn(n, scale=0.1)
    g = (1.0 + 0.1 * torch.randn(k, device=dev, generator=gen)).to(torch.bfloat16)
    w = randn(n, k, scale=k**-0.5)
    quant = _quantized_dense_site(w, None)
    wq, ws = quant["weight_q"], quant["w_scale"]
    stats = lnd.row_stats(x, 1e-6)
    y = lnd.layer_norm_f32(x, g, beta, 1e-6).to(torch.bfloat16)
    s_x = y.abs().max().float().clamp_min(1e-6) * 1.05
    xq = lnd.quantize_activation(y, s_x)
    del y
    ops = 2 * m * k * n
    common = 2 * m * k + 8 * m + 8 * k  # x, the statistics, f32 γ and β
    forms = {
        # name: (kernel, plain, control, bytes, operations type)
        "ln_dense/stats": (lambda: lnd.ln_dense(x, g, beta, w, bias, stats=stats),
                           lambda: lnd.ln_dense_reference(x, g, beta, w, bias, stats=stats),
                           lambda: F.linear(F.layer_norm(x, (k,), g, beta, 1e-6), w, bias),
                           common + 2 * n * k + 2 * n + 2 * m * n, "bf16"),
        "ln_dense/partial": (lambda: lnd.ln_dense(x, g, beta, w, stats=stats, partial=True),
                             lambda: lnd.ln_dense_reference(x, g, beta, w, stats=stats, partial=True),
                             lambda: F.linear(F.layer_norm(x, (k,), g, beta, 1e-6), w),
                             common + 2 * n * k + 4 * m * n, "bf16"),
        "ln_quant_dense/stats": (lambda: lnd.ln_quant_dense(x, g, beta, s_x, wq, ws, bias, stats=stats),
                                 lambda: lnd.ln_quant_dense_reference(x, g, beta, s_x, wq, ws, bias, stats=stats),
                                 lambda: torch._int_mm(xq, wq.t()), common + n * k + 6 * n + 2 * m * n, "int8"),
        "ln_quant_dense/partial": (lambda: lnd.ln_quant_dense(x, g, beta, s_x, wq, ws, stats=stats, partial=True),
                                   lambda: lnd.ln_quant_dense_reference(x, g, beta, s_x, wq, ws, stats=stats,
                                                                        partial=True),
                                   lambda: torch._int_mm(xq, wq.t()), common + n * k + 4 * m * n, "int8"),
    }  # fmt: skip
    rows = {}
    for name, (kernel, plain, control, nbytes, kind) in forms.items():
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        abs_err, rel_err = _error(got, want)
        exact = bool(torch.equal(got, want))
        del got, want
        t = _compare_timed(kernel, plain, control)
        bound, by = _bound(nbytes, {kind: ops})
        rows[name] = dict(shape=[m, k, n], max_abs_err=abs_err, rel_err=rel_err, bitwise=exact, ms=t["kernel"],
                          plain_ms=t["plain"], library_ms=t["control"], bound_ms=bound, bound_by=by,
                          bound_share=bound / t["kernel"])  # fmt: skip
        print(f"[17a entry forms] {name} {json.dumps(rows[name])} on {card}")
        # the int8 sums with the caller's statistics: the plain version's bit for bit
        if not rel_err <= KERNEL_TOL or (name == "ln_quant_dense/partial" and not exact):
            _fail(f"(17a) {name}: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}, or int8 sums not exact ({exact})")
    del x, w, wq, xq
    heads = []
    for h in (24 // MP_RANKS, 24 // (2 * MP_RANKS)):  # the heads of a rank at tp = 2 and 4
        qkv = randn(BATCH, UNI2_TOKENS, 3 * h * 64)

        def sdpa(qkv=qkv, h=h):
            q, kk, v = qkv.view(BATCH, UNI2_TOKENS, 3, h, 64).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, kk, v).transpose(1, 2).reshape(BATCH, UNI2_TOKENS, h * 64)

        abs_err, rel_err = _error(attn.fused_qkv_mha(qkv, h), attn.fused_qkv_mha_reference(qkv, h))
        t = _compare_timed(lambda: attn.fused_qkv_mha(qkv, h), lambda: attn.fused_qkv_mha_reference(qkv, h), sdpa)
        b, nn_, three = qkv.shape
        bound, by = _bound(b * nn_ * three * 2 * 4 / 3, {"bf16": 4 * b * h * nn_ * nn_ * 64})
        row = dict(shape=[b, nn_, three], heads=h, max_abs_err=abs_err, rel_err=rel_err, ms=t["kernel"],
                   plain_ms=t["plain"], library_ms=t["control"], bound_ms=bound, bound_by=by)  # fmt: skip
        print(f"[17a entry forms] fused_qkv_mha at {h} heads {json.dumps(row)} on {card}")
        if not rel_err <= KERNEL_TOL:
            _fail(f"(17a) fused_qkv_mha at {h} heads: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}")
        heads.append(row)
    torch.cuda.empty_cache()
    return {"forms": rows, "heads": heads}


def _mcp_deploy(card: str, kind: str, root: Path) -> dict:
    """17c: ``python -m stamp_tpu_torch.mcp.server`` as a subprocess over
    stdio: ``initialize``, ``tools/list``, ``check_available_devices`` and
    one ``deploy_stamp`` of phase 7's ``vit`` checkpoint on its cohort,
    whose ``patient-preds.csv`` must equal the CLI's ``deploy`` of the same
    inputs."""
    from stamp_tpu_torch.__main__ import main

    cohort = WORK / "train"  # phase 7's
    deployment = dict(output_dir=str(root / "mcp-deploy"), checkpoint_paths=[str(cohort / "vit" / "model.ckpt")],
                      clini_table=str(cohort / "clini.csv"), slide_table=str(cohort / "slide.csv"),
                      feature_dir=str(cohort / "features"), ground_truth_label="label")  # fmt: skip
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    log = open(root / "mcp-server.log", "w")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "stamp_tpu_torch.mcp.server"], cwd=root, env=env, text=True,
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log)  # fmt: skip
    replies = {}
    try:
        for rid, method, params in ((1, "initialize", {}), (2, "tools/list", {}),
                                    (3, "tools/call", {"name": "check_available_devices"}),
                                    (4, "tools/call", {"name": "deploy_stamp", "arguments": deployment})):  # fmt: skip
            proc.stdin.write(json.dumps({"jsonrpc": "2.0", "id": rid, "method": method, "params": params}) + "\n")
            proc.stdin.flush()
            while True:  # notifications/message lines stream the CLI's log
                line = proc.stdout.readline()
                if not line:
                    _fail(f"(17c) the MCP server closed its output before answering {method}: see {log.name}")
                message = json.loads(line)
                if message.get("id") == rid:
                    replies[method if rid < 3 else params["name"]] = message
                    break
        proc.stdin.close()
        proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    server_s = time.perf_counter() - t0
    tools = [t["name"] for t in replies["tools/list"]["result"]["tools"]]
    devices = replies["check_available_devices"]["result"]["content"][0]["text"]
    deployed = replies["deploy_stamp"].get("result", {}).get("content", [{}])[0].get("text", str(replies["deploy_stamp"]))
    if len(tools) != MCP_TOOLS or kind not in devices or "completed successfully" not in deployed:
        _fail(f"(17c) MCP server: {len(tools)} tools, devices {devices!r}, deploy {deployed!r}")
    body = {"deployment": {**deployment, "output_dir": str(root / "cli-deploy")}}
    main(["-c", str(_yaml(root / "cli-deploy.yaml", body)), "deploy"])  # exits non-zero on failure
    mcp_csv, cli_csv = (root / d / "patient-preds.csv" for d in ("mcp-deploy", "cli-deploy"))
    equal = mcp_csv.read_bytes() == cli_csv.read_bytes()
    row = dict(server=replies["initialize"]["result"]["serverInfo"], tools=len(tools), devices=devices,
               deploy=deployed, csv_equal=equal, server_s=server_s)  # fmt: skip
    print(f"[17c mcp] {json.dumps(row)} on {card}")
    if not equal:
        _fail(f"(17c) the MCP deploy's patient-preds.csv differs from the CLI's: {mcp_csv}, {cli_csv}")
    return row


def _shapecheck_trace() -> dict:
    """17d's traces, in a fresh process (``_shapecheck_on_card``): the
    launches of ``fused_qkv_mha``'s kernel that ``torch.profiler`` records
    over ``SHAPECHECK_REPS`` wrongly shaped calls (each must raise) and over
    as many good ones, and the launches the wrapper counted for the bad."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from stamp_tpu_torch.ops import flash_attention as attn

    bad = torch.zeros(BATCH * UNI2_TOKENS, 3 * UNI2_DIM, device="cuda:0", dtype=torch.bfloat16)  # no batch axis
    good = bad.view(BATCH, UNI2_TOKENS, 3 * UNI2_DIM)
    torch.cuda.synchronize()

    def attention_events(qkv) -> tuple[str, int]:
        raised = ""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(SHAPECHECK_REPS):
                try:
                    attn.fused_qkv_mha(qkv, 24)
                except TypeError as e:
                    raised = str(e)
            torch.cuda.synchronize()
        events = prof.key_averages()
        return raised, sum(e.count for e in events if str(e.device_type).endswith("CUDA") and "fused_qkv" in e.key)

    raised, bad_events = attention_events(bad)
    bad_launches = attn.LAUNCHES
    _, good_events = attention_events(good)  # the same trace sees the good calls
    return dict(raised=raised, bad_device_events=bad_events, bad_launches=bad_launches, good_device_events=good_events)


def _shapecheck_on_card(card: str, main_path: dict) -> dict:
    """17d: a wrongly shaped ``fused_qkv_mha`` call raises before any
    launch (counted, and traced by ``torch.profiler`` in a fresh process:
    late in this long process a trace has come back without the kernel's
    events, where the ranks' fresh processes record them), good calls
    launch, and a repeat of a good signature is not checked again."""
    import torch

    from stamp_tpu_torch.ops import flash_attention as attn
    from stamp_tpu_torch.utils import shapecheck

    env = dict(os.environ, PYTHONPATH=os.pathsep.join(p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    probe = "import chip_smoke, json; print('SHAPECHECK', json.dumps(chip_smoke._shapecheck_trace()))"
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)  # fmt: skip
    line = next((x for x in proc.stdout.splitlines() if x.startswith("SHAPECHECK ")), None)
    if proc.returncode != 0 or line is None:
        _fail(f"(17d) the trace process failed (rc {proc.returncode}): {proc.stderr[-3000:]}")
    row = json.loads(line.split(" ", 1)[1])
    good = torch.zeros(BATCH, UNI2_TOKENS, 3 * UNI2_DIM, device="cuda:0", dtype=torch.bfloat16)
    attn.fused_qkv_mha(good, 24)
    checks = shapecheck.CHECKS
    attn.fused_qkv_mha(good, 24)  # a signature that passed: not checked again
    row |= dict(repeat_checks=shapecheck.CHECKS - checks, uni2_tiles_per_s=main_path["forward_tiles_per_s"])
    print(f"[17d shapecheck] {json.dumps(row)} on {card}")
    if not (row["raised"] and row["bad_device_events"] == 0 and row["bad_launches"] == 0
            and row["good_device_events"] >= 1 and row["repeat_checks"] == 0):  # fmt: skip
        _fail(f"(17d) a wrongly shaped call must raise before any launch, a good one launch: {row}")
    return row


def phase_model_parallel(card: str, kind: str, main_path: dict) -> dict:
    """17: tensor and pipeline parallelism of an extractor ViT, the MCP
    server, and shapecheck, on the one card.

    (a) a fleet of ``MP_RANKS`` ranks sharing the card (gloo, collectives
    staged through pinned host memory; ``parallel._dist_dryrun``'s ``vit``
    job): ``make_tp_forward`` of UNI2 at full width (seeded random weights,
    biases, LayerNorm γ and β, LayerScale γ = 1) on 64 tiles in bf16 and
    int8 (calibrated on the batch in this process), against this process's
    one-rank forward of the same weights (``MP_COSINE_MIN`` per tile, max
    |Δ| / max |ref| printed; each planted fault of ``MP_FAULTS`` must fail
    these limits), the
    output equal on both ranks, each rank's launches of rows 1–3 by the
    counters and by the profiler's kernel names (fc2 in the partial-sum
    form); the forward's wall time beside one rank's, and the share the
    collectives hold.  The two new entry forms of rows 2 and 3 and row 1 at
    12 and 6 heads (``_mp_forms``).  (b) in the same fleet
    ``make_pp_forward`` (12 blocks a stage, ``MP_MICROBATCHES``
    microbatches of 16) in bf16 and int8 on the 64 tiles and a ragged 61,
    bitwise against the one-rank forward or its largest difference.  (c)
    the MCP server (``_mcp_deploy``).  (d) shapecheck on the card
    (``_shapecheck_on_card``).  One card shared by two ranks shows no
    speed-up, only that the sharded paths run and agree."""
    import dataclasses

    import numpy as np
    import torch

    from stamp_tpu_torch.models import vit_image
    from stamp_tpu_torch.parallel._dist_dryrun import launch_local_fleet

    root = WORK / "model_parallel"
    root.mkdir()
    dev = torch.device("cuda:0")
    cfg = dataclasses.replace(vit_image.VIT_CONFIGS["uni2"], init_values=1.0)
    tiles = np.random.default_rng(17).integers(60, 200, (BATCH, 224, 224, 3), dtype=np.uint8)
    images = ((tiles - 255.0 * np.array(cfg.mean)) / (255.0 * np.array(cfg.std))).astype(np.float32)
    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    batches = {"full": images, "ragged": images[:MP_RAGGED]}
    base = dict(seed=0, dtype="bfloat16", device="cuda", timed=True, n_microbatches=MP_MICROBATCHES)

    # one rank in this process: the references, their times, int8's calibration
    (root / "calibration").mkdir()
    spec = dict(base, config=dataclasses.asdict(cfg))
    model = _mp_model(dataclasses.replace(cfg, quant="observe"), spec, root / "calibration", dev)
    amax = {k: v.float().cpu().numpy() for k, v in vit_image.calibrate_act_stats(model, x).items()}
    del model
    jobs, want, control, single_s, faults = [], {}, {}, {}, {}
    for quant in ("off", "int8"):
        qcfg = dataclasses.replace(cfg, quant=quant)
        for parallel in ("tp", "pp"):
            job_dir = root / f"{parallel}-{quant}"
            job_dir.mkdir()
            np.savez(job_dir / "amax.npz", **amax)
            np.savez(job_dir / "inputs.npz", **batches)
            names = ["full"] if parallel == "tp" else ["full", "ragged"]
            jobs.append(dict(kind="vit", dir=str(job_dir),
                             spec=dict(base, parallel=parallel, config=dataclasses.asdict(qcfg), batches=names)))
        model = _mp_model(qcfg, dict(base, config=dataclasses.asdict(qcfg)), root / f"tp-{quant}", dev)
        with torch.inference_mode():
            want[quant] = {name: model(x[: len(b)]).float().cpu().numpy() for name, b in batches.items()}
            single_s[quant] = statistics.median(_timed(lambda: model(x)) for _ in range(3))
            with _tp_statistics(int(cfg.embed_dim * cfg.mlp_ratio) // 2):
                control[quant] = model(x).float().cpu().numpy()
                for fault in MP_FAULTS:
                    with _planted_fault(model, fault):
                        faults[quant, fault] = model(x).float().cpu().numpy()
        del model
        torch.cuda.empty_cache()
    for (quant, fault), out in faults.items():  # the limits below must reject each fault
        row = dict(quant=quant, fault=fault, one_rank=_mp_agreement(out, want[quant]["full"]),
                   control=_mp_agreement(out, control[quant]))  # fmt: skip
        print(f"[17a planted fault] {json.dumps(row)} on {card}")
        passes = row["one_rank"]["min_cosine"] >= MP_COSINE_MIN[quant] and (
            quant == "off" or row["control"]["min_cosine"] >= MP_CONTROL_COSINE_MIN)  # fmt: skip
        if passes:
            _fail(f"(17a) TP's limits would pass the planted fault {fault} in {quant}: {row}")
    (root / "jobs.json").write_text(json.dumps(jobs))
    t0 = time.perf_counter()
    log = launch_local_fleet(["jobs", str(root / "jobs.json")], timeout=600)
    fleet_s = time.perf_counter() - t0
    (root / "fleet.log").write_text(log)
    if not ("staged through pinned host tensors" in log and "backend gloo (2 ranks share 1 card(s)" in log):
        _fail(f"(17) the fleet did not run on gloo with staged collectives: see {root / 'fleet.log'}")
    reports = [json.loads(line.split(" ", 2)[2]) | {"rank": int(line.split(" ", 2)[1])}
               for line in log.splitlines() if line.startswith("VIT ")]  # fmt: skip
    if len(reports) != MP_RANKS * len(jobs):
        _fail(f"(17) {len(reports)} rank reports, expected {MP_RANKS * len(jobs)}")
    tp_launches = {"fused_qkv_mha": 0, "ln_dense": 0, "ln_quant_dense": 0}
    pp_launches = dict(tp_launches)
    rows = []
    for job in jobs:
        parallel, quant = Path(job["dir"]).name.split("-")
        got = dict(np.load(Path(job["dir"]) / "result.npz"))
        counts, profiled = _mp_expected(parallel, quant)
        for name in job["spec"]["batches"]:
            agree = _mp_agreement(got[name], want[quant][name])
            ranks = [r["batches"][name] for r in reports if r["job"] == f"{parallel}-{quant}"]
            if parallel == "tp":  # the one-rank forward with TP's statistics at fc2
                agree["control"] = _mp_agreement(got[name], control[quant])
                agree["control_vs_one_rank"] = _mp_agreement(control[quant], want[quant][name])
            row = dict(parallel=parallel, quant=quant, batch=name, tiles=len(batches[name]), **agree,
                       rank_spread=max(r["rank_spread"] for r in ranks), launches=[r["launches"] for r in ranks],
                       profiled=[r["profiled"] for r in ranks], forward_s=[r["forward_s"] for r in ranks],
                       forward_s_collectives_timed=[r["forward_s_collectives_timed"] for r in ranks],
                       collectives_s=[r["collectives_s"] for r in ranks], single_s=single_s[quant])  # fmt: skip
            row["collectives_share"] = [c / f for c, f in zip(row["collectives_s"], row["forward_s_collectives_timed"])]
            print(f"[17{'a' if parallel == 'tp' else 'b'} {parallel} {quant}] {json.dumps(row)} on {card}")
            # the counters exactly; the profiler may drop an event from its
            # buffers, never add one: every kernel seen, at most as often as launched
            bad = [r for r in ranks if r["launches"] != counts or any(
                not (0.9 * want <= r["profiled"][k] <= want) for k, want in profiled.items())]  # fmt: skip
            if bad or len(ranks) != MP_RANKS:
                _fail(f"(17) {parallel} {quant} {name}: launches {bad}, expected {counts} and {profiled}")
            if not (agree["min_cosine"] >= MP_COSINE_MIN[quant] and row["rank_spread"] == 0.0):
                _fail(f"(17) {parallel} {quant} {name}: cosine {agree['min_cosine']} < {MP_COSINE_MIN[quant]} "
                      f"against one rank, or the ranks differ ({row['rank_spread']})")  # fmt: skip
            if parallel == "tp" and quant == "int8" and not agree["control"]["min_cosine"] >= MP_CONTROL_COSINE_MIN:
                _fail(f"(17) tp int8: cosine {agree['control']['min_cosine']} < {MP_CONTROL_COSINE_MIN} against "
                      "the one-rank forward with TP's statistics")  # fmt: skip
            total = tp_launches if parallel == "tp" else pp_launches
            for key in total:
                total[key] += sum(r["launches"][key] for r in ranks)
            rows.append(row)
    print(f"[17 model parallel] fleet {fleet_s:.1f} s; tp_launches {json.dumps(tp_launches)}, "
          f"pp_launches {json.dumps(pp_launches)} on {card}")  # fmt: skip
    result = dict(runs=rows, tp_launches=tp_launches, pp_launches=pp_launches, fleet_s=fleet_s)
    result |= _mp_forms(card)
    result["mcp"] = _mcp_deploy(card, kind, root)
    result["shapecheck"] = _shapecheck_on_card(card, main_path)
    return result


def _staged_cli(argv: list[str]) -> None:
    """``python -m stamp_tpu_torch <argv>`` in this process with the CLI's
    stage timer on (``profiling.stage_table``, the table ``--profile``
    logs) and no ``torch.profiler`` trace, so that the rates a phase reads
    from the timer are those of an untraced run; phase 16c runs
    ``--profile`` itself and measures what the trace costs."""
    from stamp_tpu_torch.__main__ import main
    from stamp_tpu_torch.utils import profiling

    with profiling.stage_table():
        main(argv)  # exits non-zero on failure


def _timed(fn) -> float:
    """Seconds of one synchronised call of ``fn``."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _timed_phase(name: str, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    print(f"[{name}] phase wall time {time.perf_counter() - t0:.1f} s")
    return result


def main() -> None:
    try:
        import torch
    except ImportError as e:
        _fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    if not (REPO / "stamp_tpu_torch").is_dir():
        _fail(f"run from a checkout of the repository ({REPO} has no stamp_tpu_torch/)")
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tests"))  # flash_bwd_util: phase 3c's skip cases, shared with the card tests
    shutil.rmtree(WORK, ignore_errors=True)

    kind, card = _timed_phase("1 device", phase_device)
    _timed_phase("2 build", phase_build)
    kernels = _timed_phase("3 kernels", phase_kernels, card)
    flash = _timed_phase("3b flash", phase_flash_kernels, card)
    backward = _timed_phase("3c backward", phase_flash_backward, card)
    quant = _timed_phase("3d quant", phase_quant_kernels, card)
    alibi2d = _timed_phase("3e alibi2d", phase_alibi2d_kernels, card)
    main_path = _timed_phase("4 main path", phase_main_path, card)
    int8_path = _timed_phase("4b int8 main path", phase_int8_main_path, card, main_path)
    _timed_phase("5 whole model", phase_whole_model, card)
    deploy = _timed_phase("6 deploy", phase_deploy, card)
    trained = _timed_phase("7 train", phase_train, card)
    crossval = _timed_phase("8 crossval", phase_crossval, card)
    titan = _timed_phase("9 titan", phase_titan, card)
    _timed_phase("10 statistics", phase_statistics, card)
    heatmaps = _timed_phase("11 heatmaps", phase_heatmaps, card)
    _timed_phase("12 zoo", phase_zoo, card)
    extractors = _timed_phase("13 extractor zoo", phase_extractor_zoo, card)
    _timed_phase("14 encoder zoo", phase_encoder_zoo, card)
    parallel = _timed_phase("15 parallel", phase_parallel, card, trained)
    sequence = _timed_phase("16 sequence", phase_sequence, card, trained)
    model_parallel = _timed_phase("17 model parallel", phase_model_parallel, card, kind, main_path)
    shutil.rmtree(WORK, ignore_errors=True)

    attn_row = kernels["fused_qkv_mha"][0]  # UNI2 shape, batch 64
    b, n, three_dim = attn_row["shape"]
    attn_bound = _bound(
        b * n * three_dim * 2 * 4 / 3,  # qkv read once (bf16), out written once
        {"bf16": 4 * b * attn_row["heads"] * n * n * attn_row["head_dim"]},
    )
    ln_rows = kernels["ln_dense"][:UNI2_SITES]  # the three sites of one UNI2 block
    flash_rows = {name: next(r for r in rows if r["shape"][1] == 16385) for name, rows in flash.items()}
    bwd_rows = {name: next(r for r in rows if r["shape"][1] == 16385) for name, rows in backward.items()}
    train_launches = {  # phase 7: the vit run for flash_mha's backward, the ALiBi run for the rest
        "flash_mha_bwd": trained["runs"]["vit"]["launches"]["FLASH_MHA_BWD_LAUNCHES"],
        "flash_alibi_mha_bwd": trained["runs"]["alibi"]["launches"]["FLASH_ALIBI_MHA_BWD_LAUNCHES"],
        "dist_weighted_sum": trained["runs"]["alibi"]["launches"]["DIST_WEIGHTED_SUM_LAUNCHES"],
    }
    quant_rows = quant["ln_quant_dense"][:UNI2_SITES]
    # phase 15: (a)'s two mesh runs (rows 4–8), (c)'s two in-process preprocess runs (rows 1–2)
    parallel_launches = parallel["extract"]["launches"] | {
        counter: sum(row["launches"][counter] for row in parallel["dp1"]) for counter in (*_COUNTERS, _PAIR_SUMS)
    }
    # phase 13's preprocess runs launch rows 1–3 too (CONCH, CONCH1.5, KEEP, TICON)
    zoo_launches = {k: sum(r["launches"].get(k, 0) for r in extractors["runs"])
                    for k in ("fused_qkv_mha", "fused_qkv_long", "ln_dense", "ln_quant_dense")}  # fmt: skip
    two_pass = next(r for r in extractors["two_pass"] if r["heads"] == 16)  # CONCH1.5, [64, 785, 3072]
    alibi2d_row = next(r for r in alibi2d["flash_alibi2d_mha"] if r["shape"][1] == 16385)
    pair_row = next(r for r in trained["pair_sums"] if r["shape"][1] == 16385)
    summary = {"kernels": [
        {
            "name": "fused_qkv_mha",
            "route": "cuda",
            "source": "stamp_tpu_torch/ops/csrc/fused_qkv_attn.cu",
            "replaces": "stamp_tpu/ops/flash_attention.py:589",
            "launches": main_path["launches"]["fused_qkv_mha"] + zoo_launches["fused_qkv_mha"],
            "max_abs_err": max(r["max_abs_err"] for r in kernels["fused_qkv_mha"] + extractors["two_pass"]),
            "ms": attn_row["ms"],
            "plain_ms": attn_row["plain_ms"],
            "bound_ms": attn_bound[0],
            "bound_by": attn_bound[1],
            "library_ms": attn_row["sdpa_bf16_ms"],
            # the two-pass kernel (N > 272, fused_qkv_long.cu) at CONCH1.5's
            # [64, 785, 3072] (phase 13); its launches are phase 13's
            "long_source": "stamp_tpu_torch/ops/csrc/fused_qkv_long.cu",
            "long_launches": zoo_launches["fused_qkv_long"],
            "long_ms": two_pass["ms"],
            "long_ms_b2b": two_pass["ms_b2b"],
            "long_plain_ms": two_pass["plain_ms"],
            "long_bound_ms": two_pass["bound_ms"],
            "long_bound_by": two_pass["bound_by"],
            "long_library_ms": two_pass["sdpa_bf16_ms"],
            "parallel_launches": parallel_launches["fused_qkv_mha"],
            # phase 17: both ranks' launches under TP (bf16 and int8) and PP
            # (bf16 and int8, 64 and 61 tiles); the heads of a rank under TP
            "tp_launches": model_parallel["tp_launches"]["fused_qkv_mha"],
            "pp_launches": model_parallel["pp_launches"]["fused_qkv_mha"],
            "tp_heads": model_parallel["heads"],
        },
        {
            "name": "ln_dense",
            "route": "cuda",
            "source": "stamp_tpu_torch/ops/csrc/ln_dense.cu",
            "replaces": "stamp_tpu/ops/ln_dense.py:185",
            "launches": main_path["launches"]["ln_dense"] + zoo_launches["ln_dense"],
            "max_abs_err": max(r["max_abs_err"] for r in kernels["ln_dense"]),
            "ms": sum(r["ms"] for r in ln_rows),
            "plain_ms": sum(r["plain_ms"] for r in ln_rows),
            "bound_ms": sum(r["bound_ms"] for r in ln_rows),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in ln_rows) else "bytes",
            "library_ms": sum(r["layer_norm_linear_bf16_ms"] for r in ln_rows),
            "parallel_launches": parallel_launches["ln_dense"],
            "tp_launches": model_parallel["tp_launches"]["ln_dense"],
            "pp_launches": model_parallel["pp_launches"]["ln_dense"],
            # the entry forms TP runs at fc2 (phase 17a): the caller's statistics, the partial sums
            "forms": {k.split("/")[1]: v for k, v in model_parallel["forms"].items() if k.startswith("ln_dense/")},
        },
        *(
            {
                "name": name,
                "route": "cuda",
                "source": "stamp_tpu_torch/ops/csrc/flash_attn.cu",
                "replaces": replaces,
                "launches": deploy["launches"][name] + sum(
                    run["launches"][counter] for run in trained["runs"].values()
                ),  # phase 6's deploy and phase 7's training (both variants)
                # the outputs at the shapes above; the skip cases print their
                # own (over dacc too, whose scale is the distances')
                "max_abs_err": max(r["max_abs_err"] for r in flash[name] if "case" not in r),
                "ms": flash_rows[name]["ms"],  # [8, 16385, 64], 40% of keys masked
                "plain_ms": flash_rows[name]["plain_ms"],
                "bound_ms": flash_rows[name]["bound_ms"],
                "bound_by": flash_rows[name]["bound_by"],
                "library_ms": flash_rows[name]["library_ms"],
                "heatmaps_launches": heatmaps["launches"][counter],  # phase 11's Grad-CAM
                "parallel_launches": parallel_launches[counter],  # phase 15 (a)
                "sp_launches": sequence["sp_launches"][counter],  # phase 16 (a), both ranks
            } | ({"bound_f32_ms": flash_rows[name]["bound_f32_ms"]} if "bound_f32_ms" in flash_rows[name] else {})
            for name, replaces, counter in (
                ("flash_mha", "stamp_tpu/ops/flash_attention.py:307", "FLASH_MHA_LAUNCHES"),
                ("flash_alibi_mha", "stamp_tpu/ops/flash_attention.py:950", "FLASH_ALIBI_MHA_LAUNCHES"),
            )
        ),
        *(
            {
                "name": name,
                "route": "cuda",
                "source": "stamp_tpu_torch/ops/csrc/flash_attn_bwd.cu",
                "replaces": replaces,
                "launches": train_launches[name],
                # the dense-dO shapes; the skip cases print their own errors
                "max_abs_err": max(r["max_abs_err"] for r in backward[name] if "case" not in r),
                "ms": bwd_rows[name]["ms"],  # [8, 16385, 64], 40% of keys masked
                "plain_ms": bwd_rows[name]["plain_ms"],
                "bound_ms": bwd_rows[name]["bound_ms"],
                "bound_by": bwd_rows[name]["bound_by"],
                "library_ms": bwd_rows[name]["library_ms"],
                "heatmaps_launches": heatmaps["launches"][counter],  # phase 11's Grad-CAM
                "parallel_launches": parallel_launches[counter],  # phase 15 (a)
                "sp_launches": sequence["sp_launches"][counter],  # phase 16 (a), both ranks
            } | ({"bound_f32_ms": bwd_rows[name]["bound_f32_ms"]} if "bound_f32_ms" in bwd_rows[name] else {})
            for name, replaces, counter in (
                ("flash_mha_bwd", "stamp_tpu/ops/flash_attention.py:236", "FLASH_MHA_BWD_LAUNCHES"),
                ("flash_alibi_mha_bwd", "stamp_tpu/ops/flash_attention.py:867", "FLASH_ALIBI_MHA_BWD_LAUNCHES"),
                ("dist_weighted_sum", "stamp_tpu/ops/flash_attention.py:702", "DIST_WEIGHTED_SUM_LAUNCHES"),
            )
        ),
        {
            "name": "ln_quant_dense",
            "route": "cuda",
            "source": "stamp_tpu_torch/ops/csrc/ln_quant_dense.cu",
            "replaces": "stamp_tpu/ops/ln_dense.py:377",
            "launches": int8_path["launches"]["ln_quant_dense"] + zoo_launches["ln_quant_dense"],
            "max_abs_err": max(r["max_abs_err"] for r in quant["ln_quant_dense"]),
            "ms": sum(r["ms"] for r in quant_rows),  # the three UNI2 sites, M = 16,960
            "plain_ms": sum(r["plain_ms"] for r in quant_rows),
            "bound_ms": sum(r["bound_ms"] for r in quant_rows),
            "bound_by": "operations" if all(r["bound_by"] == "operations" for r in quant_rows) else "bytes",
            "library_ms": sum(r["int_mm_ms"] for r in quant_rows),
            "tp_launches": model_parallel["tp_launches"]["ln_quant_dense"],
            "pp_launches": model_parallel["pp_launches"]["ln_quant_dense"],
            "forms": {k.split("/")[1]: v for k, v in model_parallel["forms"].items()
                      if k.startswith("ln_quant_dense/")},  # fmt: skip
        },
        {
            "name": "flash_alibi2d_mha",
            "route": "cuda",
            "source": "stamp_tpu_torch/ops/csrc/flash_alibi2d.cu",
            "replaces": "stamp_tpu/ops/flash_attention.py:433",
            "launches": sum(r["launches"] for r in titan["runs"].values()),
            "max_abs_err": max(r["max_abs_err"] for r in alibi2d["flash_alibi2d_mha"]),
            "ms": alibi2d_row["ms"],  # [12, 16385, 64]
            "plain_ms": alibi2d_row["plain_ms"],
            "bound_ms": alibi2d_row["bound_ms"],
            "bound_by": alibi2d_row["bound_by"],
            "library_ms": alibi2d_row["sdpa_f32_dense_bias_ms"],
        },
        {
            "name": "alibi_pair_sums",
            "route": "cuda",
            "source": "stamp_tpu_torch/ops/csrc/alibi_stats.cu",
            "replaces": "stamp_tpu/ops/attention.py:77",  # mean_pairwise_distance (XLA, no Pallas kernel)
            # one a training step: phase 7's ALiBi training and phase 8's crossval
            "launches": trained["runs"]["alibi"]["launches"][_PAIR_SUMS] + crossval["launches"][_PAIR_SUMS],
            "max_rel_err": max(r["rel_err"] for r in trained["pair_sums"]),  # against the plain version, phase 7
            "ms": pair_row["ms"],  # [1, 16385, 2], 12,001 valid (phase 7's largest bag and its CLS)
            "plain_ms": pair_row["plain_ms"],
            "bound_ms": pair_row["bound_ms"],
            "bound_by": pair_row["bound_by"],
            "parallel_launches": parallel_launches[_PAIR_SUMS],  # phase 15 (a)
            "sp_launches": sequence["sp_launches"][_PAIR_SUMS],  # phase 16 (a), both ranks
        },
    ]}
    print(json.dumps(summary))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
            }
        )
    )


if __name__ == "__main__":
    main()
