#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stamp_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints at least one line; any failure exits non-zero):

1. device: the card's name and power limit (``nvidia-smi``); TF32 off.
2. build: compiles ``stamp_tpu_torch/ops/csrc/*.cu`` and loads them.
3. kernels: each CUDA kernel against its plain PyTorch version at the UNI2
   shapes in bf16, max |Δ| / max |ref| against a stated tolerance, and the
   median time of each (with a bf16 PyTorch control for reference).
4. main path: ``python -m stamp_tpu_torch -c config.yaml --profile
   preprocess`` in-process, UNI2 at full width with random weights on a
   synthetic 3072×3072 px slide (144 tiles at 256 µm / 224 px, batch 64);
   checks the h5 and that every kernel launch count grew as the model's
   structure says.
5. whole model: the same UNI2 weights on 8 tiles through the kernel path
   and the plain path on the card (per-tile cosine), and the steady-state
   forward rate at batch 64.

The line before the last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
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


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _time_ms(fn, iters: int) -> list[float]:
    """Per-call device time of ``fn`` (CUDA events), after a warm-up call."""
    import torch

    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return times


def _compare_timed(kernel, plain, control=None, iters: int = 5) -> dict:
    """Kernel vs plain (vs a bf16 control), timed in turns (plain, kernel,
    control, control, kernel, plain) on this one card; medians in ms."""
    fns = {"plain": plain, "kernel": kernel, "control": control}
    samples: dict[str, list[float]] = {k: [] for k, fn in fns.items() if fn is not None}
    for name in ("plain", "kernel", "control", "control", "kernel", "plain"):
        if fns[name] is not None:
            samples[name] += _time_ms(fns[name], iters)
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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print(f"[2 build] {line.strip()}")


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
        row = dict(shape=[b, n, 3 * h * d], heads=h, head_dim=d, max_abs_err=abs_err,
                   rel_err=rel_err, ms=t["kernel"], plain_ms=t["plain"], sdpa_bf16_ms=t["control"])  # fmt: skip
        print(f"[3 kernels] fused_qkv_mha {json.dumps(row)} on {card}")
        if not rel_err <= KERNEL_TOL:
            _fail(f"fused_qkv_mha {row['shape']}: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}")
        results["fused_qkv_mha"].append(row)
        del qkv, got, want

    # ragged shapes: N below one 64-key chunk; M and N off the 64×128 tile
    qkv = randn(3, 21, 3 * 4 * 64)
    _, rel_attn = _error(attn.fused_qkv_mha(qkv, 4), attn.fused_qkv_mha_reference(qkv, 4))
    x, g, beta, w, bias = randn(1000, 264), randn(264), randn(264), randn(200, 264, scale=0.06), randn(200)
    _, rel_ln = _error(lnd.ln_dense(x, g, beta, w, bias), lnd.ln_dense_reference(x, g, beta, w, bias))
    print(f"[3 kernels] ragged: fused_qkv_mha [3, 21, 768] rel {rel_attn:.3g}; ln_dense M=1000 K=264 N=200 rel {rel_ln:.3g}")
    if not (rel_attn <= KERNEL_TOL and rel_ln <= KERNEL_TOL):
        _fail("ragged shapes disagree with the plain versions")

    m = BATCH * UNI2_TOKENS  # 16,960 rows: the TPU kernel's 256-row gate refused this M
    for k, n, site in ((1536, 4608, "norm1→qkv"), (1536, 8192, "norm2→fc1"), (4096, 1536, "mlp.norm→fc2")):
        x = randn(m, k)
        g = (1.0 + 0.1 * torch.randn(k, device=dev, generator=gen)).to(torch.bfloat16)
        beta = randn(k, scale=0.1)
        w = randn(n, k, scale=k**-0.5)
        bias = randn(n, scale=0.1)
        got = lnd.ln_dense(x, g, beta, w, bias)
        want = lnd.ln_dense_reference(x, g, beta, w, bias)
        torch.cuda.synchronize()
        abs_err, rel_err = _error(got, want)
        t = _compare_timed(
            lambda: lnd.ln_dense(x, g, beta, w, bias),
            lambda: lnd.ln_dense_reference(x, g, beta, w, bias),
            lambda: F.linear(F.layer_norm(x, (k,), g, beta, 1e-6), w, bias),
        )
        row = dict(site=site, m=m, k=k, n=n, max_abs_err=abs_err, rel_err=rel_err,
                   ms=t["kernel"], plain_ms=t["plain"], layer_norm_linear_bf16_ms=t["control"],
                   kernel_tflops=2 * m * k * n / t["kernel"] / 1e9)  # fmt: skip
        print(f"[3 kernels] ln_dense {json.dumps(row)} on {card}")
        if not rel_err <= KERNEL_TOL:
            _fail(f"ln_dense {site}: max|Δ|/max|ref| {rel_err} > {KERNEL_TOL}")
        results["ln_dense"].append(row)
        del x, w, got, want
    torch.cuda.empty_cache()
    return results


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

    from stamp_tpu_torch.__main__ import main
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

    attn.LAUNCHES = 0
    lnd.LAUNCHES = 0
    t0 = time.perf_counter()
    main(["-c", str(config), "--profile", "preprocess"])  # exits non-zero on failure
    wall = time.perf_counter() - t0
    launches = {"fused_qkv_mha": attn.LAUNCHES, "ln_dense": lnd.LAUNCHES}

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
    forward_s = extract.profiling.timer.seconds["preprocess/device_forward"]
    row = dict(tiles=n, batches=batches, launches=launches, wall_s=wall,
               forward_s=forward_s, forward_tiles_per_s=n / forward_s)  # fmt: skip
    print(f"[4 main path] {json.dumps(row)} on {card}")
    return row


def phase_whole_model(card: str) -> None:
    import numpy as np
    import torch

    from stamp_tpu_torch.models import vit_image
    from stamp_tpu_torch.ops.flash_attention import fused_qkv_mha_reference
    from stamp_tpu_torch.ops.ln_dense import ln_dense_reference
    from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor

    dev = torch.device("cuda:0")
    rng = np.random.default_rng(1)
    tiles = rng.integers(60, 200, (BATCH, 224, 224, 3), dtype=np.uint8)

    def plain_path(fn, *args):
        kernel_fns = (vit_image.ln_dense, vit_image.fused_qkv_mha)
        vit_image.ln_dense, vit_image.fused_qkv_mha = ln_dense_reference, fused_qkv_mha_reference
        try:
            return fn(*args)
        finally:
            vit_image.ln_dense, vit_image.fused_qkv_mha = kernel_fns

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
        f"{t['kernel']:.2f} ms ({BATCH / t['kernel'] * 1e3:.1f} tiles/s), plain path "
        f"{t['plain']:.2f} ms ({BATCH / t['plain'] * 1e3:.1f} tiles/s) on {card}"
    )
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


def main() -> None:
    try:
        import torch
    except ImportError as e:
        _fail(f"PyTorch is not installed: {e}")
    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is False: this smoke test needs a CUDA GPU")
    if not (REPO / "stamp_tpu_torch").is_dir() or not (REPO / "stamp_tpu").is_dir():
        _fail(f"run from a checkout of the repository ({REPO} has no stamp_tpu_torch/)")
    sys.path.insert(0, str(REPO))
    shutil.rmtree(WORK, ignore_errors=True)

    kind, card = phase_device()
    phase_build()
    kernels = phase_kernels(card)
    main_path = phase_main_path(card)
    phase_whole_model(card)
    shutil.rmtree(WORK, ignore_errors=True)

    attn_row = kernels["fused_qkv_mha"][0]
    ln_rows = kernels["ln_dense"]
    summary = {
        "kernels": [
            {
                "name": "fused_qkv_mha",
                "route": "cuda",
                "source": "stamp_tpu_torch/ops/csrc/fused_qkv_attn.cu",
                "replaces": "stamp_tpu/ops/flash_attention.py:589",
                "launches": main_path["launches"]["fused_qkv_mha"],
                "max_abs_err": max(r["max_abs_err"] for r in kernels["fused_qkv_mha"]),
                "ms": attn_row["ms"],  # UNI2 shape, batch 64
                "plain_ms": attn_row["plain_ms"],
            },
            {
                "name": "ln_dense",
                "route": "cuda",
                "source": "stamp_tpu_torch/ops/csrc/ln_dense.cu",
                "replaces": "stamp_tpu/ops/ln_dense.py:185",
                "launches": main_path["launches"]["ln_dense"],
                "max_abs_err": max(r["max_abs_err"] for r in ln_rows),
                "ms": sum(r["ms"] for r in ln_rows),  # the three sites of one block
                "plain_ms": sum(r["plain_ms"] for r in ln_rows),
            },
        ]
    }
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
