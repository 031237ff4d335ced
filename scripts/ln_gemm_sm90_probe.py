#!/usr/bin/env python3
"""Where the time of the port's ``ln_dense`` / ``ln_quant_dense`` kernels goes.

Builds the two kernels of ``stamp_tpu_torch/ops/csrc`` as they are and with
one part taken out, then times each build at the three UNI2 sites
(M = 16,960; K×N = 1536×4608, 1536×8192, 4096×1536) on one NVIDIA GPU:

* ``as_is``: the kernels unchanged;
* ``no_layernorm``: the normalization pass writes the raw x as A (bf16) or
  folds each 8 raw values into 8 bytes (int8): the same loads and stores,
  no LayerNorm, no quantization (the A transform's arithmetic);
* ``no_stores``: the epilogue stores nothing (the compiler then drops the
  epilogue's arithmetic too: the epilogue's cost).

The ablated builds compute wrong results; only their times mean anything.
Each time is the mean of two medians of 20 samples of back-to-back calls
(CUDA events; every build timed twice, in turns), the normalization pass
included.  Run from the repository root on a
machine with a CUDA card and ``nvcc``:

    python3 scripts/ln_gemm_sm90_probe.py [--against DIR]

``--against DIR`` also builds the sources of another tree's
``stamp_tpu_torch/ops/csrc`` (``git archive <commit> | tar -x -C DIR``) as
the variant ``other``, times it in the same turns, and prints the largest
|Δ| between its outputs and ``as_is``'s on the same inputs (``*_max_diff``).

It prints the card's name and power limit, then one JSON line per site.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from stamp_tpu_torch.ops import _build  # noqa: E402

OUT = REPO / "build" / "ln_gemm_sm90_probe"
SITES = ((16960, 1536, 4608, "norm1→qkv"), (16960, 1536, 8192, "norm2→fc1"), (16960, 4096, 1536, "mlp.norm→fc2"))

# variant → [(file, text in the source, its replacement)]
ABLATIONS = {
    "as_is": [],
    "no_layernorm": [
        ("ln_dense.cu", "y[i] = ln_pair(pairs[i], rstd, shift, make_float2(g[2 * i], g[2 * i + 1]), "
                        "make_float2(b[2 * i], b[2 * i + 1]));",
         "y[i] = pairs[i];"),
        ("ln_quant_dense.cu", "make_uint2(quantize4(make_uint2(raw.x, raw.y), g, b, mean, rstd, inv),\n" + " " * 46
                              + "quantize4(make_uint2(raw.z, raw.w), g + 4, b + 4, mean, rstd, inv));",
         "make_uint2(raw.x ^ raw.z, raw.y ^ raw.w);"),
    ],
    "no_stores": [("ln_gemm_sm90.cuh", "if (row + 8 * h < m && col < n)", "if (row + 8 * h < -1)")],
}  # fmt: skip


def build(variant: str, source: str, csrc: Path = _build.CSRC_DIR) -> Path:
    """Compile one kernel source of ``csrc`` with the variant's ablation into a library."""
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    for path in csrc.glob("*.cuh"):  # the source's headers, ablated where the variant says
        shutil.copy(path, d / path.name)
    for name in ("ln_gemm_sm90.cuh", source):
        text = (csrc / name).read_text()
        for file, old, new in ABLATIONS.get(variant, []):
            if file == name:
                if old not in text:
                    raise SystemExit(f"{variant}: {file} no longer holds {old!r}")
                text = text.replace(old, new)
        (d / name).write_text(text)
    lib = d / f"{Path(source).stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib), str(d / source)]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    return lib


def median_ms(fn, samples: int = 20, reps: int = 10) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def main() -> None:
    import argparse

    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--against", type=Path, help="another tree of the repository, built as variant 'other'")
    args = parser.parse_args()
    variants = {variant: _build.CSRC_DIR for variant in ABLATIONS}
    if args.against is not None:
        variants["other"] = args.against.resolve() / "stamp_tpu_torch" / "ops" / "csrc"
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)  # fmt: skip
    print(smi.stdout.strip().splitlines()[0])
    shutil.rmtree(OUT, ignore_errors=True)
    libs = {}
    for variant, csrc in variants.items():
        for kind, source, entry in (("bf16", "ln_dense.cu", "stamp_ln_dense"),
                                    ("int8", "ln_quant_dense.cu", "stamp_ln_quant_dense")):  # fmt: skip
            fn = getattr(ctypes.CDLL(str(build(variant, source, csrc))), entry)
            fn.argtypes, fn.restype = _build._SIGNATURES[entry], ctypes.c_int
            libs[(kind, variant)] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for m, k, n, site in SITES:
        x = torch.randn(m, k, device=dev, generator=gen).bfloat16()
        g = (1.0 + 0.1 * torch.randn(k, device=dev, generator=gen)).bfloat16()
        b = (0.1 * torch.randn(k, device=dev, generator=gen)).bfloat16()
        w = (torch.randn(n, k, device=dev, generator=gen) * k**-0.5).bfloat16()
        wq = torch.randint(-127, 128, (n, k), device=dev, generator=gen, dtype=torch.int8)
        ws = 1e-3 * torch.ones(n, device=dev)
        s_x = torch.tensor([5.0], device=dev)
        bias = (0.1 * torch.randn(n, device=dev, generator=gen)).bfloat16()
        scratch = torch.empty(2 * m + m * k, device=dev)  # room for [μ, 1/σ, A] and for an older [γ, β, μ, 1/σ]
        out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
        row = {"site": site, "m": m, "k": k, "n": n}
        samples: dict[str, list[float]] = {}
        outputs = {}
        # every build twice, in turns (forward, then backward), on one card
        for key in [*libs, *reversed(libs)]:
            kind, variant = key
            fn = libs[key]
            inputs = (x, g, b, w, bias) if kind == "bf16" else (x, g, b, s_x, wq, ws, bias)
            # no caller statistics (NULL), the bf16 epilogue (partial 0)
            ptrs = [*(t.data_ptr() for t in inputs), None, scratch.data_ptr(), out.data_ptr(), 0]
            call = lambda: fn(*ptrs, m, n, k, 1e-6, 0, stream)  # noqa: E731
            if call() != 0:
                raise SystemExit(f"{kind} {variant}: launch failed")
            torch.cuda.synchronize()
            if key not in outputs:
                outputs[key] = out.clone()
            samples.setdefault(f"{kind}_{variant}_ms", []).append(median_ms(call))
        for kind in ("bf16", "int8"):
            if (kind, "other") in outputs:
                diff = (outputs[(kind, "other")].float() - outputs[(kind, "as_is")].float()).abs().max().item()
                row[f"{kind}_other_max_diff"] = diff
        print(json.dumps(row | {name: statistics.mean(v) for name, v in samples.items()}), flush=True)


if __name__ == "__main__":
    main()
