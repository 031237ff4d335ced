#!/usr/bin/env python3
"""Where the time of the port's ``ln_dense`` / ``ln_quant_dense`` kernels goes.

Builds the two kernels of ``stamp_tpu_torch/ops/csrc`` as they are and with
one part taken out, then times each build at the three UNI2 sites
(M = 16,960; K×N = 1536×4608, 1536×8192, 4096×1536) on one NVIDIA GPU:

* ``as_is``: the kernels unchanged;
* ``no_layernorm``: the raw x fragment goes to the tensor cores as it is
  (no LayerNorm, no quantization: the A transform's cost);
* ``no_stores``: the epilogue stores nothing (the compiler then drops the
  epilogue's arithmetic too: the epilogue's cost).

The ablated builds compute wrong results; only their times mean anything.
Each time is the mean of two medians of 20 samples of back-to-back calls
(CUDA events; every build timed twice, in turns), the row-statistics kernel
included.  Run from the repository root on a
machine with a CUDA card and ``nvcc``:

    python3 scripts/ln_gemm_sm90_probe.py

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
        ("ln_dense.cu", "    a[0] = ln_pair(raw[0], f.rstd[0], shift[0], g_lo, b_lo);\n"
                        "    a[1] = ln_pair(raw[1], f.rstd[1], shift[1], g_lo, b_lo);\n"
                        "    a[2] = ln_pair(raw[2], f.rstd[0], shift[0], g_hi, b_hi);\n"
                        "    a[3] = ln_pair(raw[3], f.rstd[1], shift[1], g_hi, b_hi);",
         "    for (int i = 0; i < 4; ++i) a[i] = raw[i];"),
        ("ln_quant_dense.cu", "a[h + 2 * half] = quantize4(raw, g, b, f.mean[h], f.rstd[h], f.factor);",
         "a[h + 2 * half] = raw.x ^ raw.y;"),
    ],
    "no_stores": [("ln_gemm_sm90.cuh", "if (row + 8 * h < m && col < n)", "if (row + 8 * h < -1)")],
}  # fmt: skip


def build(variant: str, source: str) -> Path:
    """Compile one kernel source with the variant's ablation into a library."""
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    for name in ("ln_gemm_sm90.cuh", source):
        text = (_build.CSRC_DIR / name).read_text()
        for file, old, new in ABLATIONS[variant]:
            if file == name:
                if old not in text:
                    raise SystemExit(f"{variant}: {file} no longer holds {old!r}")
                text = text.replace(old, new)
        (d / name).write_text(text)
    lib = d / f"{Path(source).stem}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(d / source)]
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
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)  # fmt: skip
    print(smi.stdout.strip().splitlines()[0])
    shutil.rmtree(OUT, ignore_errors=True)
    libs = {}
    for variant in ABLATIONS:
        for kind, source, entry in (("bf16", "ln_dense.cu", "stamp_ln_dense"),
                                    ("int8", "ln_quant_dense.cu", "stamp_ln_quant_dense")):  # fmt: skip
            fn = getattr(ctypes.CDLL(str(build(variant, source))), entry)
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
        scratch = torch.empty(2 * k + 2 * m, device=dev)
        out = torch.empty(m, n, device=dev, dtype=torch.bfloat16)
        row = {"site": site, "m": m, "k": k, "n": n}
        samples: dict[str, list[float]] = {}
        # every build twice, in turns (forward, then backward), on one card
        for key in [*libs, *reversed(libs)]:
            kind, variant = key
            fn = libs[key]
            args = (x, g, b, w, bias, scratch, out) if kind == "bf16" else (x, g, b, s_x, wq, ws, bias, scratch, out)
            ptrs = [t.data_ptr() for t in args]
            call = lambda: fn(*ptrs, m, n, k, 1e-6, 0, stream)  # noqa: E731
            if call() != 0:
                raise SystemExit(f"{kind} {variant}: launch failed")
            samples.setdefault(f"{kind}_{variant}_ms", []).append(median_ms(call))
        print(json.dumps(row | {name: statistics.mean(v) for name, v in samples.items()}), flush=True)


if __name__ == "__main__":
    main()
