#!/usr/bin/env python3
"""Where the time of the port's ``fused_qkv_mha`` kernel goes.

Builds ``stamp_tpu_torch/ops/csrc/fused_qkv_attn.cu`` as it is and with one
part taken out or one path forced, then times each build on one NVIDIA GPU
at UNI2's shape ([64, 265, 3·24·64]) and Virchow's ([8, 257, 3·16·80]):

* ``as_is``: the kernel unchanged (the one-pass form at these N);
* ``no_exp``: the exponent's FMA without the ex2 (the special-function
  unit's share);
* ``no_stores``: the output is never stored, so the compiler drops all the
  arithmetic: what is left is staging K and V, loading q and the ldmatrix
  reads (the memory side);
* ``sweeps``: the three-sweep form at every N (the previous design, kept for
  N above the one-pass limit), timed beside the one-pass one.

The ablated builds compute wrong results; only their times mean anything.
Each time is the mean of two medians of 20 samples of 10 back-to-back calls
(CUDA events; every build timed twice, in turns), beside one call of
``F.scaled_dot_product_attention`` (bf16) on the same input.  Run from the
repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/fused_qkv_attn_probe.py

It prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from stamp_tpu_torch.ops import _build  # noqa: E402

OUT = REPO / "build" / "fused_qkv_attn_probe"
SOURCE = "fused_qkv_attn.cu"
SHAPES = ((64, 265, 24, 64, "UNI2"), (8, 257, 16, 80, "Virchow"))

# variant → [(text in the source, its replacement)]
ABLATIONS = {
    "as_is": [],
    "no_exp": [("s[j][e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));", "s[j][e] = fmaf(s[j][e], c, -mc[e >> 1]);")],
    "no_stores": [("        if (row < n)\n", "        if (row < -1)\n")],
    "sweeps": [("return n <= kMaxKeys ?", "return n <= 0 ?")],
}


def build(variant: str) -> Path:
    """Compile the kernel source with the variant's ablation into a library."""
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    shutil.copy(_build.CSRC_DIR / "ln_gemm_sm90.cuh", d)
    text = (_build.CSRC_DIR / SOURCE).read_text()
    for old, new in ABLATIONS[variant]:
        if old not in text:
            raise SystemExit(f"{variant}: {SOURCE} no longer holds {old!r}")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    lib = d / "fused_qkv_attn.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(d / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{variant}: nvcc failed:\n{proc.stderr}")
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
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)  # fmt: skip
    print(smi.stdout.strip().splitlines()[0])
    shutil.rmtree(OUT, ignore_errors=True)
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:  # one nvcc per variant, all at once
        paths = dict(zip(ABLATIONS, pool.map(build, ABLATIONS)))
    libs = {}
    for variant, path in paths.items():
        fn = ctypes.CDLL(str(path)).stamp_fused_qkv_attn
        fn.argtypes, fn.restype = _build._SIGNATURES["stamp_fused_qkv_attn"], ctypes.c_int
        libs[variant] = fn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for b, n, h, d, name in SHAPES:
        qkv = torch.randn(b, n, 3 * h * d, device=dev, generator=gen).bfloat16()
        out = torch.empty(b, n, h * d, device=dev, dtype=torch.bfloat16)

        def sdpa(qkv=qkv, b=b, n=n, h=h, d=d):
            q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
            return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, h * d)

        calls = {f"{v}_ms": (lambda fn=fn: fn(qkv.data_ptr(), out.data_ptr(), b, n, h, d, 0, stream))
                 for v, fn in libs.items()} | {"sdpa_bf16_ms": sdpa}  # fmt: skip
        for key, call in calls.items():
            if key != "sdpa_bf16_ms" and call() != 0:
                raise SystemExit(f"{key}: launch failed")
        samples: dict[str, list[float]] = {}
        for key in [*calls, *reversed(calls)]:  # every build twice, in turns, on one card
            samples.setdefault(key, []).append(median_ms(calls[key]))
        row = {"shape": [b, n, 3 * h * d], "head_dim": d, "model": name}
        print(json.dumps(row | {k: statistics.mean(v) for k, v in samples.items()}), flush=True)


if __name__ == "__main__":
    main()
