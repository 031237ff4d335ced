#!/usr/bin/env python3
"""Where the time of the port's TITAN attention kernel goes, and which of
its variants is fastest.

Builds ``stamp_tpu_torch/ops/csrc/flash_alibi2d.cu`` as it is and with one
setting changed or one part taken out, then times one call
(``stamp_flash_alibi2d_fwd``: the pre-pass and the attention kernel) of
each build on one NVIDIA GPU at TITAN's shapes [12, N, 64], N = 4,097,
16,385 and 20,001 (a patient of two 10,000-tile slides), with TITAN's
slopes and the grid coordinates of a slide-shaped tissue region:

* ``as_is``: the kernel unchanged (4 stages of 64 keys at d = 64, the
  consumer warpgroups taking turns at their products);
* ``stages_3`` / ``stages_5``: the ring's depth;
* ``tile_32`` / ``tile_128``: keys per loop step (and per stage);
* ``no_dist``: the distance (and its square root) left out, the bias a
  constant: the most that computing each distance once for the heads that
  share a coordinate set could save;
* ``no_exp``: the exponent of P left out (the special-function unit's
  share);
* ``ieee_sqrt``: the IEEE square root in place of sqrt.approx;
* ``cvt_rna``: P rounded to TF32 by cvt.rna instead of the two integer
  operations of ``tf32_round`` (the same bits);
* ``no_round``: P passed to the tensor cores unrounded (they truncate it);
* ``no_turns``: the two consumer warpgroups issue their products without
  taking turns (no named barriers);
* ``no_setmaxnreg``: the producer keeps its registers (the consumers stay
  at 168).

The ablated builds compute wrong results; only their times mean anything.
Each time is the mean of two medians of 10 samples of 3 back-to-back calls
(CUDA events; every build timed twice, in turns, on one card).  Run from
the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/flash_alibi2d_probe.py

It prints the card's name and power limit, each build's registers and
spills, then one JSON line per shape with each build's time and TFLOP/s.
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

OUT = REPO / "build" / "flash_alibi2d_probe"
SOURCE = "flash_alibi2d.cu"
HEADER = "tf32_wgmma.cuh"
SHAPES = ((12, 4097, 64), (12, 16385, 64), (12, 20001, 64))

_CFG64 = "struct A2Cfg<64> {\n  static constexpr int kGroups = 2, kTile = 64, kStages = 4;"
_DIST = "distance(qx[h], qy[h], (e & 1) ? c.z : c.x, (e & 1) ? c.w : c.y)"
_EXP = "pr[e] = exp2_approx(fmaf(sc[4 * j + e], c_scale, mc[e >> 1]));"
_CVT = """      frag[j][0] = tf32_round(pr[0]);
      frag[j][1] = tf32_round(pr[2]);
      frag[j][2] = tf32_round(pr[1]);
      frag[j][3] = tf32_round(pr[3]);"""
_TURN = "    named_barrier_sync(1 + wg, 256);\n"
_TURN_END = "    named_barrier_arrive(2 - wg, 256);\n"
_FIRST_TURN = "  if (wg == 1) named_barrier_arrive(1, 256);  // warpgroup 0 takes the first turn\n"
_REGS = "  reg_alloc<kConsumerRegs>();\n"
# variant → [(file, text in it, its replacement)]
VARIANTS = {
    "as_is": [],
    "stages_3": [(SOURCE, _CFG64, _CFG64.replace("kStages = 4", "kStages = 3"))],
    "stages_5": [(SOURCE, _CFG64, _CFG64.replace("kStages = 4", "kStages = 5"))],
    "tile_32": [(SOURCE, _CFG64, _CFG64.replace("kTile = 64", "kTile = 32"))],
    "tile_128": [(SOURCE, _CFG64, _CFG64.replace("kTile = 64, kStages = 4", "kTile = 128, kStages = 2"))],
    "no_dist": [(SOURCE, _DIST, "(c.x + c.w)")],
    "no_exp": [(SOURCE, _EXP, _EXP.replace("exp2_approx(", "(")[:-1] + ";")],
    "ieee_sqrt": [(HEADER, 'asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));', "r = sqrtf(x);")],
    "cvt_rna": [(SOURCE, _CVT, _CVT.replace("tf32_round(", "to_tf32("))],
    "no_round": [(SOURCE, _CVT, _CVT.replace("tf32_round(", "__float_as_uint("))],
    "no_turns": [(SOURCE, _TURN, ""), (SOURCE, _TURN_END, ""), (SOURCE, _FIRST_TURN, "")],
    "no_setmaxnreg": [(SOURCE, _REGS, ""), (SOURCE, "    reg_dealloc<kProducerRegs>();\n", "")],
}  # fmt: skip


def build(variant: str) -> tuple[Path, str]:
    """Compile the source with the variant's change into a library; return
    it and ptxas's lines on the attention kernel."""
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    texts = {name: (_build.CSRC_DIR / name).read_text() for name in (SOURCE, HEADER)}
    for name, old, new in VARIANTS[variant]:
        if old not in texts[name]:
            raise SystemExit(f"{variant}: {name} no longer holds {old!r}")
        texts[name] = texts[name].replace(old, new)
    for name, text in texts.items():
        (d / name).write_text(text)
    lib = d / "flash_alibi2d.so"
    # the variant's own header first (a quoted include searches the source's directory)
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(d / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{variant}: nvcc failed:\n{proc.stderr}")
    report, keep = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            keep = "flash_alibi2d_kernelILi64" in line
        elif keep and ("registers" in line or "spill" in line):
            report.append(line.strip())
    return lib, " | ".join(report)


def median_ms(fn, samples: int = 10, reps: int = 3) -> float:
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


def tissue_coords(n: int):
    """CLS at (0, 0), then the integer grid cells of an elliptical region
    (1.6:1), row by row, as TITAN sees a slide."""
    import math

    import numpy as np

    a = math.sqrt(1.6 * n / math.pi) + 2
    b = a / 1.6
    ys, xs = np.mgrid[0 : int(2 * b) + 1, 0 : int(2 * a) + 1]
    inside = ((xs - a) / a) ** 2 + ((ys - b) / b) ** 2 <= 1.0
    cells = np.stack([xs[inside], ys[inside]], axis=1)[: n - 1]
    return np.concatenate([np.zeros((1, 2)), cells]).astype(np.float32)


def main() -> None:
    import torch

    from stamp_tpu_torch.models.slide_encoders import alibi_slopes

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)  # fmt: skip
    print(smi.stdout.strip().splitlines()[0])
    shutil.rmtree(OUT, ignore_errors=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc per variant, all at once
        built = dict(zip(VARIANTS, pool.map(build, VARIANTS)))
    entries = {}
    for variant, (path, report) in built.items():
        print(json.dumps({"variant": variant, "ptxas": report}))
        lib = ctypes.CDLL(str(path))
        for name in ("stamp_flash_alibi2d_fwd", "stamp_flash_alibi2d_workspace"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = _build._SIGNATURES[name], ctypes.c_int
        entries[variant] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for bh, n, d in SHAPES:
        q, k, v = (torch.randn(bh, n, d, device=dev, generator=gen) for _ in range(3))
        coords = torch.from_numpy(tissue_coords(n)).to(dev).expand(bh, n, 2).contiguous()
        slopes = torch.from_numpy(alibi_slopes(bh)).to(dev)
        out = torch.empty_like(q)
        nbytes = ctypes.c_int64()
        entries["as_is"].stamp_flash_alibi2d_workspace(bh, n, d, ctypes.addressof(nbytes))
        workspace = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        ptrs = [x.data_ptr() for x in (q, k, v, coords, slopes, workspace, out)]

        def call(lib):
            err = lib.stamp_flash_alibi2d_fwd(*ptrs, bh, n, d, d**-0.5, 1, 0, stream)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")

        calls = {variant: (lambda lib=lib: call(lib)) for variant, lib in entries.items()}
        samples: dict[str, list[float]] = {}
        for key in [*calls, *reversed(calls)]:  # every build twice, in turns, on one card
            samples.setdefault(key, []).append(median_ms(calls[key]))
        flops = 4 * bh * n * n * d
        row = {"shape": [bh, n, d]}
        for variant, times in samples.items():
            ms = statistics.mean(times)
            row[f"{variant}_ms"] = ms
            row[f"{variant}_tflops"] = flops / ms / 1e9
        print(json.dumps(row), flush=True)
        del q, k, v, coords, out, workspace
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
