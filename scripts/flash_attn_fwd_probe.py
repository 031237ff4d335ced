#!/usr/bin/env python3
"""Where the time of the port's MIL forward flash kernel goes, and which of
its variants is fastest.

Builds ``stamp_tpu_torch/ops/csrc/flash_attn.cu`` (with the unchanged
``flash_attn_bwd.cu``, whose distance-weighted sum the ALiBi entry calls)
as it is and with one setting changed or one part taken out, then times
one call of ``stamp_flash_attn_fwd`` (the pre-pass, the tile list and the
attention kernel) of each build on one NVIDIA GPU at the MIL deploy and
training shapes [8, T, 64], T = 4,097 and 16,385, with the last 40% of the
keys masked (bucket padding) and with whole masked 64- and 128-key tiles
and 30% of the other keys masked (``tests/flash_bwd_util.py``'s holes):

* ``as_is``: the kernel unchanged (4 stages of 64 keys at d = 64, the
  consumer warpgroups taking turns at their products);
* ``stages_2`` / ``stages_3`` / ``stages_5``: the ring's depth (six
  stages of 33 KB and the queries' 32 KB do not fit in a block's 227 KB);
* ``tile_32``: 32 keys per loop step (and per stage);
* ``every_tile``: the list holds every key tile, so that the masked tiles
  are computed too (what the skipping saves; the results stay right);
* ``no_exp``: the exponent of P left out (the special-function unit's
  share);
* ``no_turns``: the two consumer warpgroups issue their products without
  taking turns (no named barriers);
* ``no_setmaxnreg``: the producer keeps its registers (the consumers stay
  at 168).

The ``no_exp`` build computes wrong results; only its time means anything.
Each time is the mean of two medians of 10 samples of 3 back-to-back calls
(CUDA events; every build timed twice, in turns, on one card).  Run from
the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/flash_attn_fwd_probe.py

It prints the card's name and power limit, each build's registers and
spills, then one JSON line per shape and mask with each build's time and
its TFLOP/s over the valid keys.
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
sys.path.insert(0, str(REPO / "tests"))

from stamp_tpu_torch.ops import _build  # noqa: E402

OUT = REPO / "build" / "flash_attn_fwd_probe"
SOURCE = "flash_attn.cu"
SHAPES = ((8, 4097, 64), (8, 16385, 64))

_CFG64 = "struct FwdCfg<64> {\n  static constexpr int kGroups = 2, kTile = 64, kStages = 4;"
_EXP = "pr[e] = exp2_approx(fmaf(sc[4 * j + e], c_scale, mc[e >> 1]));"
_ON = "      on = !any;\n"
_TURN = "    named_barrier_sync(1 + wg, 256);\n"
_TURN_END = "    named_barrier_arrive(2 - wg, 256);\n"
_FIRST_TURN = "  if (wg == 1) named_barrier_arrive(1, 256);  // warpgroup 0 takes the first turn\n"
_REGS = "  reg_alloc<kConsumerRegs>();\n"
# variant → [(text in the source, its replacement)]
VARIANTS = {
    "as_is": [],
    "stages_2": [(_CFG64, _CFG64.replace("kStages = 4", "kStages = 2"))],
    "stages_3": [(_CFG64, _CFG64.replace("kStages = 4", "kStages = 3"))],
    "stages_5": [(_CFG64, _CFG64.replace("kStages = 4", "kStages = 5"))],
    "tile_32": [(_CFG64, _CFG64.replace("kTile = 64", "kTile = 32"))],
    "every_tile": [(_ON, "      on = true;\n")],
    "no_exp": [(_EXP, _EXP.replace("exp2_approx(", "(")[:-1] + ";")],
    "no_turns": [(_TURN, ""), (_TURN_END, ""), (_FIRST_TURN, "")],
    "no_setmaxnreg": [(_REGS, ""), ("    reg_dealloc<kProducerRegs>();\n", "")],
}  # fmt: skip


def build(variant: str) -> tuple[Path, str]:
    """Compile the source with the variant's change (and the backward's
    source) into a library; return it and ptxas's lines on the d = 64
    attention kernel."""
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / SOURCE).read_text()
    for old, new in VARIANTS[variant]:
        if old not in text:
            raise SystemExit(f"{variant}: {SOURCE} no longer holds {old!r}")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    lib = d / "flash_attn.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(d / SOURCE),
           str(_build.CSRC_DIR / "flash_attn_bwd.cu")]  # fmt: skip
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{variant}: nvcc failed:\n{proc.stderr}")
    report, keep = [], False
    for line in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry" in line:
            keep = "flash_fwd_kernelILi64ELb0" in line
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


def main() -> None:
    import torch
    from flash_bwd_util import skip_case_inputs

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
        for name in ("stamp_flash_attn_fwd", "stamp_flash_attn_fwd_workspace"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = _build._SIGNATURES[name], ctypes.c_int
        entries[variant] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for bh, t, d in SHAPES:
        for mask_kind in ("suffix", "holes"):
            q, k, v, mask, *_ = skip_case_inputs(gen, bh, t, t, d, mask_kind, "dense")
            o, lse = torch.empty_like(q), torch.empty(bh, t, device=dev)
            nbytes = ctypes.c_int64()
            entries["as_is"].stamp_flash_attn_fwd_workspace(bh, t, t, d, ctypes.addressof(nbytes))
            workspace = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
            ptrs = [x.data_ptr() for x in (q, k, v, mask, workspace, o, lse)]

            def call(lib):
                err = lib.stamp_flash_attn_fwd(*ptrs, bh, t, t, d, d**-0.5, 0, stream)
                if err != 0:
                    raise SystemExit(f"launch failed: CUDA error {err}")

            calls = {variant: (lambda lib=lib: call(lib)) for variant, lib in entries.items()}
            samples: dict[str, list[float]] = {}
            for key in [*calls, *reversed(calls)]:  # every build twice, in turns, on one card
                samples.setdefault(key, []).append(median_ms(calls[key]))
            flops = 4 * d * t * mask.sum().item()  # q·kᵀ and P·V over the valid keys
            row = {"shape": [bh, t, d], "mask": mask_kind, "valid_keys": mask.float().mean().item()}
            for variant, times in samples.items():
                ms = statistics.mean(times)
                row[f"{variant}_ms"] = ms
                row[f"{variant}_tflops"] = flops / ms / 1e9
            print(json.dumps(row), flush=True)
            del q, k, v, mask, o, lse, workspace
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
