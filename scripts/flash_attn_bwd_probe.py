#!/usr/bin/env python3
"""Where the time of the port's flash backward goes.

Builds ``stamp_tpu_torch/ops/csrc/flash_attn_bwd.cu`` as it is and with one
part taken out or forced, then times one backward call
(``stamp_flash_attn_bwd``: pre-pass, tile lists, dQ, dK/dV) of each build
on one NVIDIA GPU at the whole-slide training shapes [8, T, 64] with the
last 40% of keys masked:

* ``as_is``: the four kernels unchanged;
* ``prepass_only``: the pre-pass and the tile lists alone (no dQ, no
  dK/dV): subtracted from ``no_dkv`` and ``no_dq`` it gives the dQ and the
  dK/dV kernel alone;
* ``no_dkv`` / ``no_dq``: one of the two reduction kernels left out;
* ``no_exp``: the exponent of P left out (the special-function unit's
  share);
* ``no_second``: the second products (dS·k, Pᵀ·dO, dSᵀ·q) left out, their
  A fragments folded into the accumulators by one add each so that the
  score products and the dS arithmetic stay;
* ``loads_only``: the second products left out with nothing to consume
  the scores, so the compiler drops every product and the arithmetic: what
  is left is the ring's TMA traffic and its barriers;
* ``no_skip``: every tile live (no skipped key or query tile, no block or
  warpgroup that only stores zeros, every copy made): what the skipping
  saves.

The ablated builds compute wrong results; only their times mean anything.
Each time is the mean of two medians of 10 samples of 5 back-to-back calls
(CUDA events; every build timed twice, in turns).  dO is dense, or (``last
layer``) zero on every row but row 0, as the MIL model's last layer gives
it.  Run from the repository root on a machine with a CUDA card and
``nvcc``:

    python3 scripts/flash_attn_bwd_probe.py

It prints the card's name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from stamp_tpu_torch.ops import _build  # noqa: E402

OUT = REPO / "build" / "flash_attn_bwd_probe"
SOURCE = "flash_attn_bwd.cu"
# (bh, T, d, dO)
SHAPES = ((8, 4097, 64, "dense"), (8, 16385, 64, "dense"), (8, 16385, 64, "last layer"))

_DQ_LAUNCH = "flash_bwd_dq_kernel<D><<<"
_DKV_LAUNCH = "flash_bwd_dkv_kernel<D><<<"
# variant → [(text in the source, its replacement)]
ABLATIONS = {
    "as_is": [],
    "prepass_only": [(_DQ_LAUNCH, "if (false) " + _DQ_LAUNCH), (_DKV_LAUNCH, "if (false) " + _DKV_LAUNCH)],
    "no_dkv": [(_DKV_LAUNCH, "if (false) " + _DKV_LAUNCH)],
    "no_dq": [(_DQ_LAUNCH, "if (false) " + _DQ_LAUNCH)],
    "no_exp": [
        ("const float pr = exp2f((sv - lse[e >> 1]) * kLog2e);", "const float pr = (sv - lse[e >> 1]) * kLog2e;"),
        ("pt[e] = exp2f((sv - ((e & 1) ? l2.y : l2.x)) * kLog2e);", "pt[e] = (sv - ((e & 1) ? l2.y : l2.x)) * kLog2e;"),
    ],
    "no_second": [
        ("wgmma_tf32_rs(acc, a[j], kstep_desc<D>(st + L::kKt, j), 1);",
         "acc[j] += __uint_as_float(a[j][0] ^ a[j][1] ^ a[j][2] ^ a[j][3]);"),
        ("wgmma_tf32_rs(acc_dv, pa[j], kstep_desc<D>(st + L::kDot, j), 1);",
         "acc_dv[j] += __uint_as_float(pa[j][0] ^ pa[j][1] ^ pa[j][2] ^ pa[j][3]);"),
        ("wgmma_tf32_rs(acc_dk, da[j], kstep_desc<D>(st + L::kQt, j), 1);",
         "acc_dk[j] += __uint_as_float(da[j][0] ^ da[j][1] ^ da[j][2] ^ da[j][3]);"),
    ],
    "loads_only": [
        ("wgmma_tf32_rs(acc, a[j], kstep_desc<D>(st + L::kKt, j), 1);", ";"),
        ("wgmma_tf32_rs(acc_dv, pa[j], kstep_desc<D>(st + L::kDot, j), 1);", ";"),
        ("wgmma_tf32_rs(acc_dk, da[j], kstep_desc<D>(st + L::kQt, j), 1);", ";"),
    ],
    "no_skip": [
        ("on = every;", "on = true;"),
        ("if (!live) {\n    store_zero_rows<D>(dq,", "if (false) {\n    store_zero_rows<D>(dq,"),
        ("if (!live) {\n    store_zero_rows<D>(dk,", "if (false) {\n    store_zero_rows<D>(dk,"),
        ("const bool wg_live = units[2 * wg] || units[2 * wg + 1];", "const bool wg_live = true;"),
        ("const bool wg_live = !p.any_valid[bh] || units[2 * wg] || units[2 * wg + 1];", "const bool wg_live = true;"),
        ("    if (any) {\n", "    if (true) {\n"),
    ],
}  # fmt: skip


def build(variant: str) -> Path:
    """Compile the backward's source with the variant's ablation into a library."""
    d = OUT / variant
    d.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / SOURCE).read_text()
    for old, new in ABLATIONS[variant]:
        if old not in text:
            raise SystemExit(f"{variant}: {SOURCE} no longer holds {old!r}")
        text = text.replace(old, new)
    (d / SOURCE).write_text(text)
    lib = d / "flash_attn_bwd.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(d / SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{variant}: nvcc failed:\n{proc.stderr}")
    return lib


def median_ms(fn, samples: int = 10, reps: int = 5) -> float:
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

    from stamp_tpu_torch.ops import flash_attention as attn

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)  # fmt: skip
    print(smi.stdout.strip().splitlines()[0])
    shutil.rmtree(OUT, ignore_errors=True)
    with ThreadPoolExecutor(len(ABLATIONS)) as pool:  # one nvcc per variant, all at once
        paths = dict(zip(ABLATIONS, pool.map(build, ABLATIONS)))
    entries = {}
    for variant, path in paths.items():
        lib = ctypes.CDLL(str(path))
        for name in ("stamp_flash_attn_bwd", "stamp_flash_attn_bwd_workspace"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = _build._SIGNATURES[name], ctypes.c_int
        entries[variant] = lib

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for bh, t, d, do_kind in SHAPES:
        q, k, v = (torch.randn(bh, t, d, device=dev, generator=gen) for _ in range(3))
        mask = (torch.arange(t, device=dev) < t - (2 * t) // 5).expand(bh, t).contiguous()
        out, lse = attn._flash_forward_reference(q, k, v, mask)
        do = torch.randn(bh, t, d, device=dev, generator=gen)
        if do_kind == "last layer":
            do[:, 1:] = 0.0
        grads = [torch.empty_like(q) for _ in range(3)]
        nbytes = ctypes.c_int64()
        entries["as_is"].stamp_flash_attn_bwd_workspace(bh, t, t, d, ctypes.addressof(nbytes))
        workspace = torch.empty(nbytes.value, dtype=torch.uint8, device=dev)
        ptrs = [x.data_ptr() for x in (q, k, v, mask, do, out, lse, workspace, *grads)]

        def call(lib):
            err = lib.stamp_flash_attn_bwd(*ptrs, bh, t, t, d, d**-0.5, 0, stream)
            if err != 0:
                raise SystemExit(f"launch failed: CUDA error {err}")

        calls = {f"{variant}_ms": (lambda lib=lib: call(lib)) for variant, lib in entries.items()}
        samples: dict[str, list[float]] = {}
        for key in [*calls, *reversed(calls)]:  # every build twice, in turns, on one card
            samples.setdefault(key, []).append(median_ms(calls[key]))
        ms = {key: statistics.mean(v) for key, v in samples.items()}
        row = {"shape": [bh, t, d], "dO": do_kind, "masked_keys": (2 * t) // 5} | ms
        row |= {"dq_alone_ms": ms["no_dkv_ms"] - ms["prepass_only_ms"],
                "dkv_alone_ms": ms["no_dq_ms"] - ms["prepass_only_ms"]}  # fmt: skip
        # the host's side of one call of the C entry point (map encoding,
        # launches), 20 calls queued behind a synchronise, on the host clock
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            call(entries["as_is"])
        row["host_ms_per_call"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse, do, grads, workspace
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
