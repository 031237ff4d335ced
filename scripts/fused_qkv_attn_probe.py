#!/usr/bin/env python3
"""Where the time of the port's two ``fused_qkv_mha`` kernels goes.

Builds each kernel's source as it is and with one part taken out, then
times each build on one NVIDIA GPU beside one call of
``F.scaled_dot_product_attention`` (bf16) on the same input:

* the one-pass kernel (``stamp_tpu_torch/ops/csrc/fused_qkv_attn.cu``, N <=
  272) at UNI2's shape ([64, 265, 3·24·64]) and Virchow's ([8, 257,
  3·16·80]):
  * ``as_is``: the kernel unchanged;
  * ``no_exp``: the exponent's FMA without the ex2 (the special-function
    unit's share);
  * ``no_stores``: the output is never stored, so the compiler drops all
    the arithmetic: what is left is staging K and V, loading q and the
    ldmatrix reads (the memory side);
* the two-pass kernel (``fused_qkv_long.cu``, N > 272) at CONCH1.5's shape
  ([64, 785, 3·16·64]) and CONCH's ([64, 785, 3·12·64]):
  * ``as_is``, ``no_exp`` (no ex2 in either pass) and ``no_stores`` as
    above (``no_stores`` leaves the TMA ring, the barriers and the turns);
  * ``no_exp1``: no ex2 in pass 1 (the statistics) only;
  * ``no_turns``: the consumer warpgroups issue their products without
    taking turns;
  * ``no_loads``: the producer arms each stage without loading it (the
    consumers compute on stale tiles): the share of feeding K and V;
  * ``two_warpgroups``: two consumer warpgroups (128 queries an item) instead
    of three, with the register split of two (232 a consumer, 40 for the
    producer);
  * ``pass1_only``, ``pass2_only``: the other pass cut to one key tile;
  * ``no_pv``: pass 2 without its P·V products;
  * ``pv_k_major``: P·V reading V as a K-major operand (the same bytes, a
    wrong layout): what the transposed V operand costs;
  * ``normalize_after_pv``: p = 2^(s·c − m·c) cast to bf16 unnormalized and
    O scaled by 1/l after P·V, the order the kernel must not keep.  Its
    result is right up to rounding, so this build is also held, beside the
    kernel as it is, to two plain versions: the JAX package's order (p
    normalized in f32, then cast: ``fused_qkv_mha_reference``) and this
    one.  Each of the two prints its max|Δ|/max|ref|, mean|Δ|/mean|ref| and
    the share of outputs equal to the plain version's: whether the error
    tells the two orders apart.

The three-sweep variant of earlier versions of this script is gone with the
three-sweep kernel: the two-pass kernel replaced it for N > 272.

The other ablated builds compute wrong results; only their times mean
anything.
Each time is the mean of two medians of 20 samples of 10 back-to-back calls
(CUDA events; every build timed twice, in turns), beside SDPA.  Run from
the repository root on a machine with a CUDA card and ``nvcc``:

    python3 scripts/fused_qkv_attn_probe.py

It prints the card's name and power limit, then one JSON line per shape
and, for the two-pass kernel, one line of errors per shape.
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
from stamp_tpu_torch.ops.flash_attention import fused_qkv_mha_reference  # noqa: E402

OUT = REPO / "build" / "fused_qkv_attn_probe"
NO_STORES = [("        if (row < n)\n", "        if (row < -1)\n")]
PV_WGMMA = "wgmma_bf16_rs<1>(acc, frag[j], smem_desc_sw128_mn(stage(r) + C::kKBytes + 2048 * j), 1);"

# kernel → its source, its C entry, its shapes (B, N, heads, d, model) and
# its variants: variant → [(text in the source, its replacement)]
KERNELS = {
    "one_pass": dict(
        source="fused_qkv_attn.cu",
        entry="stamp_fused_qkv_attn",
        shapes=((64, 265, 24, 64, "UNI2"), (8, 257, 16, 80, "Virchow")),
        variants={
            "as_is": [],
            "no_exp": [
                ("s[j][e] = exp2f(fmaf(s[j][e], c, -mc[e >> 1]));", "s[j][e] = fmaf(s[j][e], c, -mc[e >> 1]);")
            ],
            "no_stores": NO_STORES,
        },
    ),
    "two_pass": dict(
        source="fused_qkv_long.cu",
        entry="stamp_fused_qkv_long",
        shapes=((64, 785, 16, 64, "CONCH1.5"), (64, 785, 12, 64, "CONCH")),
        variants={
            "as_is": [],
            # every 2^x of the source (hopper.cuh's exp2_approx) becomes x
            "no_exp": [("using namespace sm90;\n", "using namespace sm90;\n#define exp2_approx(x) (x)\n")],
            "no_exp1": [
                (
                    "lt[(i >> 1) & 1][(i >> 2) & 1] += exp2_approx(fmaf(s1[i], c, mc[(i >> 1) & 1]));",
                    "lt[(i >> 1) & 1][(i >> 2) & 1] += fmaf(s1[i], c, mc[(i >> 1) & 1]);",
                )
            ],
            "no_turns": [
                ("auto turn_begin = [&]() { named_barrier_sync(1 + wg, 256); };", "auto turn_begin = [&]() {};"),
                (
                    "auto turn_end = [&]() { named_barrier_arrive(1 + (wg + 1) % kConsumers, 256); };",
                    "auto turn_end = [&]() {};",
                ),
                ("if (wg == kConsumers - 1) named_barrier_arrive(1, 256);", ""),
            ],
            "no_stores": NO_STORES,
            "no_loads": [
                ("mbar_expect_tx(&full[s], C::kKeys1 / kTile * C::kKBytes);", "mbar_arrive(&full[s]); continue;"),
                ("mbar_expect_tx(&full[s], 2 * C::kKBytes);", "mbar_arrive(&full[s]); continue;"),
            ],
            "two_warpgroups": [
                ("constexpr int kConsumers = 3;", "constexpr int kConsumers = 2;"),
                ("constexpr int kConsumerRegs = 160, kProducerRegs = 24;",
                 "constexpr int kConsumerRegs = 232, kProducerRegs = 40;"),
            ],  # fmt: skip
            "pass1_only": [("const int tiles = (n + kTile - 1) / kTile; ", "const int tiles = 1; ")],
            "pass2_only": [("const int tiles1 = (n + C::kKeys1 - 1) / C::kKeys1; ", "const int tiles1 = 1; ")],
            "no_pv": [(PV_WGMMA, ";")],
            "pv_k_major": [(PV_WGMMA, "wgmma_bf16_rs<0>(acc, frag[j], smem_desc_sw128(stage(r) + C::kKBytes) + 2 * j, 1);")],
            "normalize_after_pv": [
                *((f"exp2_approx(fmaf(s2[{e}], c, mcs[i & 1])) * inv[i & 1]", f"exp2_approx(fmaf(s2[{e}], c, mcs[i & 1]))")
                  for e in (0, 1)),
                ("pack_bf16(acc[4 * (4 * q + i) + 2 * h], acc[4 * (4 * q + i) + 2 * h + 1]);",
                 "pack_bf16(acc[4 * (4 * q + i) + 2 * h] * inv[h], acc[4 * (4 * q + i) + 2 * h + 1] * inv[h]);"),
                ("pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);",
                 "pack_bf16(acc[4 * j + 2 * h] * inv[h], acc[4 * j + 2 * h + 1] * inv[h]);"),
            ],  # fmt: skip
        },
        accuracy=("as_is", "normalize_after_pv"),
    ),
}


def normalized_after_pv(qkv, h: int):
    """Plain version in the order of ``normalize_after_pv``: exp(s − m) cast
    to bf16, P·V summed in f32, then divided by l and cast."""
    import torch

    b, n, three_dim = qkv.shape
    d = three_dim // 3 // h
    q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4).float()
    s = torch.matmul(q, k.transpose(-1, -2)) * d**-0.5
    e = s.sub_(s.amax(dim=-1, keepdim=True)).exp_()
    l = e.sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(qkv.dtype).float(), v).div_(l).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, n, h * d)


def errors(got, want) -> dict:
    delta = (got.float() - want.float()).abs()
    return {"rel_err": (delta.max() / want.float().abs().max()).item(),
            "mean_rel_err": (delta.mean() / want.float().abs().mean()).item(),
            "equal_share": (got == want).float().mean().item()}  # fmt: skip


def build(kernel: str, variant: str) -> Path:
    """Compile the kernel's source with the variant's ablation into a library
    (its headers from ``csrc/``)."""
    source = KERNELS[kernel]["source"]
    d = OUT / kernel / variant
    d.mkdir(parents=True, exist_ok=True)
    text = (_build.CSRC_DIR / source).read_text()
    for old, new in KERNELS[kernel]["variants"][variant]:
        if old not in text:
            raise SystemExit(f"{kernel}/{variant}: {source} no longer holds {old!r}")
        text = text.replace(old, new)
    (d / source).write_text(text)
    lib = d / f"{kernel}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(_build.CSRC_DIR), "-o", str(lib), str(d / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"{kernel}/{variant}: nvcc failed:\n{proc.stderr}")
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
    jobs = [(k, v) for k, spec in KERNELS.items() for v in spec["variants"]]
    with ThreadPoolExecutor(len(jobs)) as pool:  # one nvcc per build, all at once
        paths = dict(zip(jobs, pool.map(lambda job: build(*job), jobs)))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    for kernel, spec in KERNELS.items():
        libs = {}
        for variant in spec["variants"]:
            fn = getattr(ctypes.CDLL(str(paths[kernel, variant])), spec["entry"])
            fn.argtypes, fn.restype = _build._SIGNATURES[spec["entry"]], ctypes.c_int
            libs[variant] = fn
        for b, n, h, d, name in spec["shapes"]:
            qkv = torch.randn(b, n, 3 * h * d, device=dev, generator=gen).bfloat16()
            out = torch.empty(b, n, h * d, device=dev, dtype=torch.bfloat16)

            def sdpa(qkv=qkv, b=b, n=n, h=h, d=d):
                q, k, v = qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
                return F.scaled_dot_product_attention(q, k, v).transpose(1, 2).reshape(b, n, h * d)

            calls = {f"{v}_ms": (lambda fn=fn: fn(qkv.data_ptr(), out.data_ptr(), b, n, h, d, 0, stream))
                     for v, fn in libs.items()} | {"sdpa_bf16_ms": sdpa}  # fmt: skip
            for key, call in calls.items():
                if key != "sdpa_bf16_ms" and call() != 0:
                    raise SystemExit(f"{kernel} {key}: launch failed")
            samples: dict[str, list[float]] = {}
            for key in [*calls, *reversed(calls)]:  # every build twice, in turns, on one card
                samples.setdefault(key, []).append(median_ms(calls[key]))
            row = {"kernel": kernel, "shape": [b, n, 3 * h * d], "head_dim": d, "model": name}
            print(json.dumps(row | {k: statistics.mean(v) for k, v in samples.items()}), flush=True)
            if spec.get("accuracy"):
                plain = {"normalize_then_cast": fused_qkv_mha_reference(qkv, h),
                         "normalize_after_pv": normalized_after_pv(qkv, h)}  # fmt: skip
                acc = {}
                for variant in spec["accuracy"]:
                    got = torch.empty_like(out)
                    if libs[variant](qkv.data_ptr(), got.data_ptr(), b, n, h, d, 0, stream) != 0:
                        raise SystemExit(f"{kernel} {variant}: launch failed")
                    torch.cuda.synchronize()
                    acc[variant] = {order: errors(got, want) for order, want in plain.items()}
                print(json.dumps(row | {"errors_against_plain": acc}), flush=True)
                del plain


if __name__ == "__main__":
    main()
