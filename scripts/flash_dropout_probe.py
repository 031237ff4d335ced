#!/usr/bin/env python3
"""Attention dropout on the flash path (rows 4–5 with keep bits) on one NVIDIA GPU.

At the whole-slide buckets of the ``wholeslide`` traffic (T = 4,097,
8,193 and 16,385 tokens, [8, T, 64], the last 40% of keys masked as bucket
padding) it reports, as JSON lines:

* ``--budget``: the time of the draws (``torch.rand`` at [8, T, T], as the
  einsum path draws them), of a plain pack of them into keep bits (torch
  ops), and of one einsum attention layer with dropout, forward and
  backward (``ops.attention.multi_head_attention``, the draws included);
* ``--check``: the ptxas report of the dropout kernels (registers,
  spills), the pack kernel bitwise against the plain pack at ragged K, and
  rows 4–5 with keep against their plain versions in float64 and in
  float32 (TF32 off), at small shapes and at [8, 4097, 64];
* ``--time``: the flash layer with dropout (the draws, the pack, the
  forward, the backward) beside the einsum layer, in turns, and each part
  alone;
* ``--against <tree>``: rows 4–5 without keep and rows 6–8 in another tree
  of the repository (``git archive <commit> | tar -x -C <tree>``) and in
  this one, on the same seeded inputs, compared bitwise (the other tree
  runs in a subprocess with its own build).

Each time is the median of 10 samples of one call between two CUDA events
with a sync around it.  Run from the repository root:

    python3 scripts/flash_dropout_probe.py --budget --check --time [--against build/parent]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
LENGTHS = (4_097, 8_193, 16_385)
HEADS, WIDTH, RATE = 8, 64, 0.25


def _ms(fn, samples: int = 10) -> float:
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _inputs(t: int, seed: int = 0, d: int = WIDTH, bh: int = HEADS, valid_share: float = 0.6):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(bh, t, d, device="cuda", generator=g) for _ in range(3))
    n_valid = max(1, int(round(valid_share * t)))
    key_mask = (torch.arange(t, device="cuda") < n_valid).expand(bh, t).contiguous()
    return q, k, v, key_mask, g


def budget() -> None:
    from stamp_tpu_torch.ops import attention as ops
    from stamp_tpu_torch.ops import flash_attention as attn

    for t in LENGTHS:
        q, k, v, key_mask, g = _inputs(t)
        row = {"T": t}
        draws = torch.rand((HEADS, t, t), generator=g, device="cuda")
        row["rand_ms"] = _ms(lambda: torch.rand((HEADS, t, t), generator=g, device="cuda"))  # noqa: B023
        row["plain_pack_ms"] = _ms(lambda: attn._pack_keep_reference(draws, RATE, key_mask), samples=3)  # noqa: B023
        del draws
        torch.cuda.empty_cache()
        leaves = [x[None].clone().requires_grad_() for x in (q, k, v)]
        mask = key_mask[:1]

        def einsum_layer():
            out = ops.multi_head_attention(*leaves, key_mask=mask, dropout_rate=RATE, generator=g)
            out.backward(torch.ones_like(out))

        einsum_layer()
        row["einsum_layer_ms"] = _ms(einsum_layer, samples=3)
        print(json.dumps({"budget": row}), flush=True)
        del leaves
        torch.cuda.empty_cache()


def _ptxas_report() -> list[dict]:
    from stamp_tpu_torch.ops import _build

    log = _build.library_path().with_suffix(".log")
    if not log.is_file():
        return []
    rows, name = [], None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            continue
        if name and ("flash" in name or "keep" in name):
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                rows.append({"kernel": name, "spill_stores": int(spill.group(1)), "spill_loads": int(spill.group(2))})
            if regs and rows and rows[-1]["kernel"] == name:
                rows[-1]["registers"] = int(regs.group(1))
    return rows


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.double() - want.double()).abs().max() / want.double().abs().max().clamp_min(1e-300))


def _case(bh: int, t: int, d: int, seed: int, valid_share: float = 0.6) -> dict:
    """Rows 4–5 with keep against their plain versions on one case."""
    from stamp_tpu_torch.ops import flash_attention as attn

    q, k, v, key_mask, g = _inputs(t, seed, d, bh, valid_share)
    draws = torch.rand((bh, t, t), generator=g, device="cuda")
    keep = attn.AttentionDropout(draws.clone(), RATE)
    out, lse = attn._flash_forward(q, k, v, key_mask, keep=keep)
    bits_plain = attn._pack_keep_reference(draws, RATE, key_mask)
    mask = attn._unpack_keep(bits_plain, t)
    do = torch.randn(bh, t, d, device="cuda", generator=g) * key_mask[..., None]
    grads = attn._flash_backward(q, k, v, key_mask, out, lse, do, keep=keep)
    row = {"bh": bh, "T": t, "d": d, "valid": valid_share, "pack_bitwise": bool(torch.equal(keep.bits, bits_plain))}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        args = [x.to(dtype) for x in (q, k, v)]
        want_out, want_lse = attn._flash_forward_reference(*args, key_mask, None, mask, RATE)
        want = attn._flash_backward_reference(*args, key_mask, want_out, want_lse, do.to(dtype), None, mask, RATE)
        row[name] = {"out": _rel(out, want_out), "lse": _rel(lse, want_lse),
                     **{n: _rel(a, b) for n, a, b in zip(("dq", "dk", "dv"), grads, want)}}  # fmt: skip
    row["masked_dk_dv_zero"] = bool(not grads[1][~key_mask].any() and not grads[2][~key_mask].any())
    return row


def check() -> None:
    from stamp_tpu_torch.ops import _build
    from stamp_tpu_torch.ops import flash_attention as attn

    _build.load_library()
    for row in _ptxas_report():
        print(json.dumps({"ptxas": row}), flush=True)
    for tq, tk in ((5, 33), (70, 1000), (129, 4097)):  # the pack at ragged K, holes in the mask
        g = torch.Generator(device="cuda").manual_seed(tq)
        draws = torch.rand((3, tq, tk), generator=g, device="cuda")
        key_mask = torch.rand((3, tk), generator=g, device="cuda") < 0.7
        key_mask[1] = False
        got = attn._pack_keep(draws, RATE, key_mask)
        print(json.dumps({"pack": {"tq": tq, "tk": tk, "bitwise": bool(torch.equal(got, attn._pack_keep_reference(
            draws, RATE, key_mask)))}}), flush=True)  # fmt: skip
    for case in ((3, 300, 64, 1), (2, 130, 32, 2), (2, 77, 64, 3, 0.0), (8, 4097, 64, 4)):
        print(json.dumps({"check": _case(*case)}), flush=True)


def time_layers() -> None:
    from stamp_tpu_torch.ops import attention as ops
    from stamp_tpu_torch.ops import flash_attention as attn

    for t in LENGTHS:
        q, k, v, key_mask, g = _inputs(t)
        do = torch.randn(HEADS, t, WIDTH, device="cuda", generator=g) * key_mask[..., None]
        row = {"T": t}

        def parts():
            draws = torch.rand((HEADS, t, t), generator=g, device="cuda")  # noqa: B023
            return attn.AttentionDropout(draws, RATE)

        keep = parts()
        out, lse = attn._flash_forward(q, k, v, key_mask, keep=keep)
        row["pack_ms"] = _ms(lambda: attn._pack_keep(torch.rand((HEADS, t, t), generator=g, device="cuda"), RATE,  # noqa: B023
                                                     key_mask)) - _ms(lambda: torch.rand((HEADS, t, t), generator=g,  # noqa: B023
                                                                                         device="cuda"))  # fmt: skip
        row["fwd_ms"] = _ms(lambda: attn._launch_flash_drop(q, k, v, key_mask, keep.bits, RATE))  # noqa: B023
        row["bwd_ms"] = _ms(lambda: attn._flash_backward(q, k, v, key_mask, out, lse, do, keep=keep))  # noqa: B023
        row["bwd_last_layer_ms"] = _ms(lambda: attn._flash_backward(q, k, v, key_mask, out, lse,  # noqa: B023
                                                                    torch.where(torch.arange(t, device="cuda")[None, :, None] == 0, do, 0.0),  # noqa: B023
                                                                    keep=keep))  # fmt: skip
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]

        def flash_layer():
            kp = parts()
            o = attn.flash_mha(*leaves, key_mask, keep=kp)  # noqa: B023
            o.backward(do)  # noqa: B023

        def einsum_layer():
            lv = [x[None] for x in leaves]  # noqa: B023
            o = ops.multi_head_attention(*lv, key_mask=key_mask[:1], dropout_rate=RATE, generator=g)  # noqa: B023
            o.backward(do[None])  # noqa: B023

        flash_layer()
        einsum_layer()
        turns = {"flash": [], "einsum": []}
        for _ in range(3):
            turns["flash"].append(_ms(flash_layer, samples=3))
            turns["einsum"].append(_ms(einsum_layer, samples=1))
            turns["einsum"].append(_ms(einsum_layer, samples=1))
            turns["flash"].append(_ms(flash_layer, samples=3))
        row["flash_layer_ms"] = statistics.median(turns["flash"])
        row["einsum_layer_ms"] = statistics.median(turns["einsum"])
        torch.cuda.reset_peak_memory_stats()
        flash_layer()
        row["flash_layer_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        print(json.dumps({"time": row}), flush=True)
        del leaves, keep, out, lse, do
        torch.cuda.empty_cache()


# rows 4–8 without keep bits in one tree (with its own build), on seeded inputs, outputs saved
_DUMP = r'''
import sys, torch
sys.path.insert(0, sys.argv[1])
from stamp_tpu_torch.ops import flash_attention as attn
torch.backends.cuda.matmul.allow_tf32 = False
out = {}
for t, d in ((300, 64), (4097, 64), (517, 32), (200, 128)):
    g = torch.Generator(device="cuda").manual_seed(t + d)
    q, k, v = (torch.randn(8, t, d, device="cuda", generator=g) for _ in range(3))
    key_mask = (torch.arange(t, device="cuda") < (3 * t) // 5).expand(8, t).contiguous()
    do = torch.randn(8, t, d, device="cuda", generator=g) * key_mask[..., None]
    idx = torch.arange(t, device="cuda")
    coords = (torch.stack([idx % 64, idx // 64], -1).float() * 256.0).expand(8, t, 2).contiguous()
    ds = torch.rand(8, device="cuda", generator=g) / 5000.0
    o, lse = attn._flash_forward(q, k, v, key_mask)
    out[f"row4/{t}/{d}"] = o
    out[f"row4_lse/{t}/{d}"] = lse
    for n, x in zip("qkv", attn._flash_backward(q, k, v, key_mask, o, lse, do)):
        out[f"row5_d{n}/{t}/{d}"] = x
    a = attn._flash_alibi_forward(q, k, v, coords, coords, ds, key_mask)
    for n, x in zip(("out", "sm", "dacc", "lse"), a):
        out[f"row6_{n}/{t}/{d}"] = x
    for n, x in zip(("dq", "dk", "dv", "dscale"), attn._flash_alibi_backward(q, k, v, coords, coords, ds, key_mask, a[1], a[2], a[3], do)):
        out[f"row7_{n}/{t}/{d}"] = x
    out[f"row8/{t}/{d}"] = attn._dist_weighted_sum(coords, coords, do, None, key_mask)
torch.save({k: v.cpu() for k, v in out.items()}, sys.argv[2])
'''


def against(tree: str) -> None:
    dumps = ROOT / "build" / "flash_dropout_probe"
    dumps.mkdir(parents=True, exist_ok=True)
    results = {}
    for name, root in (("other", Path(tree).resolve()), ("this", ROOT)):
        path = dumps / f"{name}.pt"
        subprocess.run([sys.executable, "-c", _DUMP, str(root), str(path)], check=True, cwd=root)
        results[name] = torch.load(path)
    other, this = results["other"], results["this"]
    differ = sorted(k for k in this if not torch.equal(this[k], other[k]))
    print(json.dumps({"against": {"tree": tree, "compared": len(this), "bitwise_equal": len(this) - len(differ),
                                 "differ": differ}}), flush=True)  # fmt: skip


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--budget", action="store_true")
    parser.add_argument("--check", action="store_true")
    parser.add_argument("--time", action="store_true")
    parser.add_argument("--against")
    args = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()  # fmt: skip
    print(card, flush=True)
    if args.budget:
        budget()
    if args.check:
        check()
    if args.time:
        time_layers()
    if args.against:
        against(args.against)


if __name__ == "__main__":
    main()
