#!/usr/bin/env python3
"""Times of the spatial-ALiBi training path's kernels at 20× whole-slide lengths.

On one NVIDIA GPU, at the buckets of the benchmark's ``wholeslide20x``
traffic (T = 16,385, 32,769, 65,537 tokens, the bucket padding masked
behind a slide of 12,000, 24,000 or 48,000 tiles and its CLS), it times:

* the distance statistic, ``pairwise_distance_sums`` (one kernel,
  ``csrc/alibi_stats.cu``) and its plain version (row blocks of 512, TF32
  off) on [1, T, 2] coordinates with the key mask;
* row 6, ``_flash_alibi_forward`` (D·V, then the flash forward with the
  ALiBi epilogue), at [8, T, 64];
* row 7, ``_flash_alibi_backward`` (the flash backward and the bias
  branch), with dO dense on the slide's rows and with the last layer's dO
  (the CLS row alone);
* row 8, ``_dist_weighted_sum`` as the backward calls it (the key mask as
  its a-mask, dense dO).

Each time is the median of 10 samples of one call between two CUDA events
with a sync around it (the statistic also back to back, 5 calls a
sample).  Run from the repository root:

    python3 scripts/alibi_rows_probe.py

It prints the card's name and power limit, then one JSON line per length.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from stamp_tpu_torch.ops import attention as ops  # noqa: E402
from stamp_tpu_torch.ops import flash_attention as attn  # noqa: E402

LENGTHS = ((16_385, 12_001), (32_769, 24_001), (65_537, 48_001))  # (T, valid tokens)


def _ms(fn, samples: int = 10, per_sample: int = 1) -> float:
    times = []
    for _ in range(samples):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(per_sample):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / per_sample)
    return statistics.median(times)


def _coords(t: int, n: int) -> torch.Tensor:
    idx = torch.arange(t - 1, device="cuda")
    grid = torch.stack([idx % 128, idx // 128], dim=-1).float() * 224.0
    coords = torch.cat([torch.zeros(1, 2, device="cuda"), grid])
    coords[n:] = 0.0
    return coords


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                          capture_output=True, text=True).stdout.strip()  # fmt: skip
    print(card, flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    for t, n in LENGTHS:
        coords = _coords(t, n)
        mask = (torch.arange(t, device="cuda") < n)[None]
        c1 = coords[None].contiguous()
        row = {"T": t, "valid": n}
        stat = lambda: ops.pairwise_distance_sums(c1, mask=mask)  # noqa: E731
        stat()
        row["pair_sums_ms"] = _ms(stat)
        row["pair_sums_back_to_back_ms"] = _ms(stat, per_sample=5)
        row["pair_sums_plain_ms"] = _ms(lambda: ops.pairwise_distance_sums_reference(c1, mask=mask), samples=3)
        h, d = 8, 64
        q, k, v = (torch.randn(h, t, d, device="cuda", generator=g) for _ in range(3))
        cq = coords.expand(h, t, 2).contiguous()
        key_mask = mask.expand(h, t).contiguous()
        scale = torch.rand(h, device="cuda", generator=g) / 20_000.0
        fwd = lambda: attn._flash_alibi_forward(q, k, v, cq, cq, scale, key_mask, d**-0.5)  # noqa: E731
        out, out_sm, dacc, lse = fwd()
        row["row6_ms"] = _ms(fwd)
        dense = torch.randn(h, t, d, device="cuda", generator=g) * key_mask[..., None]
        last = torch.zeros_like(dense)
        last[:, 0] = dense[:, 0]
        saved = (q, k, v, cq, cq, scale, key_mask, out_sm, dacc, lse)
        for name, do in (("row7_ms", dense), ("row7_last_layer_ms", last)):
            row[name] = _ms(lambda: attn._flash_alibi_backward(*saved, do, d**-0.5))  # noqa: B023
        scaled = dense * scale[:, None, None]
        row["row8_ms"] = _ms(lambda: attn._dist_weighted_sum(cq, cq, scaled, None, key_mask))
        print(json.dumps(row), flush=True)
        del q, k, v, out, out_sm, dacc, lse, dense, last, saved, scaled
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
