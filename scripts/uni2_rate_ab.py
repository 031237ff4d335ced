#!/usr/bin/env python3
"""UNI2's bf16 extraction rate on one NVIDIA GPU, another tree of the
repository against this one, in alternating pairs.

Each tree runs in a worker process of its own that builds its kernels and
loads the ``uni2`` extractor once (random weights, ``STAMP_RANDOM_WEIGHTS=1``)
and then, each time it is asked, times ``chip_smoke.py`` phase 5's
steady-state forward at batch 64: the median of 10 samples of one synced
call.  The two workers share the card but never run at once; the pairs
alternate their order (other, this), (this, other), ... so that a drift of
the card's clock falls on both alike.  Run from the repository root, with
the other tree unpacked from git (``git archive <commit> | tar -x -C
build/other``):

    python3 scripts/uni2_rate_ab.py build/other [pairs] [--phase4]

With ``--phase4`` each sample is instead ``chip_smoke.py`` phase 4 in a
fresh process of its tree (``preprocess`` of 144 UNI2 tiles through the
CLI; tiles/s by the stage timer's device forward, first calls included),
the trees again in alternating pairs.

It prints one line per sample (the tree, its ms a batch and tiles/s), then
a summary: each tree's mean, least and largest rate, the difference of the
means, and whether it exceeds both trees' spreads (``resolved``).  Where a
tree's ``fused_qkv_mha`` is a ``shapecheck`` wrapper, its worker also
prints the host's time to issue one call through the wrapper and through
the function it wraps (UNI2's [64, 265, 4608] on the card, 200 calls
without a sync, five turns each), and both calls' times by phase 3's
timer (a sync around each call, the two in turns, 60 samples each).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

WORKER = r"""
import json, os, statistics, sys, time
sys.path.insert(0, os.getcwd())
os.environ["STAMP_RANDOM_WEIGHTS"] = "1"
import numpy as np, torch
import chip_smoke as cs
cs.phase_build()
from stamp_tpu_torch.ops import flash_attention as fa
from stamp_tpu_torch.preprocessing.extractor.zoo import resolve_extractor
torch.backends.cuda.matmul.allow_tf32 = False
ext = resolve_extractor("uni2", torch.device("cuda:0"))
tiles = np.random.default_rng(1).integers(60, 200, (64, 224, 224, 3), dtype=np.uint8)
cs._time_ms(lambda: ext.forward(tiles), 3)
host = {}
raw = getattr(fa.fused_qkv_mha, "__wrapped__", None)
if raw is not None:
    qkv = torch.randn(64, 265, 4608, device="cuda:0").to(torch.bfloat16)
    turns = {"wrapper": [], "wrapped": []}
    for _ in range(5):
        for name, fn in (("wrapper", fa.fused_qkv_mha), ("wrapped", raw)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                fn(qkv, 24)
            turns[name].append((time.perf_counter() - t0) / 200 * 1e6)
            torch.cuda.synchronize()
    host = {f"{k}_us": statistics.median(v) for k, v in turns.items()}
    synced = cs._compare_timed(lambda: fa.fused_qkv_mha(qkv, 24), lambda: raw(qkv, 24), iters=20)
    host |= {"synced_wrapper_ms": synced["kernel"], "synced_wrapped_ms": synced["plain"]}
print("READY", json.dumps(host), flush=True)
for line in sys.stdin:
    ms = statistics.median(cs._time_ms(lambda: ext.forward(tiles), 10))
    print("AB", json.dumps({"ms": ms, "tiles_per_s": 64 / ms * 1e3}), flush=True)
"""


PHASE4 = r"""
import json, os, shutil, sys
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
shutil.rmtree(cs.WORK, ignore_errors=True)
cs.phase_build()
row = cs.phase_main_path("card")
shutil.rmtree(cs.WORK, ignore_errors=True)
print("AB", json.dumps({"ms": row["forward_s"] * 1e3, "tiles_per_s": row["forward_tiles_per_s"]}))
"""


def _phase4(tree: Path, name: str) -> dict:
    out = subprocess.run([sys.executable, "-c", PHASE4], cwd=tree, capture_output=True, text=True)
    line = next((x for x in out.stdout.splitlines() if x.startswith("AB ")), None)
    if line is None:
        raise SystemExit(f"{name}: {out.stdout[-2000:]}{out.stderr[-3000:]}")
    return json.loads(line[3:])


def _read(proc: subprocess.Popen, tag: str, name: str) -> str:
    for line in proc.stdout:
        if line.startswith(tag + " "):
            return line[len(tag) + 1 :].strip()
    raise SystemExit(f"{name}: the worker ended before {tag} (rc {proc.wait()})")


def main() -> None:
    args = [a for a in sys.argv[1:] if a != "--phase4"]
    phase4 = len(args) < len(sys.argv) - 1
    if len(args) not in (1, 2):
        raise SystemExit(__doc__)
    pairs = int(args[1]) if len(args) == 2 else 12
    trees = {"other": Path(args[0]).resolve(), "this": REPO}
    workers = {}
    try:
        for name, tree in trees.items() if not phase4 else ():  # one at a time: each builds its kernels
            proc = subprocess.Popen([sys.executable, "-c", WORKER], cwd=tree, text=True,
                                    stdin=subprocess.PIPE, stdout=subprocess.PIPE)  # fmt: skip
            workers[name] = proc
            print(f"[uni2 rate] {name} {tree} ready, host {_read(proc, 'READY', name)}", flush=True)
        rates: dict[str, list[float]] = {name: [] for name in trees}
        for i in range(pairs):
            for name in ("other", "this") if i % 2 == 0 else ("this", "other"):
                if phase4:
                    row = _phase4(trees[name], name)
                else:
                    proc = workers[name]
                    proc.stdin.write("go\n")
                    proc.stdin.flush()
                    row = json.loads(_read(proc, "AB", name))
                rates[name].append(row["tiles_per_s"])
                print(f"[uni2 rate] pair {i} {name} {json.dumps(row)}", flush=True)
    finally:
        for proc in workers.values():
            if proc.stdin:
                proc.stdin.close()
            proc.wait(timeout=120)
    means = {name: statistics.mean(r) for name, r in rates.items()}
    spreads = {name: (max(r) - min(r)) / means[name] for name, r in rates.items()}
    diff = (means["this"] - means["other"]) / means["other"]
    summary = dict(pairs=pairs, phase4=phase4, mean_tiles_per_s=means, min=({n: min(r) for n, r in rates.items()}),
                   max=({n: max(r) for n, r in rates.items()}), spread=spreads, diff=diff,
                   resolved=abs(diff) > max(spreads.values()))  # fmt: skip
    print(f"[uni2 rate] summary {json.dumps(summary)}", flush=True)


if __name__ == "__main__":
    main()
