#!/usr/bin/env python3
"""Leaf by leaf, what the ALiBi training cell's ``change_gap`` reads.

On one NVIDIA GPU, for each seed it runs the cell
``mil_vit_alibi.train.wholeslide20x`` as ``benchmark/calibrate.py`` does (a
short window, then the check), and keeps what the check compares: each
parameter's change after the compared steps on the program and in the
float32 reference, and both sides' gradient of the first step (the
program's from AdamW's first moment).  Per leaf it prints, over the elements
the check keeps (reference gradient at or above ``GRAD_FLOOR`` of the median
leaf's RMS):

* ``gap``: the leaf's share of ``change_gap`` (|‖Δ program‖ − ‖Δ reference‖|
  over the larger of ‖Δ reference‖ and the median leaf's);
* ``change_rel``: ‖Δ program − Δ reference‖ / ‖Δ reference‖, element by element;
* ``grad1_rel``: the same for the first step's gradients, all elements;
* ``sign_flips``: kept elements whose first gradients differ in sign;
* the three elements whose changes differ most, with both gradients in
  units of the floor.

Then ``change_gap`` with each leaf family left out, and with the floor
raised to each of ``--eps-multiples`` × AdamW's ε (the driver's
``EPS_FLOOR`` is 100 ε).  Run from the repository root:

    python3 scripts/alibi_change_gap_probe.py --seeds 3100000002,3100000009 [--out file.jsonl]
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORKLOAD = "mil_vit_alibi.train.wholeslide20x"


def _leaf_rows(change, ref_change, g1, ref_g1, floor: float) -> dict[str, dict]:
    import torch

    kept = {k: v.abs() >= floor for k, v in ref_g1.items()}
    ref_norm = {k: float((ref_change[k] * kept[k]).norm()) for k in kept if bool(kept[k].any())}
    median = statistics.median(ref_norm.values())
    rows = {}
    for k, want in ref_norm.items():
        mask = kept[k]
        got_d, want_d = change[k].float() * mask, ref_change[k].float() * mask
        got = float(got_d.norm())
        diff = (got_d - want_d).abs().flatten()
        top = torch.topk(diff, min(3, diff.numel())).indices.tolist()
        flat = {name: t.flatten() for name, t in (("g", g1[k]), ("r", ref_g1[k]), ("dp", got_d), ("dr", want_d))}
        rows[k] = dict(
            numel=mask.numel(), kept=int(mask.sum()), ref_norm=want, got_norm=got,
            gap=abs(got - want) / max(want, median),
            change_rel=float((got_d - want_d).norm()) / max(want, 1e-30),
            grad1_rel=float((g1[k] - ref_g1[k]).norm()) / max(float(ref_g1[k].norm()), 1e-30),
            sign_flips=int(((torch.sign(g1[k]) != torch.sign(ref_g1[k])) & mask).sum()),
            worst=[dict(index=i, grad1_over_floor=float(flat["g"][i]) / floor,
                        ref_grad1_over_floor=float(flat["r"][i]) / floor,
                        change=float(flat["dp"][i]), ref_change=float(flat["dr"][i])) for i in top],
        )  # fmt: skip
    return rows


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--out")
    parser.add_argument("--device", default="cuda", help="cuda, or cpu for a dry run of a small cell")
    parser.add_argument("--workload", default=WORKLOAD)
    parser.add_argument("--eps-multiples", default="0,1,10,100", help="comma-separated")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "benchmark"))
    import run

    run._environment()
    import torch

    from benchmark.drivers import train
    from benchmark.harness import spec
    from benchmark.harness.runner import run_cell

    cell = spec.cell(args.workload)
    train_alibi = spec.driver(cell)  # the module the runner uses
    seen: dict = {}
    moment, check, reference_train = train_alibi.Session._moment, train_alibi.Session.check, train_alibi.reference.train

    def first_moment(self, p, key="exp_avg"):  # the first step's gradient, kept whole
        out = moment(self, p, key)
        if key == "exp_avg" and self.count == 1:
            name = next(n for n, q in self.params.items() if q is p)
            seen.setdefault("g1", {})[name] = out.detach().clone() / (1 - train.BETA1)
        return out

    def kept_check(self):
        seen["session"] = self
        return check(self)

    def kept_reference(*a, **kw):
        out = reference_train(*a, **kw)
        seen.setdefault("reference", []).append(out)
        return out

    train_alibi.Session._moment, train_alibi.Session.check = first_moment, kept_check
    train_alibi.reference.train = kept_reference
    device = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    if device.type == "cuda":
        print(subprocess_card(), flush=True)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        seen.clear()
        t0 = time.perf_counter()
        result = run_cell(cell, seed, args.seconds, False, device, t0)
        ref = seen["reference"][0]  # the compared steps, from the initial state
        ref_g1 = ref["grads"][0]
        floor = train.GRAD_FLOOR * statistics.median(float(v.pow(2).mean().sqrt()) for v in ref_g1.values())
        rows = _leaf_rows(seen["session"].change, ref["change"], seen["g1"], ref_g1, floor)
        by_eps = {}
        for multiple in (float(x) for x in args.eps_multiples.split(",")):
            raised = _leaf_rows(seen["session"].change, ref["change"], seen["g1"], ref_g1,
                                max(floor, multiple * train_alibi.ADAM_EPS))  # fmt: skip
            worst = max(raised, key=lambda k: raised[k]["gap"])
            by_eps[multiple] = dict(change_gap=raised[worst]["gap"], leaf=worst,
                                    kept=sum(r["kept"] for r in raised.values()))  # fmt: skip
        family = {k: re.sub(r"^block_\d+\.", "", k) for k in rows}  # a leaf's name in every block
        without = {}
        for name in sorted(set(family.values())):
            rest = {k: r for k, r in rows.items() if family[k] != name}
            median = statistics.median(r["ref_norm"] for r in rest.values())
            without[name] = max(abs(r["got_norm"] - r["ref_norm"]) / max(r["ref_norm"], median) for r in rest.values())
        line = dict(seed=seed, correct=result["correct"], checks=result["checks"], floor=floor,
                    leaves=dict(sorted(rows.items(), key=lambda kv: -kv[1]["gap"])), change_gap_without=without,
                    change_gap_by_eps=by_eps,
                    seconds=time.perf_counter() - t0)  # fmt: skip
        top = list(line["leaves"].items())[:4]
        print(json.dumps(dict(seed=seed, checks=result["checks"],
                              top={k: {f: r[f] for f in ("gap", "change_rel", "grad1_rel", "sign_flips", "kept",
                                                          "numel", "worst")} for k, r in top},
                              change_gap_without=dict(sorted(without.items(), key=lambda kv: kv[1])[:4]),
                              change_gap_by_eps=by_eps)),
              flush=True)  # fmt: skip
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        del result
        seen.clear()
        torch.cuda.empty_cache()
    if out:
        out.close()
    return 0


def subprocess_card() -> str:
    import subprocess

    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()  # fmt: skip


if __name__ == "__main__":
    sys.exit(main())
