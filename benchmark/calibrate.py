"""Readings of the numbers that decide ``correct``, over many seeds in one process.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 2] \
        [--control | --fault <name>] [--out <file.jsonl>]

For each seed it sets the cell up, runs a short window at the cell's own
load, and checks it as a run does, printing one JSON line of the numbers
compared.  ``--control`` puts the configuration's control in the program's
place (the precision below the one it states), ``--fault`` plants one of
the driver's faults; the limits in ``limits/<workload>.json`` are set from
these readings (``PERF.md`` gives them).  The benchmark's own runs never
run this.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control", action="store_true")
    parser.add_argument("--fault")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import run  # noqa: F401  (the run's environment)

    run._environment()
    import torch

    from benchmark.harness import spec
    from benchmark.harness.runner import run_cell

    cell = spec.cell(args.workload)
    device = torch.device("cuda", 0)
    mode = "control" if args.control else (f"fault:{args.fault}" if args.fault else "program")
    out = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            result = run_cell(cell, seed, args.seconds, False, device, t0, control=args.control, fault=args.fault)
            line = json.dumps({"workload": cell.name, "mode": mode, "seed": seed, "correct": result["correct"],
                               "checks": result["checks"], "metrics": result["metrics"],
                               "memory_peak_bytes": result["device"]["memory_peak_bytes"],
                               "seconds": time.perf_counter() - t0})  # fmt: skip
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            del result
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
