"""The port's benchmark: one run of one cell, one result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell asks
for.  It makes its inputs and weights on the card from ``--seed``, sets up
and warms up the cell (``setup_s`` counts from the process's start), runs
the window for ``--seconds``, checks what the window produced against the
plain reference, and prints as its last line of standard output one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones, read from a
``torch.profiler`` trace of the window), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with its limit,
which also end standard error.  Without a card, or with fewer than the cell
asks for, or when JAX or the JAX package was loaded, it prints no result
and exits non-zero.  Every cache it or the port builds stays under
``build/`` in the checkout.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    from benchmark.harness import imports

    os.environ.update(imports.ENVIRONMENT)
    os.environ["OMP_NUM_THREADS"] = "1"  # load from one process with few threads: the host paces some cells
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    _environment()
    from benchmark.harness import imports, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)  # fmt: skip
        return 2
    from benchmark.harness.runner import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), STARTED)
    found = imports.forbidden(sys.modules)
    if found:
        print(f"the run loaded JAX or the JAX package: {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
