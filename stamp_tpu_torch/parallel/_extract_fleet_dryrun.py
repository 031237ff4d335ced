"""Multi-process extraction fleet: worker and local-fleet launcher.

Counterpart of ``stamp_tpu/parallel/_extract_fleet_dryrun.py:124``: N OS
processes join a ``torch.distributed`` fleet (``_fleet_launch``) and each
runs the real ``python -m stamp_tpu_torch -c <config> preprocess`` into
the shared output directory, taking its ``shard_worklist`` share of the
slides.

The crashed-worker case: with ``STAMP_FLEET_EXIT_EARLY=<rank>`` that rank
exits right after joining the fleet, its share never extracted, so a
follow-up single-process run must complete the cohort through
skip-if-exists.

Exit barrier: rank 0 hosts the fleet's TCP store, so it leaves last — every
rank drops a marker ``.fleet_exit_<rank>`` into the output directory when
done (the simulated crash too) and rank 0 waits for the others' markers,
up to ``STAMP_FLEET_EXIT_GRACE_S`` seconds (600 by default).

Run a worker by hand with the fleet's environment set:

    python -m stamp_tpu_torch.parallel._extract_fleet_dryrun <config.yaml>
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import yaml

_OK_SENTINEL = "EXTRACT_FLEET_OK"


def main(argv: list[str]) -> None:
    from stamp_tpu_torch.__main__ import _configure_logging
    from stamp_tpu_torch.__main__ import main as cli
    from stamp_tpu_torch.parallel import distributed

    _configure_logging()  # the "stamp" log (the backend chosen among it) on stderr
    config = argv[0]
    section = yaml.safe_load(Path(config).read_text())["preprocessing"]
    out_dir = Path(section["output_dir"])
    distributed.init_distributed(use_cuda=section.get("device", "auto") != "cpu")
    rank, n = distributed.process_index(), distributed.process_count()
    out_dir.mkdir(parents=True, exist_ok=True)

    def exit_barrier() -> None:
        (out_dir / f".fleet_exit_{rank}").touch()
        if rank == 0:
            deadline = time.monotonic() + float(os.environ.get("STAMP_FLEET_EXIT_GRACE_S", "600"))
            while time.monotonic() < deadline:
                if all((out_dir / f".fleet_exit_{r}").exists() for r in range(1, n)):
                    break
                time.sleep(0.2)
        sys.stdout.flush()
        sys.stderr.flush()
        os._exit(0)  # no process-group shutdown: a crashed peer must not hang us

    if os.environ.get("STAMP_FLEET_EXIT_EARLY") == str(rank):
        print(f"[{rank}] simulated crash before extraction", flush=True)
        exit_barrier()

    cli(["-c", config, "preprocess"])  # exits non-zero on failure
    n_h5 = len(list(out_dir.rglob("*.h5")))
    print(f"{_OK_SENTINEL} pid={rank} h5_total={n_h5}", flush=True)
    exit_barrier()


def launch_extract_fleet(
    config: Path, *, n_processes: int = 2, timeout: float = 600.0, crash_pid: int | None = None,
    env_extra: dict[str, str] | None = None,
) -> str:  # fmt: skip
    """Run ``preprocess`` of ``config`` as an ``n_processes`` fleet over its
    shared output directory; returns the combined output.  ``crash_pid``
    makes that rank exit before extracting (its share is left for a later
    run)."""
    from stamp_tpu_torch.parallel._fleet_launch import launch_fleet

    env = dict(env_extra or {})
    if crash_pid is not None:
        env["STAMP_FLEET_EXIT_EARLY"] = str(crash_pid)
    return launch_fleet(
        ["-m", "stamp_tpu_torch.parallel._extract_fleet_dryrun", str(config)],
        n_processes=n_processes, timeout=timeout, ok_sentinel=_OK_SENTINEL,
        expect_ok=[r for r in range(n_processes) if r != crash_pid], env_extra=env,
        env_drop=() if crash_pid is not None else ("STAMP_FLEET_EXIT_EARLY",),
    )  # fmt: skip


if __name__ == "__main__":
    main(sys.argv[1:])
