"""Local fleets: N OS processes of the port joined by ``torch.distributed``.

Counterpart of ``stamp_tpu/parallel/_fleet_launch.py:25``, shared by the
dry-run harnesses (``_dist_dryrun``, ``_extract_fleet_dryrun``) and by the
CLI, which launches one rank per card when a single process is given a
``mesh_shape`` of several ranks.  Each worker learns its identity from the
environment (``STAMP_COORDINATOR_ADDRESS=localhost:<free port>``,
``STAMP_NUM_PROCESSES``, ``STAMP_PROCESS_ID``) and starts in the caller's
working directory, so relative paths in ``argv`` and in the configs they
name resolve as they would in the caller.  The launcher waits for all of
them and, as soon as one fails, stops the others (they would wait in a
collective for the failed rank) and raises.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import tempfile
import time
from collections.abc import Iterable, Sequence
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[2]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch_fleet(
    argv: Sequence[str],
    *,
    n_processes: int,
    timeout: float | None = None,
    ok_sentinel: str | None = None,
    expect_ok: Iterable[int] | None = None,
    env_extra: dict[str, str] | None = None,
    env_drop: Iterable[str] = (),
    capture: bool = True,
) -> str:
    """Run ``python <argv>`` as ranks 0 … ``n_processes`` − 1 and return
    their combined output (rank order; with ``capture`` False the workers
    write to this process's stdout and stderr and "" is returned).

    Raises if a worker exits non-zero, if ``timeout`` seconds pass, or if
    a rank of ``expect_ok`` (default: all) did not print
    ``"{ok_sentinel} pid={rank}"``."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k not in set(env_drop)}
    env["PYTHONPATH"] = os.pathsep.join(p for p in [str(REPO_ROOT), env.get("PYTHONPATH")] if p)
    # the ranks share this host's cores: one share each unless told otherwise
    env.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // n_processes)))
    env.update(env_extra or {})
    env.update(STAMP_COORDINATOR_ADDRESS=f"localhost:{port}", STAMP_NUM_PROCESSES=str(n_processes))

    with tempfile.TemporaryDirectory(prefix="stamp_fleet_") as logs:
        files = [open(Path(logs) / f"rank{r}.log", "w+") if capture else None for r in range(n_processes)]
        procs = [
            subprocess.Popen(
                [sys.executable, *argv],
                stdout=files[r],
                stderr=subprocess.STDOUT if capture else None,
                env=env | {"STAMP_PROCESS_ID": str(r)},
            )
            for r in range(n_processes)
        ]
        deadline = None if timeout is None else time.monotonic() + timeout
        failed: list[int] = []
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if failed or (deadline is not None and time.monotonic() > deadline):
                    break
                time.sleep(0.1)
            failed = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
            timed_out = any(p.poll() is None for p in procs)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outputs = []
        for r, f in enumerate(files):
            if f is not None:
                f.seek(0)
                outputs.append(f"--- rank {r} (rc={procs[r].returncode}) ---\n{f.read()}")
                f.close()
    combined = "\n".join(outputs)
    if failed:
        raise RuntimeError(f"fleet rank(s) {failed} failed (rc={[procs[r].returncode for r in failed]}):\n{combined}")
    if timed_out:
        raise RuntimeError(f"fleet did not finish within {timeout} s:\n{combined}")
    if ok_sentinel is not None:
        for r in expect_ok if expect_ok is not None else range(n_processes):
            if f"{ok_sentinel} pid={r}" not in combined:
                raise RuntimeError(f"rank {r} missing OK sentinel in output:\n{combined}")
    return combined
