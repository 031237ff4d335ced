"""The port's fleet layer (``stamp_tpu_torch.parallel.distributed``) against
the JAX package's, and its fleets through the CLI, on the CPU:

* the work shares: ``shard_worklist``, ``assign_folds`` and ``fold_is_mine``
  for world sizes 1–4, held to the JAX functions with ``jax.process_index``
  and ``jax.process_count`` monkeypatched (equal shares, equal order);
* mesh validation: the product and ``dcn`` checks with the JAX package's
  wording (an ``sp`` axis under the same checks, an unknown axis
  refused), rank coordinates, the ``(dcn, dp, sp)`` layout with ``sp``
  innermost and its groups, and the backend chosen from the topology;
* the extraction fleet (two processes, ``preprocess`` with DinoBloom at
  random weights into one directory): every slide once, each rank's
  ``shard_worklist`` share, a crashed rank's share picked up by a
  single-process run, features equal to a single-process run's bitwise;
* the crossval fleet (two processes, no mesh): one fold each, predictions
  equal to single-process runs within 1e-6 (the folds of one process share
  the host generator in turn, as in the JAX package, so a fleet's fold 1 is
  held to a single-process run that reaches fold 1 with fold 0 done);
* one ``crossval`` process given ``mesh_shape: {dp: 2}``, which launches
  its two ranks itself and trains every fold with both: predictions within
  1e-5 of one process (every rank draws what one process draws, the
  held-out exports' bags included); and the CLI's refusals of a mesh it
  cannot run.

Spawned fleets listen on free localhost ports, so parallel test workers do
not collide.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import yaml
from PIL import Image

from stamp_tpu.parallel import distributed as jax_distributed
from stamp_tpu_torch.io.h5 import read_h5
from stamp_tpu_torch.parallel import distributed
from stamp_tpu_torch.parallel._dist_dryrun import launch_local_fleet
from stamp_tpu_torch.parallel._extract_fleet_dryrun import launch_extract_fleet
from test_torch_train import _cohort, _train_config, stamp_logger_handlers  # noqa: F401 (fixture)

REPO = Path(__file__).resolve().parent.parent
# the ranks' models are tiny: one thread each keeps a loaded machine responsive
_ONE_THREAD = {"OMP_NUM_THREADS": "1"}
_WORLDS = [(n, r) for n in range(1, 5) for r in range(n)]


def _as_rank(monkeypatch, rank: int, n: int) -> None:
    monkeypatch.setattr(jax, "process_index", lambda: rank)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    monkeypatch.setattr(distributed, "process_index", lambda: rank)
    monkeypatch.setattr(distributed, "process_count", lambda: n)


# --- work shares --------------------------------------------------------------


@pytest.mark.parametrize("n,rank", _WORLDS, ids=[f"{r}of{n}" for n, r in _WORLDS])
def test_work_shares_match_jax(n, rank, monkeypatch):
    slides = [Path(f"/cohort/{c}/slide{i:02d}.svs") for c in "ab" for i in range(7)]
    _as_rank(monkeypatch, rank, n)
    for items in (slides, slides[::-1], list(range(13)), []):
        assert distributed.shard_worklist(items) == jax_distributed.shard_worklist(items)
        assert distributed.shard_worklist(items, seed=7) == jax_distributed.shard_worklist(items, seed=7)
    for n_splits in (1, 2, 5, 7):
        assert distributed.assign_folds(n_splits) == jax_distributed.assign_folds(n_splits)
        assert [distributed.fold_is_mine(i) for i in range(n_splits)] == [
            jax_distributed.fold_is_mine(i) for i in range(n_splits)
        ]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_shares_partition_the_worklist(n, monkeypatch):
    slides = [f"slide{i:02d}" for i in range(11)]
    shares = []
    for rank in range(n):
        _as_rank(monkeypatch, rank, n)
        shares.append(distributed.shard_worklist(slides))
        assert set(distributed.assign_folds(5)) == {i for i in range(5) if distributed.fold_is_mine(i)}
    assert sorted(s for share in shares for s in share) == slides


# --- mesh ---------------------------------------------------------------------


def test_mesh_of_a_single_process():
    mesh = distributed.make_global_mesh()
    assert mesh.shape == {"dp": 1} and mesh.coords == {"dp": 0} and mesh.size == 1
    assert distributed.make_global_mesh({"dp": 1}).shape == {"dp": 1}
    with pytest.raises(ValueError, match=r"needs 2 devices but 1 are visible"):
        distributed.make_global_mesh({"dp": 2})


def test_mesh_checks(monkeypatch):
    _as_rank(monkeypatch, 3, 4)
    monkeypatch.setattr(distributed, "_n_hosts", 2)
    mesh = distributed.make_global_mesh({"dcn": 2, "dp": 2})
    assert mesh.coords == {"dcn": 1, "dp": 1} and mesh.size == 4
    assert distributed.make_global_mesh().shape == {"dcn": 2, "dp": 2}  # the default: dcn = hosts
    with pytest.raises(ValueError, match=r"needs 3 devices but 4 are visible"):
        distributed.make_global_mesh({"dp": 3})
    _as_rank(monkeypatch, 0, 6)
    monkeypatch.setattr(distributed, "_n_hosts", 4)
    with pytest.raises(ValueError, match=r"dcn axis \(3\) must align with the host count \(4\)"):
        distributed.make_global_mesh({"dcn": 3, "dp": 2})


@pytest.mark.parametrize("shape", [{"sp": 2}, {"dp": 1, "sp": 1}, {"dcn": 1, "dp": 2, "sp": 2}])
def test_sp_axis_raises(shape, monkeypatch):
    """A mesh with an ``sp`` axis raises where any mesh does: on 3 ranks
    none of these fits (the JAX package's wording); an axis name the JAX
    package does not know raises too."""
    _as_rank(monkeypatch, 0, 3)
    with pytest.raises(ValueError, match=rf"needs {np.prod(list(shape.values()))} devices but 3 are visible"):
        distributed.make_global_mesh(shape)
    with pytest.raises(ValueError, match=r"unknown axis \['tp'\]"):
        distributed.make_global_mesh({**shape, "tp": 1})


def test_sp_mesh_layout(monkeypatch):
    """``{sp: 2, dp: 2}`` is laid out ``(dp, sp)``, ``sp`` innermost: a
    sequence group is two neighbouring ranks, a data-parallel group the
    ranks with the same ``sp`` coordinate."""
    _as_rank(monkeypatch, 3, 4)
    mesh = distributed.make_global_mesh({"sp": 2, "dp": 2})
    assert mesh.axis_names == ("dp", "sp") and mesh.coords == {"dp": 1, "sp": 1}
    assert mesh.ranks_along(("sp",)) == (2, 3) and mesh.ranks_along(mesh.data_axes()) == (1, 3)
    assert mesh.ranks_along(("sp",), rank=0) == (0, 1) and mesh.data_axes(None) == ("dp", "sp")
    _as_rank(monkeypatch, 5, 8)
    mesh = distributed.make_global_mesh({"dcn": 2, "dp": 2, "sp": 2})
    assert mesh.coords == {"dcn": 1, "dp": 0, "sp": 1}
    assert mesh.ranks_along(("sp",)) == (4, 5) and mesh.ranks_along(("dcn", "dp")) == (1, 3, 5, 7)


@pytest.mark.parametrize(
    "topology,backend",
    [
        ([("h0", 2), ("h0", 2)], "nccl"),
        ([("h0", 1), ("h1", 1)], "nccl"),
        ([("h0", 1), ("h0", 1)], "gloo"),  # two ranks on one card
        ([("h0", 4), ("h0", 4), ("h1", 1), ("h1", 1)], "gloo"),
        ([("h0", 0), ("h0", 0)], "gloo"),  # CPU ranks
        ([("h0", 8), ("h1", 0)], "gloo"),
    ],
)
def test_backend_follows_the_topology(topology, backend):
    assert distributed.choose_backend(topology)[0] == backend


def test_init_distributed_without_a_fleet(monkeypatch):
    for var in ("STAMP_COORDINATOR_ADDRESS", "STAMP_NUM_PROCESSES", "STAMP_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    distributed.init_distributed()  # no fleet: a no-op
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    monkeypatch.setenv("STAMP_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="STAMP_COORDINATOR_ADDRESS"):
        distributed.init_distributed()


def test_group_of_one_on_the_cpu():
    from stamp_tpu_torch.parallel._fleet_launch import free_port

    distributed.init_distributed(
        coordinator_address=f"localhost:{free_port()}", num_processes=1, process_id=0, use_cuda=False
    )
    try:
        assert distributed.backend() == "gloo" and distributed.process_count() == 1
    finally:
        distributed.shutdown_distributed()
    assert distributed.backend() is None and distributed.process_count() == 1


# --- the CLI fleets -------------------------------------------------------------


def _write_slides(root: Path, n: int = 4) -> list[Path]:
    """Small textured TIFFs at 1 µm/px (2 or 4 tiles of 256 µm each)."""
    root.mkdir(parents=True)
    rng = np.random.default_rng(0)
    paths = []
    for i in range(n):
        arr = rng.integers(60, 200, (512, 256 + 256 * (i % 2), 3), dtype=np.uint8)
        path = root / f"slide{i}.tif"
        Image.fromarray(arr).save(path, format="TIFF", compression="tiff_lzw", resolution=10000.0, resolution_unit=3)
        paths.append(path)
    return paths


def _preprocess_config(tmp_path: Path, slides: Path, out: Path) -> Path:
    config = tmp_path / f"{out.name}.yaml"
    config.write_text(yaml.safe_dump({"preprocessing": {
        "output_dir": str(out), "wsi_dir": str(slides), "extractor": "dino-bloom", "device": "cpu",
        "max_workers": 2, "generate_hash": False,
    }}))  # fmt: skip
    return config


def _features(out: Path) -> dict[str, tuple]:
    """slide stem → (feats, coords) sorted by coordinate."""
    result = {}
    for path in sorted(out.rglob("*.h5")):
        datasets, _ = read_h5(path)
        order = np.lexsort((datasets["coords"][:, 1], datasets["coords"][:, 0]))
        result[path.stem] = (datasets["feats"][order], datasets["coords"][order])
    return result


def test_extraction_fleet_and_crash_pickup(tmp_path, monkeypatch, stamp_logger_handlers):  # noqa: F811
    """Features of each slide bitwise equal to a single-process run's
    (every slide is one batch of the same size in both)."""
    from stamp_tpu_torch.__main__ import main

    env = {"STAMP_RANDOM_WEIGHTS": "1", "STAMP_EXTRACT_BATCH": "16", "HOME": str(tmp_path)}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    slides = _write_slides(tmp_path / "slides")
    stems = sorted(p.stem for p in slides)

    single = tmp_path / "single"
    main(["-c", str(_preprocess_config(tmp_path, tmp_path / "slides", single)), "preprocess"])
    want = _features(single)
    assert sorted(want) == stems

    fleet = tmp_path / "fleet"
    log = launch_extract_fleet(_preprocess_config(tmp_path, tmp_path / "slides", fleet), timeout=300, env_extra=_ONE_THREAD)
    assert "extraction fleet: process 0/2 takes 2 slides" in log
    assert "extraction fleet: process 1/2 takes 2 slides" in log
    got = _features(fleet)
    assert sorted(got) == stems  # every slide once, none missing
    for stem in stems:
        np.testing.assert_array_equal(got[stem][1], want[stem][1])
        np.testing.assert_array_equal(got[stem][0], want[stem][0])

    crashed = tmp_path / "crashed"
    config = _preprocess_config(tmp_path, tmp_path / "slides", crashed)
    log = launch_extract_fleet(config, crash_pid=1, timeout=300, env_extra=_ONE_THREAD)
    assert "[1] simulated crash before extraction" in log
    with monkeypatch.context() as m:
        m.setattr(distributed, "process_index", lambda: 0)
        m.setattr(distributed, "process_count", lambda: 2)
        share0 = sorted(p.stem for p in distributed.shard_worklist(slides))
    assert sorted(_features(crashed)) == share0  # rank 0's share, rank 1's left

    main(["-c", str(config), "preprocess"])  # a single process picks the rest up
    picked = _features(crashed)
    assert sorted(picked) == stems
    for stem in stems:
        np.testing.assert_array_equal(picked[stem][0], want[stem][0])


def test_crossval_fleet_partitions_folds(tmp_path):
    """Each rank trains its fold; predictions within 1e-6 of single-process
    runs that reach that fold with the other one done.  Every process runs
    with ``PYTHONHASHSEED=0``: the order of a fold's patients is the
    iteration order of ``splits.json``'s sets, which follows the string
    hashing of the process (in the JAX package too)."""
    cohort = _cohort(tmp_path, "classification")
    env = {**os.environ, "PYTHONHASHSEED": "0"}

    def config(name: str) -> str:
        return _train_config(tmp_path, name, "classification", cohort, use_alibi=True, bag_size=8,
                             section="crossval", n_splits=2)  # fmt: skip

    fleet = tmp_path / "fleet"
    log = launch_local_fleet(
        ["cli", config("fleet"), "crossval"], timeout=300, env_extra={"PYTHONHASHSEED": "0", **_ONE_THREAD}
    )
    assert "skipping split 1: assigned to process 1 of the fleet" in log
    assert "skipping split 0: assigned to process 0 of the fleet" in log
    procs = []
    for fold in (0, 1):  # both single-process runs at once
        single = tmp_path / f"single{fold}"
        (single / f"split-{1 - fold}").mkdir(parents=True)
        shutil.copy(fleet / "splits.json", single)
        shutil.copy(fleet / f"split-{1 - fold}" / "patient-preds.csv", single / f"split-{1 - fold}")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "stamp_tpu_torch", "-c", config(f"single{fold}"), "crossval"],
            cwd=REPO, env=env | _ONE_THREAD, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True,
        ))  # fmt: skip
    for fold, proc in enumerate(procs):
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert f"skipping training for split {1 - fold}" in err
        single = tmp_path / f"single{fold}"
        got = pd.read_csv(fleet / f"split-{fold}" / "patient-preds.csv").sort_values("patient")
        want = pd.read_csv(single / f"split-{fold}" / "patient-preds.csv").sort_values("patient")
        assert got["patient"].tolist() == want["patient"].tolist()
        for column in ("ground-truth_high", "ground-truth_low"):
            np.testing.assert_allclose(got[column], want[column], rtol=0, atol=1e-6)
        assert (fleet / f"split-{fold}" / "model.ckpt").is_file()


def _with_mesh(config: str, mesh_shape: dict, **advanced) -> str:
    body = yaml.safe_load(Path(config).read_text())
    body["advanced_config"] |= {"mesh_shape": mesh_shape, **advanced}
    Path(config).write_text(yaml.safe_dump(body))
    return config


def test_cli_launches_the_mesh_ranks_itself(tmp_path):
    """One ``crossval`` process given ``mesh_shape: {dp: 2}`` on the CPU runs
    two ranks of itself, which train every fold together (rank 0 writes
    ``splits.json`` and the exports): each fold's probabilities within 1e-5
    of a single-process run (the rows' sum order differs; both with
    ``PYTHONHASHSEED=0``, which orders a fold's patients)."""
    cohort = _cohort(tmp_path, "classification")
    env = {k: v for k, v in os.environ.items() if not k.startswith("STAMP_")} | _ONE_THREAD | {"PYTHONHASHSEED": "0"}
    procs = {}
    for name, mesh_shape in (("mesh", {"dp": 2}), ("single", None)):
        config = _train_config(tmp_path, name, "classification", cohort, use_alibi=True, bag_size=8,
                               section="crossval", n_splits=2)  # fmt: skip
        if mesh_shape:
            _with_mesh(config, mesh_shape)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "stamp_tpu_torch", "-c", config, "crossval"],
            cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        )  # fmt: skip
    logs = {name: proc.communicate(timeout=300)[1] for name, proc in procs.items()}
    for name, proc in procs.items():
        assert proc.returncode == 0, logs[name][-3000:]
    assert "running this command as 2 local ranks" in logs["mesh"]
    assert logs["mesh"].count("sharded training on mesh {'dp': 2} (2 rank(s), backend gloo)") == 4  # 2 folds × 2 ranks
    assert "assigned to process" not in logs["mesh"]  # a mesh keeps the folds together
    for fold in (0, 1):
        got = pd.read_csv(tmp_path / "mesh" / f"split-{fold}" / "patient-preds.csv").sort_values("patient")
        want = pd.read_csv(tmp_path / "single" / f"split-{fold}" / "patient-preds.csv").sort_values("patient")
        assert got["patient"].tolist() == want["patient"].tolist()
        for column in ("ground-truth_high", "ground-truth_low"):
            np.testing.assert_allclose(got[column], want[column], rtol=0, atol=1e-5)


def test_cli_mesh_ranks_run_in_the_callers_directory(tmp_path):
    """``train`` with ``mesh_shape: {dp: 2}`` started in a directory of the
    caller, with a relative ``-c`` and a relative ``output_dir``: the ranks
    it launches resolve both there, so ``model.ckpt`` lands beside the
    config, and nothing lands in the repository."""
    cohort = _cohort(tmp_path, "classification")
    config = Path(_with_mesh(
        _train_config(tmp_path, "relative", "classification", cohort, use_alibi=True, bag_size=8), {"dp": 2}
    ))  # fmt: skip
    body = yaml.safe_load(config.read_text())
    body["training"]["output_dir"] = "relative-out"
    body["advanced_config"]["max_epochs"] = 1
    config.write_text(yaml.safe_dump(body))
    env = {k: v for k, v in os.environ.items() if not k.startswith("STAMP_")} | _ONE_THREAD
    proc = subprocess.run(
        [sys.executable, "-m", "stamp_tpu_torch", "-c", config.name, "train"],
        cwd=tmp_path, env=env | {"PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))},
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True, timeout=300,
    )  # fmt: skip
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "running this command as 2 local ranks" in proc.stderr
    assert (tmp_path / "relative-out" / "model.ckpt").is_file()
    assert not (REPO / "relative-out").exists()


@pytest.mark.parametrize("mesh_shape,message", [
    ({"dp": 2}, "needs 2 devices but 0 are visible"),
    ({"dp": 2, "sp": 2}, "needs 4 devices but 0 are visible"),
])  # fmt: skip
def test_cli_refuses_a_mesh_it_cannot_run(tmp_path, mesh_shape, message, stamp_logger_handlers, caplog):  # noqa: F811
    """``accelerator: cuda`` with fewer cards than ranks raises before any
    rank starts, with or without an ``sp`` axis."""
    from stamp_tpu_torch.__main__ import main

    cohort = _cohort(tmp_path, "classification")
    config = _with_mesh(
        _train_config(tmp_path, "refused", "classification", cohort, use_alibi=True, bag_size=8), mesh_shape,
        accelerator="cuda",
    )  # fmt: skip
    with pytest.raises(SystemExit) as exit_info:
        main(["-c", config, "train"])
    assert exit_info.value.code == 1 and message in caplog.text
    assert not (tmp_path / "refused" / "model.ckpt").exists()
