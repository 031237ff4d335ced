"""The port's data-parallel training (``stamp_tpu_torch.parallel.mesh``,
``modeling.train`` with ``mesh_shape``) and its prefetching feed
(``parallel.prefetch``) on the CPU, with 2 gloo ranks in spawned processes:

* one data-parallel step on 2 ranks against the JAX package's
  ``make_dp_train_step`` on ``make_mesh(2)`` (the conftest's virtual CPU
  devices), from the same weights on the same global batch: the loss and
  every parameter and ALiBi statistic after the step within 1e-5, for
  classification with ALiBi and for tile survival (the Cox loss sums over
  the whole batch's risk sets, so a mean of per-rank losses would differ);
* ``train_model_`` with ``mesh_shape={"dp": 2}`` on 2 ranks against a
  single-process run on the same global batches (a ragged 3-row batch is
  cycled to 4 rows on both sides): ``metrics.csv`` within 1e-5 and the
  parameters within 1e-5 of the largest |parameter| (Adam amplifies the
  sum-order rounding of the small gradients of biases near 0), for ALiBi with dropout (the masks of the whole batch), for
  TransMIL (its pseudo-inverse scale is a max over the whole batch) and
  for survival; a mesh of one rank (a gloo group of its own) bitwise equal
  to the single-process run;
* ``prefetch_to_device``: the batches in order, a producer's exception
  raised in the consumer, at most ``size`` batches in flight, and a
  training run bitwise equal to the synchronous feed.

Parameters whose gradient is zero in exact arithmetic are driven by
rounding noise, which Adam turns into steps of up to ±lr: the key bias,
and in survival the head's and the final LayerNorm's bias (the Cox loss
ignores a shift of every risk score); these are held to 2·Σ lr.
"""

import json
import threading
import time

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu.parallel import mesh as jax_mesh
from stamp_tpu_torch.modeling import tasks, train
from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.models import weights
from stamp_tpu_torch.models import vision_transformer as torch_vit
from stamp_tpu_torch.parallel import mesh
from stamp_tpu_torch.parallel._dist_dryrun import FixedBatches, launch_local_fleet, task_model
from stamp_tpu_torch.parallel.prefetch import prefetch_to_device
from stamp_tpu_torch.utils.seed import Seed
from test_torch_train import _assert_close, stamp_logger_handlers  # noqa: F401 (fixture)

FEAT = 16
TOL = 1e-5
_VIT = dict(dim_model=32, n_layers=2, n_heads=4, dim_feedforward=32, use_alibi=True)
_WEIGHTS = [0.3, 0.7]


def _batch(rng, b: int, t: int, task: str) -> tuple:
    bags = rng.normal(size=(b, t, FEAT)).astype(np.float32)
    coords = (rng.integers(0, 8, size=(b, t, 2)) * 256.0).astype(np.float32)
    sizes = np.full((b,), t, np.int32)
    if task == "classification":
        targets = np.eye(2, dtype=np.float32)[rng.integers(0, 2, size=b)]
    else:  # (time, status), with a tied time
        times = rng.integers(1, 40, size=b).astype(np.float32)
        times[-1] = times[0]
        targets = np.stack([times, (np.arange(b) % 3 != 1).astype(np.float32)], axis=1)
    return bags, coords, sizes, targets


def _walk(lr_steps: list[float]) -> float:
    return 2 * sum(lr_steps)


def _assert_params(got: dict, want: dict, *, survival: bool, walk: float, per_tensor: bool = True) -> None:
    """Each tensor within ``TOL`` relative (``per_tensor``) or within
    ``TOL`` of the largest |parameter| of the model; the zero-gradient
    biases within ``walk``."""
    assert set(got) == set(want)
    scale = max(float(np.abs(v).max()) for v in want.values())
    for name, value in want.items():
        g, w = np.asarray(got[name], np.float64), np.asarray(value, np.float64)
        if name.endswith("k_proj.bias") or (survival and name in ("head.bias", "norm.bias")):
            assert np.abs(g - w).max() <= walk, name
        elif per_tensor:
            _assert_close(g, w, TOL, name)
        else:
            assert np.abs(g - w).max() <= TOL * scale, (name, np.abs(g - w).max(), scale)


# --- one data-parallel step against the JAX package ------------------------------


def _jax_task(task: str):
    common = dict(model_class=JaxViT, dim_input=FEAT, total_steps=4, **_VIT)
    if task == "classification":
        return jax_tasks.LitTileClassifier(
            ground_truth_label="gt", categories=["neg", "pos"], category_weights=np.array(_WEIGHTS, np.float32),
            **common,
        )  # fmt: skip
    return jax_tasks.LitTileSurvival(time_label="time", status_label="status", **common)


@pytest.fixture(scope="module")
def dp_steps(tmp_path_factory):
    """Per task: the JAX step's (loss, variables) and the port's result.npz
    from one 2-rank fleet."""
    root = tmp_path_factory.mktemp("dp_steps")
    jobs, want = [], {}
    for task in ("classification", "survival"):
        rng = np.random.default_rng(3)
        batch = _batch(rng, 4, 12, task)
        model = _jax_task(task)
        variables = jax.tree_util.tree_map(np.asarray, dict(model.init_variables(jax.random.PRNGKey(0), batch)))
        jmesh = jax_mesh.make_mesh(2, axes=("dp",))
        tx = model.make_optimizer()
        params = jax_mesh.replicate(variables["params"], jmesh)
        state = jax_mesh.replicate({k: v for k, v in variables.items() if k != "params"}, jmesh)
        opt_state = jax_mesh.replicate(tx.init(variables["params"]), jmesh)
        step, shardings = jax_mesh.make_dp_train_step(model, tx, jmesh)
        new_params, _, new_state, loss = step(
            params, opt_state, state, jax_mesh.shard_batch(batch, jmesh, shardings), jax.random.PRNGKey(1)
        )
        after = jax.tree_util.tree_map(np.asarray, {"params": new_params, **dict(new_state)})
        want[task] = (float(loss), torch_vit.variables_from_jax(after))

        job = root / task
        job.mkdir()
        state_dict = {f"state/{k}": v.numpy() for k, v in torch_vit.variables_from_jax(variables).items()}
        np.savez(job / "inputs.npz", bags=batch[0], coords=batch[1], sizes=batch[2], targets=batch[3], **state_dict)
        spec = dict(task=task, dim_input=FEAT, total_steps=4, model=_VIT, category_weights=_WEIGHTS)
        jobs.append(dict(kind="step", spec=spec, dir=str(job)))
    (root / "jobs.json").write_text(json.dumps(jobs))
    launch_local_fleet(["jobs", str(root / "jobs.json")], timeout=300, env_extra={"OMP_NUM_THREADS": "1"})
    return {task: (want[task], dict(np.load(root / task / "result.npz"))) for task in want}


@pytest.mark.parametrize("task", ["classification", "survival"])
def test_dp_step_matches_jax(dp_steps, task):
    (want_loss, want_vars), result = dp_steps[task]
    _assert_close(result["loss"], want_loss, TOL, "loss")
    got = {k.removeprefix("state/"): v for k, v in result.items() if k.startswith("state/")}
    lr = tasks.cosine_onecycle_schedule(4, 1e-4)(0)
    _assert_params(got, {k: v.numpy() for k, v in want_vars.items()}, survival=task == "survival", walk=_walk([lr]))
    assert float(got["block_0.mhsa.items_so_far"][0]) == 2.0  # one Welford update


# --- train_model_ under a mesh against a single process -------------------------------

_TRAIN_CASES = {
    # name: (task, model_name, model params, rows per train batch)
    "alibi_dropout": ("classification", "vit", dict(_VIT, dropout=0.1), 4),
    "alibi_ragged": ("classification", "vit", dict(_VIT, dropout=0.1), 3),
    "trans_mil": ("classification", "trans_mil", dict(dim_hidden=32), 4),
    "survival_ragged": ("survival", "vit", _VIT, 3),
}


def _train_inputs(task: str, rows: int) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(5)
    arrays = {}
    for prefix, b in (("train0/", rows), ("train1/", rows), ("valid0/", 1), ("valid1/", 1), ("valid2/", 1)):
        for key, value in zip(("bags", "coords", "sizes", "targets"), _batch(rng, b, 10, task)):
            arrays[prefix + key] = value
    if task == "classification":  # both classes among the validation targets
        arrays["valid0/targets"], arrays["valid1/targets"] = np.eye(2, dtype=np.float32)[[[0], [1]]]
    return arrays


def _spec(name: str) -> dict:
    task, model_name, params, _rows = _TRAIN_CASES[name]
    return dict(task=task, model_name=model_name, dim_input=FEAT, total_steps=4, model=params, n_train=2, n_valid=3,
                max_epochs=2, patience=2, seed=0, mesh_shape={"dp": 2}, category_weights=_WEIGHTS)  # fmt: skip


def _train_single(spec: dict, arrays: dict, out, *, cycle_to: int | None = None, mesh_shape=None) -> None:
    """``train_model_`` in this process on the job's global batches (a
    ragged one cycled to ``cycle_to`` rows, as the mesh pads it)."""
    from stamp_tpu_torch.parallel._dist_dryrun import batch_of

    def rows(batch):
        if cycle_to is None or batch[0].shape[0] % cycle_to == 0:
            return batch
        return tuple(x[np.arange(cycle_to) % batch[0].shape[0]] for x in batch)

    Seed.set(spec["seed"])
    train.train_model_(
        output_dir=out, model=task_model(spec),
        train_dl=FixedBatches([rows(batch_of(arrays, f"train{i}/")) for i in range(spec["n_train"])]),
        valid_dl=FixedBatches([batch_of(arrays, f"valid{i}/") for i in range(spec["n_valid"])]),
        max_epochs=spec["max_epochs"], patience=spec["patience"], device=torch.device("cpu"), mesh_shape=mesh_shape,
    )  # fmt: skip


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_runs")
    jobs = []
    for name, (task, _model, _params, rows) in _TRAIN_CASES.items():
        job = root / name
        job.mkdir()
        np.savez(job / "inputs.npz", **_train_inputs(task, rows))
        jobs.append(dict(kind="train", spec=_spec(name), dir=str(job)))
    (root / "jobs.json").write_text(json.dumps(jobs))
    launch_local_fleet(["jobs", str(root / "jobs.json")], timeout=300, env_extra={"OMP_NUM_THREADS": "1"})
    return root


def _metrics(out) -> pd.DataFrame:
    return pd.read_csv(out / "lightning_logs/version_0/metrics.csv")


@pytest.mark.parametrize("name", list(_TRAIN_CASES))
def test_mesh_training_matches_single_process(mesh_runs, name, tmp_path):
    spec = _spec(name)
    task, model_name, _params, rows = _TRAIN_CASES[name]
    arrays = dict(np.load(mesh_runs / name / "inputs.npz"))
    _train_single(spec, arrays, tmp_path / "single", cycle_to=4)
    fleet_out = mesh_runs / name / "rank0"
    assert not any((mesh_runs / name / "rank1").iterdir())  # rank 0 alone writes

    got, want = _metrics(fleet_out), _metrics(tmp_path / "single")
    assert list(got.columns) == list(want.columns) and len(got) == len(want) == 2
    survival = task == "survival"
    lr = tasks.cosine_onecycle_schedule(4, 1e-4)
    walk = _walk([lr(i) for i in range(4)])
    for column in want.columns:
        if survival and column == "train_pred_median":  # moved by the head bias's walk
            assert (np.abs(got[column] - want[column]) <= walk * 4).all(), column
        else:
            _assert_close(got[column].to_numpy(), want[column].to_numpy(), TOL, column)
    got_vars = load_checkpoint(fleet_out / "model.ckpt")["variables"]
    want_vars = load_checkpoint(tmp_path / "single" / "model.ckpt")["variables"]
    if model_name == "vit":
        got_sd, want_sd = torch_vit.variables_from_jax(got_vars), torch_vit.variables_from_jax(want_vars)
    else:
        got_sd, want_sd = (
            weights.state_dict_from_tree(v, ("params",)) for v in (got_vars, want_vars)
        )
    _assert_params(got_sd, want_sd, survival=survival, walk=walk, per_tensor=False)


def test_mesh_of_one_rank_is_the_single_process_run(tmp_path):
    """``mesh_shape={"dp": 1}`` joins a gloo group of one: bitwise the
    single-process run (the SUM of one rank's gradients is itself)."""
    spec = _spec("alibi_ragged")
    arrays = _train_inputs("classification", 3)
    _train_single(spec, arrays, tmp_path / "mesh", mesh_shape={"dp": 1})
    _train_single(spec, arrays, tmp_path / "plain")
    got = load_checkpoint(tmp_path / "mesh" / "model.ckpt")["variables"]
    want = load_checkpoint(tmp_path / "plain" / "model.ckpt")["variables"]
    for name, value in torch_vit.variables_from_jax(want).items():
        assert torch.equal(torch_vit.variables_from_jax(got)[name], value), name
    pd.testing.assert_frame_equal(_metrics(tmp_path / "mesh"), _metrics(tmp_path / "plain"))
    assert not torch.distributed.is_initialized()  # the group of one is left again


def test_global_helpers_are_identities_outside_a_step():
    """Outside a step a forward gets the group of one, whose collectives
    are identities (as is the step group of a mesh of one rank)."""
    from stamp_tpu_torch.ops.step_group import SINGLE

    t = torch.tensor(3.0)
    assert SINGLE.sum(t) is t and SINGLE.max(t) is t
    assert SINGLE.gather_seq(t) is t
    draw = SINGLE.draw((2, 3), lambda shape: torch.zeros(shape))
    assert draw.shape == (2, 3)
    assert mesh.step_group(None, 2) is SINGLE


def test_global_draw_inside_a_step_needs_the_rows_first():
    """Rank 0 of a 2-rank step holding 2 rows keeps rows 0–1 of a 4-row
    draw; a tensor whose first axis is not the local rows raises instead of
    drawing locally (which would advance each rank's generator apart)."""
    from stamp_tpu_torch.parallel.distributed import Mesh

    def draw(shape):
        return torch.arange(int(np.prod(shape))).reshape(tuple(shape))

    group = mesh.step_group(Mesh(axis_names=("dp",), sizes=(2,), rank=0), 2)
    assert torch.equal(group.draw((2, 3), draw), draw((4, 3))[:2])
    with pytest.raises(ValueError, match="local rows first"):
        group.draw((3, 2), draw)


# --- prefetch ---------------------------------------------------------------------------


def test_prefetch_keeps_the_order():
    rng = np.random.default_rng(0)
    batches = [(rng.normal(size=(2, 3)).astype(np.float32), {"t": np.arange(i, i + 2)}, None) for i in range(7)]
    got = list(prefetch_to_device(iter(batches), size=2))
    assert len(got) == len(batches)
    for (x, d, none), (gx, gd, gnone) in zip(batches, got, strict=True):
        assert isinstance(gx, torch.Tensor) and torch.equal(gx, torch.from_numpy(x))
        assert torch.equal(gd["t"], torch.from_numpy(d["t"])) and gnone is None


def test_prefetch_raises_the_producers_exception():
    def batches():
        yield np.zeros(2)
        yield np.ones(2)
        raise RuntimeError("h5 read failed")

    seen = []
    with pytest.raises(RuntimeError, match="h5 read failed"):
        for b in prefetch_to_device(batches(), size=2):
            seen.append(b)
    assert len(seen) == 2


@pytest.mark.parametrize("size", [1, 2, 3])
def test_prefetch_keeps_at_most_size_in_flight(size):
    produced = 0
    lock = threading.Lock()

    def batches():
        nonlocal produced
        for i in range(10):
            with lock:
                produced += 1
            yield np.full(1, i)

    ahead = []
    for received, b in enumerate(prefetch_to_device(batches(), size=size), start=1):
        time.sleep(0.02)  # the producer runs ahead as far as it may
        with lock:
            ahead.append(produced - received)
        assert int(b[0]) == received - 1
    assert max(ahead) <= size
    assert max(ahead) == size  # and does run ahead


def test_training_with_prefetch_equals_the_synchronous_feed(tmp_path, monkeypatch):
    spec = _spec("alibi_dropout")
    arrays = _train_inputs("classification", 4)
    _train_single(spec, arrays, tmp_path / "prefetch")

    def tensors(tree):
        if tree is None or isinstance(tree, np.ndarray):
            return None if tree is None else torch.from_numpy(tree)
        return type(tree)(tensors(x) for x in tree)

    def synchronous(iterable, *, size, device):
        yield from (tensors(batch) for batch in iterable)

    monkeypatch.setattr(train, "prefetch_to_device", synchronous)
    _train_single(spec, arrays, tmp_path / "sync")
    got = load_checkpoint(tmp_path / "prefetch" / "model.ckpt")["variables"]
    want = load_checkpoint(tmp_path / "sync" / "model.ckpt")["variables"]
    for name, value in torch_vit.variables_from_jax(want).items():
        assert torch.equal(torch_vit.variables_from_jax(got)[name], value), name
    pd.testing.assert_frame_equal(_metrics(tmp_path / "prefetch"), _metrics(tmp_path / "sync"))
