"""The port's sequence parallelism (the ``sp`` mesh axis) on the CPU, with
one fleet of 2 gloo ranks on ``mesh_shape={"sp": 2}`` for the module:

* one training step (``torch_sequence_util``) against the JAX package's
  ``make_dp_train_step(..., sp_axis="sp")`` on a ``(1, 2)`` mesh of virtual
  devices for ``vit``, ALiBi and barspoon, and against the port's
  single-process step for the cases with dropout (``vit`` and ALiBi at
  0.25, TransMIL's 0.1), a slide-level MLP (its vectors the same on both
  ranks: the gradient must not count twice) and, at T = 4,096 tiles + CLS,
  ``vit`` and ALiBi on the flash path (Tq = 2,049 queries a rank against
  4,097 keys, through the kernels' plain versions): the loss, the state
  after the step and the all-reduced gradients (``assert_step``'s
  tolerances: 1e-5, the gradients of each tensor's largest);
* ``train_model_`` with ``{"sp": 2}`` against a single process for the
  data-parallel tests' cases (``test_torch_parallel._TRAIN_CASES``) and a
  slide-level MLP: ``metrics.csv`` within 1e-5 and the parameters within
  1e-5 of the largest |parameter| (Adam amplifies the sum-order rounding of
  small gradients), rank 0 alone writing;
* ``make_sp_eval_forward``: an ALiBi ViT on a 32-tile bag with masked
  tiles against the JAX package's (its 8 virtual devices, ``atol`` 1e-5, as
  ``tests/test_parallel.py:83-111``) and the port's single-process
  forward, and barspoon against the latter; the output equal on both
  ranks;
* the sequence collective with autograd (``gather_seq``, whose backward
  reduce-scatters) on both ranks against its definition;
* a bag whose length does not divide by ``sp`` raises with the JAX
  package's message, and a step group's dropout draw keeps the rank's rows
  and tiles of the unsharded draw.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import torch_sequence_util as seq
from stamp_tpu.parallel import mesh as jax_mesh
from stamp_tpu_torch.modeling import tasks
from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.modeling.train import _mesh_feed
from stamp_tpu_torch.models import weights
from stamp_tpu_torch.models import vision_transformer as torch_vit
from stamp_tpu_torch.parallel import mesh
from stamp_tpu_torch.parallel._dist_dryrun import launch_local_fleet, task_model
from stamp_tpu_torch.parallel.distributed import Mesh
from test_torch_parallel import _TRAIN_CASES, _assert_params, _metrics, _spec, _train_inputs, _train_single, _walk
from test_torch_train import _assert_close

SP = {"sp": 2}
JAX_CASES = [name for name, case in seq.STEP_CASES.items() if case[3]]
PORT_CASES = [name for name, case in seq.STEP_CASES.items() if not case[3]]
TRAIN_CASES = [*_TRAIN_CASES, "mlp_slide"]
EVAL_T = 32


def _train_spec(name: str) -> dict:
    if name == "mlp_slide":
        return dict(task="classification", model_name="mlp", feature="slide", dim_input=seq.FEAT, total_steps=4,
                    model=dict(dim_hidden=16), n_train=2, n_valid=3, max_epochs=2, patience=2, seed=0, mesh_shape=SP,
                    category_weights=seq.WEIGHTS)  # fmt: skip
    return _spec(name) | {"mesh_shape": SP}


def _train_arrays(name: str) -> dict[str, np.ndarray]:
    if name != "mlp_slide":
        return _train_inputs(_TRAIN_CASES[name][0], _TRAIN_CASES[name][3])
    rng = np.random.default_rng(5)
    arrays = {}
    for prefix, b in (("train0/", 4), ("train1/", 3), ("valid0/", 1), ("valid1/", 1), ("valid2/", 1)):
        arrays[prefix + "feats"] = rng.normal(size=(b, seq.FEAT)).astype(np.float32)
        arrays[prefix + "targets"] = np.eye(2, dtype=np.float32)[np.arange(b) % 2]
    arrays["valid1/targets"] = np.eye(2, dtype=np.float32)[[1]]
    return arrays


def _eval_case(name: str) -> tuple[dict, dict]:
    """(spec, arrays with the weights as ``state/``) of an eval job."""
    rng = np.random.default_rng(3)
    arrays = {
        "bags": rng.normal(size=(1, EVAL_T, seq.FEAT)).astype(np.float32),
        "coords": (rng.integers(0, 8, size=(1, EVAL_T, 2)) * 256.0).astype(np.float32),
        "key_mask": np.arange(EVAL_T)[None] < EVAL_T - 5,
    }
    model_name, params = ("vit", dict(seq.VIT, use_alibi=True)) if name == "alibi" else ("barspoon", seq.BARSPOON)
    spec = dict(task="classification", model_name=model_name, dim_input=seq.FEAT, total_steps=4, model=params,
                mesh_shape=SP, targets=seq.TARGETS, category_weights=seq.WEIGHTS)  # fmt: skip
    model = task_model(spec)
    weights.init_weights_(model.module, torch.Generator().manual_seed(2))
    if name == "alibi":  # statistics of a trained model: the distance bias weighs like the softmax
        for block in range(seq.VIT["n_layers"]):
            getattr(model.module, f"block_{block}").mhsa.running_mean.fill_(1500.0)
    arrays |= {f"state/{k}": v.numpy() for k, v in model.module.state_dict().items()}
    return spec, arrays


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """Every job of the module in one 2-rank fleet, and meanwhile the
    references in this process: per step case (reference loss, state,
    gradients), the JAX step's (loss, state) for the JAX cases."""
    root = tmp_path_factory.mktemp("sp_fleet")
    jobs, refs = [], {}
    for name in seq.STEP_CASES:
        tiles = 4096 if name.endswith("_flash") else 8
        rows = 1 if name.endswith("_flash") else 2
        arrays = seq.step_batch(name, rows, tiles)
        state, variables = seq.initial_state(name, arrays)
        jobs.append(seq.write_step_job(root, name, SP, rows, tiles, state))
        refs[name] = (state, variables, arrays)
    for name in TRAIN_CASES:
        job = root / f"train-{name}"
        job.mkdir()
        np.savez(job / "inputs.npz", **_train_arrays(name))
        jobs.append(dict(kind="train", spec=_train_spec(name), dir=str(job)))
    jobs.append(dict(kind="collectives", spec={}))
    for name in ("alibi", "barspoon"):
        job = root / f"eval-{name}"
        job.mkdir()
        spec, arrays = _eval_case(name)
        np.savez(job / "inputs.npz", **arrays)
        jobs.append(dict(kind="sp_eval", spec=spec, dir=str(job)))
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(
            launch_local_fleet, ["jobs", seq.jobs_file(root, jobs)], timeout=600, env_extra={"OMP_NUM_THREADS": "1"}
        )
        want = {}
        for name, (state, variables, arrays) in refs.items():
            single = seq.single_step(name, state, arrays)
            jax_result = seq.jax_step(name, variables, arrays, SP) if variables is not None else None
            want[name] = (single, jax_result)
        log = run.result()
    return root, want, log


@pytest.mark.parametrize("name", JAX_CASES)
def test_sp_step_matches_jax(fleet, name):
    root, want, _ = fleet
    (single_loss, single_state, grads), (jax_loss, jax_state) = want[name]
    result = dict(np.load(root / name / "result.npz"))
    seq.assert_step(result, jax_loss, jax_state, None, seq.first_lr(name))
    seq.assert_step(result, single_loss, single_state, grads, seq.first_lr(name))  # the gradients: one process's


@pytest.mark.parametrize("name", PORT_CASES)
def test_sp_step_matches_one_process(fleet, name):
    root, want, _ = fleet
    (single_loss, single_state, grads), _ = want[name]
    seq.assert_step(dict(np.load(root / name / "result.npz")), single_loss, single_state, grads, seq.first_lr(name))


@pytest.mark.parametrize("name", TRAIN_CASES)
def test_sp_training_matches_single_process(fleet, name, tmp_path):
    root, _, _ = fleet
    spec = _train_spec(name)
    job = root / f"train-{name}"
    _train_single(spec, dict(np.load(job / "inputs.npz")), tmp_path / "single")
    assert not any((job / "rank1").iterdir())  # rank 0 alone writes
    got, want = _metrics(job / "rank0"), _metrics(tmp_path / "single")
    assert list(got.columns) == list(want.columns) and len(got) == len(want) == 2
    survival = spec["task"] == "survival"
    schedule = tasks.cosine_onecycle_schedule(4, 1e-4)
    walk = _walk([schedule(i) for i in range(4)])
    for column in want.columns:
        if survival and column == "train_pred_median":  # moved by the head bias's walk
            assert (np.abs(got[column] - want[column]) <= walk * 4).all(), column
        else:
            _assert_close(got[column].to_numpy(), want[column].to_numpy(), 1e-5, column)
    got_vars = load_checkpoint(job / "rank0" / "model.ckpt")["variables"]
    want_vars = load_checkpoint(tmp_path / "single" / "model.ckpt")["variables"]
    if spec["model_name"] == "vit":
        got_sd, want_sd = torch_vit.variables_from_jax(got_vars), torch_vit.variables_from_jax(want_vars)
    else:
        got_sd, want_sd = (weights.state_dict_from_tree(v, ("params",)) for v in (got_vars, want_vars))
    _assert_params(got_sd, want_sd, survival=survival, walk=walk, per_tensor=False)


@pytest.mark.parametrize("name", ["alibi", "barspoon"])
def test_sp_eval_forward(fleet, name):
    """The sharded forward against the port's single-process forward of the
    same weights and, for the ALiBi ViT, the JAX package's
    ``make_sp_eval_forward`` on its 8 virtual devices (``atol`` 1e-5)."""
    root, _, _ = fleet
    spec, arrays = _eval_case(name)
    result = dict(np.load(root / f"eval-{name}" / "result.npz"))
    assert float(result["rank_spread"]) == 0.0  # the output is the same on both ranks
    model = task_model(spec)
    model.module.load_state_dict({k[6:]: torch.from_numpy(v) for k, v in arrays.items() if k.startswith("state/")})
    with torch.inference_mode():
        single = model.module(
            torch.from_numpy(arrays["bags"]), coords=torch.from_numpy(arrays["coords"]),
            key_mask=torch.from_numpy(arrays["key_mask"]),
        )  # fmt: skip
    if name == "barspoon":  # the targets' logits side by side
        single = torch.cat(list(single.values()), dim=-1)
    got = result["out"]
    np.testing.assert_allclose(got, single.numpy(), rtol=0, atol=1e-5)
    if name != "alibi":
        return
    jax_model = seq._jax_task("alibi")
    variables = torch_vit.variables_to_jax(model.module.state_dict())
    jmesh = jax_mesh.make_mesh(8, axes=("dp", "sp"))
    sharded = NamedSharding(jmesh, P(None, tuple(jmesh.axis_names)))
    forward = jax_mesh.make_sp_eval_forward(jax_model, jmesh)
    want = forward(
        jax_mesh.replicate(variables, jmesh), *(jax.device_put(jnp.asarray(arrays[k]), sharded)
                                                for k in ("bags", "coords", "key_mask")),
    )  # fmt: skip
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_sequence_collectives_with_autograd(fleet):
    """Each rank checked ``gather_seq`` (bools too), forward and backward,
    against its definition (``_dist_dryrun``'s ``collectives`` job)."""
    _, _, log = fleet
    assert "[0] collectives ok" in log and "[1] collectives ok" in log


def test_bag_not_divisible_by_sp_raises():
    batch = seq.step_batch("vit", 2, 9)
    feed = _mesh_feed(iter([((batch["bags"], batch["coords"], batch["sizes"], batch["targets"]), None)]),
                      Mesh(("sp",), (2,), 0))  # fmt: skip
    with pytest.raises(ValueError, match=r"bag size 9 not divisible by sp=2; pick a divisible bag_size"):
        next(feed)


def test_step_group_draw_keeps_the_ranks_rows_and_tiles():
    """Rank 3 of a ``(dp 2, sp 2)`` mesh holding 1 row of 1 + 3 tokens (CLS,
    then its 3 tiles of 6) keeps row 1 and tokens 0, 4, 5, 6 of the
    unsharded [2, 7, …] draw; without ``seq_dim``, row 1 whole."""

    def draw(shape):
        return torch.arange(int(np.prod(shape))).reshape(tuple(shape))

    group = mesh.step_group(Mesh(("dp", "sp"), (2, 2), 3), 1, sp_axis="sp")
    assert (group.seq_parts, group.seq_index) == (2, 1)
    want = draw((2, 7, 5))[1:2][:, [0, 4, 5, 6]]
    assert torch.equal(group.draw((1, 4, 5), draw, seq_dim=1, lead=1), want)
    assert torch.equal(group.draw((1, 7, 5), draw), draw((2, 7, 5))[1:2])
    # the attention weights' draw: queries (CLS + share) of the whole [T + 1, T + 1]
    want = draw((2, 3, 7, 7))[1:2][:, :, [0, 4, 5, 6]]
    assert torch.equal(group.draw((1, 3, 4, 7), draw, seq_dim=2, lead=1), want)
    assert group.seq_ranks == (2, 3)
