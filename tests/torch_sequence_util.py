"""Shared cases of the port's sequence-parallel tests
(``test_torch_sequence.py`` on 2 ranks, ``test_torch_sequence_dp.py`` on
4): one training step on a ``(dp, sp)`` mesh of gloo ranks
(``parallel._dist_dryrun``'s ``step`` job) from given weights, held

* against the JAX package's ``make_dp_train_step(..., sp_axis="sp")`` on
  the conftest's virtual CPU devices, from the same weights (the port's,
  carried over by ``variables_to_jax``; back by ``variables_from_jax``):
  the loss and every parameter and ALiBi statistic after the step
  (``assert_step``);
* against the port's own single-process step on the whole batch: the loss,
  and every gradient after the all-reduce within ``GRAD_TOL`` of the
  tensor's largest |gradient| (the ranks sum their parts in another
  order).  Adam's first step is lr·sign(gradient), blind to a constant
  factor, so only the gradients can show a gradient counted ``sp`` times.
  The cases with dropout (the ViT's, TransMIL's fixed 0.1, the MLP's) are
  held to the port alone: JAX draws its masks from its own generator, and
  a mesh must draw the single process's masks bit for bit.
"""

from __future__ import annotations

import json
from pathlib import Path

import jax
import numpy as np
import torch

from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu.parallel import mesh as jax_mesh
from stamp_tpu_torch.modeling.train import forward_batch
from stamp_tpu_torch.models import barspoon as torch_barspoon
from stamp_tpu_torch.models import vision_transformer as torch_vit
from stamp_tpu_torch.models import weights
from stamp_tpu_torch.parallel._dist_dryrun import _tensors, batch_of, task_model
from stamp_tpu_torch.parallel.mesh import make_dp_train_step

FEAT = 12
STEP_TOL = 1e-5
UPDATE_TOL = 1e-3
GRAD_TOL = 1e-5
GRAD_FLOOR = 1e-6
TARGETS = {"KRAS": ["mut", "wt"], "BRAF": ["mut", "wt", "other"]}
VIT = dict(dim_model=16, n_layers=2, n_heads=2, dim_feedforward=32)
BARSPOON = dict(d_model=16, num_encoder_heads=2, num_decoder_heads=2, dim_feedforward=32)
WEIGHTS = [0.3, 0.7]

# name: (model_name, feature level, backbone parameters, held to JAX)
STEP_CASES = {
    "vit": ("vit", "tile", dict(VIT, use_alibi=False), True),
    "alibi": ("vit", "tile", dict(VIT, use_alibi=True), True),
    "barspoon": ("barspoon", "tile", BARSPOON, True),
    "alibi_dropout": ("vit", "tile", dict(VIT, use_alibi=True, dropout=0.25), False),
    "vit_dropout": ("vit", "tile", dict(VIT, use_alibi=False, dropout=0.25), False),
    "trans_mil": ("trans_mil", "tile", dict(dim_hidden=16), False),
    "mlp_slide": ("mlp", "slide", dict(dim_hidden=16), False),
    # T = 4,096 tiles + CLS: the flash path (the kernels' plain versions on the CPU)
    "vit_flash": ("vit", "tile", dict(VIT, n_layers=1, use_alibi=False), False),
    "alibi_flash": ("vit", "tile", dict(VIT, n_layers=1, use_alibi=True), False),
}


def step_spec(name: str, mesh_shape: dict) -> dict:
    model_name, feature, params, _ = STEP_CASES[name]
    spec = dict(task="classification", model_name=model_name, feature=feature, dim_input=FEAT, total_steps=4,
                model=params, category_weights=WEIGHTS, mesh_shape=mesh_shape, dropout_seed=7)  # fmt: skip
    if model_name == "barspoon":
        spec["targets"] = TARGETS
    return spec


def step_batch(name: str, rows: int, tiles: int) -> dict[str, np.ndarray]:
    """A global batch as ``inputs.npz`` stores it."""
    model_name, feature, _, _ = STEP_CASES[name]
    rng = np.random.default_rng(11)
    if feature != "tile":
        return {"feats": rng.normal(size=(rows, FEAT)).astype(np.float32),
                "targets": np.eye(2, dtype=np.float32)[np.arange(rows) % 2]}  # fmt: skip
    arrays = {
        "bags": rng.normal(size=(rows, tiles, FEAT)).astype(np.float32),
        "coords": (rng.integers(0, 8, size=(rows, tiles, 2)) * 256.0).astype(np.float32),
        "sizes": np.full((rows,), tiles, np.int32),
    }
    if model_name == "barspoon":
        for t, categories in TARGETS.items():
            arrays[f"targets/{t}"] = np.eye(len(categories), dtype=np.float32)[np.arange(rows) % len(categories)]
    else:
        arrays["targets"] = np.eye(2, dtype=np.float32)[np.arange(rows) % 2]
    return arrays


def _jax_task(name: str):
    model_name, _, params, _ = STEP_CASES[name]
    if model_name == "barspoon":
        return jax_tasks.LitEncDecTransformer(
            dim_input=FEAT, ground_truth_label=list(TARGETS), categories=TARGETS,
            category_weights={t: np.full(len(c), 1 / len(c), np.float32) for t, c in TARGETS.items()},
            model_name="barspoon", **params,
        )  # fmt: skip
    return jax_tasks.LitTileClassifier(
        model_class=JaxViT, dim_input=FEAT, total_steps=4, ground_truth_label="gt", categories=["neg", "pos"],
        category_weights=np.array(WEIGHTS, np.float32), **params,
    )  # fmt: skip


def _from_jax(name: str, variables) -> dict[str, torch.Tensor]:
    if STEP_CASES[name][0] == "barspoon":
        return torch_barspoon.variables_from_jax(variables)
    return torch_vit.variables_from_jax(variables)


def initial_state(name: str, arrays: dict) -> tuple[dict[str, torch.Tensor], object]:
    """The step's initial weights, drawn by the port (``init_weights_``),
    and for the JAX cases the same weights as the JAX module's variables
    (``variables_to_jax``)."""
    model = task_model(step_spec(name, {}))
    weights.init_weights_(model.module, torch.Generator().manual_seed(0))
    state = {k: v.clone() for k, v in model.module.state_dict().items()}
    if not STEP_CASES[name][3]:
        return state, None
    to_jax = torch_barspoon.variables_to_jax if STEP_CASES[name][0] == "barspoon" else torch_vit.variables_to_jax
    return state, to_jax(state)


def jax_step(name: str, variables, arrays: dict, mesh_shape: dict) -> tuple[float, dict[str, torch.Tensor]]:
    """(loss, variables after the step) of the JAX package's step on a
    ``(dp, sp)`` mesh of the virtual CPU devices."""
    model = _jax_task(name)
    shape = (mesh_shape.get("dp", 1), mesh_shape["sp"])
    jmesh = jax_mesh.make_mesh(int(np.prod(shape)), axes=("dp", "sp"), shape=shape)
    tx = model.make_optimizer()
    params = jax_mesh.replicate(variables["params"], jmesh)
    state = jax_mesh.replicate({k: v for k, v in variables.items() if k != "params"}, jmesh)
    opt_state = jax_mesh.replicate(tx.init(variables["params"]), jmesh)
    step, shardings = jax_mesh.make_dp_train_step(model, tx, jmesh, sp_axis="sp")
    new_params, _, new_state, loss = step(
        params, opt_state, state, jax.device_put(batch_of(arrays), shardings), jax.random.PRNGKey(1)
    )
    after = jax.tree_util.tree_map(np.asarray, {"params": new_params, **dict(new_state)})
    return float(loss), _from_jax(name, after)


def first_lr(name: str) -> float:
    """The learning rate of a case's first step."""
    return float(task_model(step_spec(name, {})).lr_schedule()(0))


def single_step(name: str, state: dict, arrays: dict) -> tuple[float, dict, dict]:
    """(loss, state after, gradients) of the port's single-process step on
    the whole batch, with the fleet's dropout generator."""
    spec = step_spec(name, {})
    model = task_model(spec)
    model.module.load_state_dict(state)
    optimizer = model.make_optimizer(model.module.parameters())
    generator = torch.Generator().manual_seed(spec["dropout_seed"])
    step = make_dp_train_step(
        model, optimizer, None, schedule=model.lr_schedule(),
        forward=lambda batch, key_mask, group: forward_batch(
            model, batch, key_mask, torch.device("cpu"), train=True, generator=generator, group=group
        ),
    )  # fmt: skip
    loss, _ = step(_tensors(batch_of(arrays)), None, 0)
    grads = {n: p.grad.detach().clone() for n, p in model.module.named_parameters() if p.grad is not None}
    return float(loss), {k: v.clone() for k, v in model.module.state_dict().items()}, grads


def write_step_job(root: Path, name: str, mesh_shape: dict, rows: int, tiles: int, state: dict) -> dict:
    job = root / name
    job.mkdir(parents=True)
    arrays = step_batch(name, rows, tiles)
    np.savez(job / "inputs.npz", **arrays, **{f"state/{k}": v.numpy() for k, v in state.items()})
    return dict(kind="step", spec=step_spec(name, mesh_shape), dir=str(job))


def jobs_file(root: Path, jobs: list[dict]) -> str:
    path = root / "jobs.json"
    path.write_text(json.dumps(jobs))
    return str(path)


def _parts(name: str, value: np.ndarray) -> list[tuple[str, np.ndarray, bool]]:
    """(name, values, walking) pieces of a tensor: walking where the
    gradient is 0 in exact arithmetic (softmax ignores a shift shared by
    all keys), the attention key biases (the middle third of a fused qkv
    bias)."""
    if name.endswith("in_proj.bias"):
        q, k, v = np.split(value, 3)
        return [(name + "[q]", q, False), (name + "[k]", k, True), (name + "[v]", v, False)]
    return [(name, value, name.endswith("k_proj.bias") or name.endswith(".k.bias"))]


def assert_step(result: dict, want_loss: float, want_state: dict, want_grads: dict | None, lr: float) -> None:
    """The fleet's step against a reference step: the loss, the state after
    it and, with ``want_grads``, the all-reduced gradients (``GRAD_TOL`` of
    each tensor's largest |gradient|, at least ``GRAD_FLOOR`` of the
    model's: a gradient that cancels over the rows, such as the final
    LayerNorm's bias, keeps the rounding of its terms, which another sum
    order moves; the key biases ``GRAD_TOL`` of the model's).  The
    state within ``STEP_TOL`` of each tensor's largest value, or
    ``UPDATE_TOL`` of the step's learning rate ``lr``, whichever is larger:
    Adam's first update is lr·g/(|g| + ε), which turns the rounding of a
    gradient element near ε into a visible share of lr; the key biases
    within 2·lr (Adam's steps on rounding noise)."""
    np.testing.assert_allclose(result["loss"], want_loss, rtol=STEP_TOL)
    got = {k.removeprefix("state/"): v for k, v in result.items() if k.startswith("state/")}
    assert set(got) == set(want_state)
    for name, value in want_state.items():
        for (part, w, walking), (_, g, _) in zip(_parts(name, value.double().numpy()), _parts(name, got[name])):
            if walking:
                assert np.abs(g - w).max() <= 2 * lr, part
            else:
                atol = max(STEP_TOL * np.abs(w).max(), UPDATE_TOL * lr)
                np.testing.assert_allclose(g, w, rtol=STEP_TOL, atol=atol, err_msg=part)
    if want_grads is None:
        return
    grads = {k.removeprefix("grad/"): v for k, v in result.items() if k.startswith("grad/")}
    assert set(grads) == set(want_grads)
    scale = max(float(g.abs().max()) for g in want_grads.values())
    for name, value in want_grads.items():
        for (part, w, walking), (_, g, _) in zip(_parts(name, value.double().numpy()), _parts(name, grads[name])):
            limit = GRAD_TOL * scale if walking else max(GRAD_TOL * np.abs(w).max(), GRAD_FLOOR * scale)
            assert np.abs(g - w).max() <= limit, (part, np.abs(g - w).max(), limit)
