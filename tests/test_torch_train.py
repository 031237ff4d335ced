"""Training in the port (``stamp_tpu_torch.modeling.{tasks,train}``, the MIL
ViT's training forward and the flash backward) against the JAX package on
the CPU, from the same weights and the same numpy inputs:

* the one-cycle schedule against optax at every step, AdamW against
  ``optax.adamw``;
* one training step of the MIL ViT (vit and ALiBi) with the flash
  autograd Functions taken, against ``jax.value_and_grad``: loss, every
  gradient and the ALiBi statistics after the step;
* ``train`` through both CLIs (``accelerator: cpu``, ``seed: 0``), the
  port's initial weights set to the JAX package's: the same split, the
  same ``metrics.csv`` values and the same final parameters; and the two
  packages' checkpoints deploy in each other.
"""

import logging
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
import yaml

from random_data import create_random_dataset, create_random_regression_dataset, create_random_survival_dataset
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu_torch.modeling import tasks, train
from stamp_tpu_torch.modeling.checkpoint import load_checkpoint
from stamp_tpu_torch.models import vision_transformer as torch_vit

FEAT_DIM = 16
_VIT = dict(dim_model=32, n_layers=2, n_heads=4, dim_feedforward=32, dropout=0.0)
_VIT_KEYS = slice(32, 64)  # the key part of the fused qkv bias


@pytest.fixture(autouse=True)
def stamp_logger_handlers():
    """Drop the log handlers the CLI runs add to the shared "stamp" logger."""
    logger = logging.getLogger("stamp")
    before = list(logger.handlers)
    yield
    for handler in logger.handlers[:]:
        if handler not in before:
            logger.removeHandler(handler)
            handler.close()


def _assert_close(got, want, rtol: float, what: str = "") -> None:
    """Relative to each element, with a floor of rtol·max|want| for elements
    that cancel to near zero."""
    want = np.asarray(want, dtype=np.float64)
    got = np.asarray(got, dtype=np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(np.abs(want).max(), 1e-30), err_msg=what)


# --- schedule and optimizer ----------------------------------------------------


@pytest.mark.parametrize("total_steps", [1, 7, 512])
def test_lr_schedule_matches_optax(total_steps):
    want = optax.cosine_onecycle_schedule(
        transition_steps=total_steps, peak_value=1e-4, pct_start=0.3, div_factor=25.0, final_div_factor=1e4
    )
    model = tasks.LitTileRegressor(
        model_class=torch_vit.VisionTransformer, dim_input=FEAT_DIM, total_steps=total_steps, **_VIT
    )
    got = model.lr_schedule()
    for count in range(total_steps + 3):
        w, g = float(want(count)), got(count)
        if np.isnan(w):  # at T = 1 optax's first segment is empty: NaN everywhere
            assert np.isnan(g), count
        else:
            assert abs(g - w) <= 1e-7 * abs(w), (count, g, w)


def test_adamw_matches_optax():
    """Three AdamW steps on the same parameters and gradients, the learning
    rate read from the schedule before each step as the engine does."""
    rng = np.random.default_rng(0)
    params = {"w": rng.normal(size=(5, 3)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) for k, v in params.items()} for _ in range(3)]
    model = tasks.LitTileRegressor(model_class=torch_vit.VisionTransformer, dim_input=FEAT_DIM, total_steps=7, max_lr=1e-2, **_VIT)

    tx = optax.adamw(
        optax.cosine_onecycle_schedule(7, 1e-2, 0.3, 25.0, 1e4), b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-2
    )
    jax_params = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jax_params)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    optimizer = model.make_optimizer(torch_params.values())
    schedule = model.lr_schedule()
    for step, g in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jax_params)
        jax_params = optax.apply_updates(jax_params, updates)
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        for group in optimizer.param_groups:
            group["lr"] = schedule(step)
        optimizer.step()
    for k in params:
        _assert_close(torch_params[k].detach().numpy(), jax_params[k], 1e-6, k)


# --- one training step of the MIL ViT ------------------------------------------------


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_one_training_step_matches_jax(use_alibi, monkeypatch):
    """Two masked bags of 40 tiles; the port's ``FLASH_ATTENTION_MIN_SEQ``
    lowered to 16 so that both layers take the flash autograd Functions
    (plain versions on the CPU), the JAX module its einsum path."""
    rng = np.random.default_rng(1)
    dims = dict(dim_output=2, dim_input=FEAT_DIM, use_alibi=use_alibi, **_VIT)
    bags = rng.normal(size=(2, 40, FEAT_DIM)).astype(np.float32)
    coords = (rng.integers(0, 12, size=(2, 40, 2)) * 256.0).astype(np.float32)
    key_mask = np.arange(40)[None, :] < np.array([[29], [40]])
    targets = np.eye(2, dtype=np.float32)[[0, 1]]
    weights = np.array([0.3, 0.7], np.float32)

    module = JaxViT(**dims)
    variables = jax.tree_util.tree_map(
        np.asarray, dict(module.init(jax.random.PRNGKey(0), jnp.asarray(bags), coords=jnp.asarray(coords)))
    )
    if use_alibi:  # about the bag's mean distance: the bias weighs like the softmax
        for block in variables["alibi_stats"].values():
            block["mhsa"]["running_mean"] = np.full(_VIT["n_heads"], 1500.0, np.float32)
    state = {k: v for k, v in variables.items() if k != "params"}

    def jax_loss(params):
        logits, mutated = module.apply(
            {"params": params, **state}, jnp.asarray(bags), coords=jnp.asarray(coords),
            key_mask=jnp.asarray(key_mask), train=True, mutable=["alibi_stats"],
        )  # fmt: skip
        return jax_tasks.weighted_cross_entropy(logits, jnp.asarray(targets), jnp.asarray(weights)), mutated

    (want_loss, mutated), want_grads = jax.value_and_grad(jax_loss, has_aux=True)(variables["params"])

    monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    model = torch_vit.VisionTransformer(**dims)
    model.load_state_dict(torch_vit.variables_from_jax(variables))
    logits = model(
        torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask),
        train=True, generator=torch.Generator().manual_seed(0),
    )  # fmt: skip
    loss = tasks.weighted_cross_entropy(logits, torch.from_numpy(targets), torch.from_numpy(weights))
    loss.backward()

    _assert_close(loss.detach(), want_loss, 1e-5, "loss")
    want = torch_vit.variables_from_jax({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    got = dict(model.named_parameters())
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, grad in want.items():
        if name.endswith("k_proj.bias"):
            # softmax ignores a shift shared by all keys: this gradient is 0
            # in exact arithmetic and rounding noise on both sides
            assert max(float(np.abs(grad).max()), float(got[name].grad.abs().max())) <= 1e-6 * scale, name
        else:
            _assert_close(got[name].grad, grad, 1e-5, name)
    if use_alibi:
        after = torch_vit.variables_from_jax({"alibi_stats": jax.tree_util.tree_map(np.asarray, mutated["alibi_stats"])})
        for name, value in after.items():
            _assert_close(model.get_buffer(name), value, 1e-6, name)
        assert float(model.block_0.mhsa.items_so_far[0]) == 2.0


# --- train through both CLIs ------------------------------------------------------------


def _cohort(tmp_path, task: str):
    import random

    random.seed(0)
    np.random.seed(0)
    kwargs = dict(
        dir=tmp_path, n_patients=12, feat_dim=FEAT_DIM, max_slides_per_patient=1,
        min_tiles_per_slide=6, max_tiles_per_slide=30,
    )  # fmt: skip
    if task == "classification":
        return create_random_dataset(categories=["high", "low"], **kwargs)[:3]
    if task == "regression":
        return create_random_regression_dataset(**kwargs)[:3]
    return create_random_survival_dataset(**kwargs)[:3]


_LABELS = {
    "classification": {"ground_truth_label": "ground-truth"},
    "regression": {"ground_truth_label": "target"},
    "survival": {"time_label": "day", "status_label": "status"},
}


def _train_config(tmp_path, name, task, cohort, *, use_alibi, bag_size, section="training", **extra) -> str:
    clini, slide, feats = cohort
    body = {
        "output_dir": str(tmp_path / name),
        "clini_table": str(clini),
        "slide_table": str(slide),
        "feature_dir": str(feats),
        "patient_label": "patient",
        "filename_label": "slide_path",
        "task": task,
        **_LABELS[task],
        **extra,
    }
    advanced = {
        "bag_size": bag_size,
        "batch_size": 4,
        "max_epochs": 2,
        "num_workers": 1,
        "accelerator": "cpu",
        "seed": 0,
        "max_lr": 1e-3,
        "model_params": {"vit": {**_VIT, "use_alibi": use_alibi}},
    }
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump({section: body, "advanced_config": advanced}))
    return str(path)


def _run_both(tmp_path, monkeypatch, command, task, cohort, *, use_alibi, bag_size, **extra):
    """``command`` through the JAX CLI, then the port's; the port starts from
    the JAX package's initial variables (recorded as it computes them)."""
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    initial: list = []
    jax_init = jax_tasks.TaskModel.init_variables

    def record_init(self, rng, example):
        variables = jax_init(self, rng, example)
        initial.append(jax.tree_util.tree_map(np.asarray, dict(variables)))
        return variables

    monkeypatch.setattr(jax_tasks.TaskModel, "init_variables", record_init)
    jax_cfg = _train_config(tmp_path, "jax", task, cohort, use_alibi=use_alibi, bag_size=bag_size, **extra)
    monkeypatch.setattr(sys, "argv", ["stamp", "-c", jax_cfg, command])
    jax_main()

    def init_from_jax(model):
        model.module.load_state_dict(torch_vit.variables_from_jax(initial.pop(0)))

    monkeypatch.setattr(train, "_init_module", init_from_jax)
    torch_cfg = _train_config(tmp_path, "torch", task, cohort, use_alibi=use_alibi, bag_size=bag_size, **extra)
    torch_main(["-c", torch_cfg, command])
    assert not initial  # every fold started from its JAX initial variables
    return tmp_path / "jax", tmp_path / "torch"


def _assert_same_run(jax_dir, torch_dir) -> None:
    """Split, metrics.csv (1e-4 relative) and final parameters (1e-4).

    Parameters whose gradient is zero in exact arithmetic do not change any
    output and are driven by rounding noise, which Adam turns into steps of
    up to ±lr in either package: the key bias (softmax ignores a shift
    shared by all keys), and in survival the head bias and the final
    LayerNorm's bias (the Cox loss ignores a shift shared by all risk
    scores, and these two only shift them), which move ``train_pred_median``
    with them.  The key bias is left out; the two biases of a survival run
    are held to 2·Σ lr, the farthest two runs can walk apart on such a
    parameter, and the median to the shift they can make, 2·Σ lr·(1 +
    ‖head weight‖₁)."""
    want_ckpt = load_checkpoint(jax_dir / "model.ckpt")
    got_ckpt = load_checkpoint(torch_dir / "model.ckpt")
    hparams = want_ckpt["hyper_parameters"]
    for key in ("train_patients", "valid_patients"):
        assert got_ckpt["hyper_parameters"][key] == hparams[key], key
    assert set(got_ckpt["hyper_parameters"]) == set(hparams)
    survival = hparams["task"] == "survival"
    schedule = tasks.cosine_onecycle_schedule(hparams["total_steps"], hparams["max_lr"], 0.3, hparams["div_factor"])
    want_vars = torch_vit.variables_from_jax(want_ckpt["variables"])
    got_vars = torch_vit.variables_from_jax(got_ckpt["variables"])
    shift = 1.0 + float(np.abs(want_vars["head.weight"]).sum(axis=1).max())

    want = pd.read_csv(jax_dir / "lightning_logs/version_0/metrics.csv")
    got = pd.read_csv(torch_dir / "lightning_logs/version_0/metrics.csv")
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for column in want.columns:
        if survival and column == "train_pred_median":
            walk = [2 * shift * sum(schedule(i) for i in range(int(step))) for step in want["step"]]
            assert (np.abs(got[column] - want[column]) <= walk).all(), (got[column], want[column], walk)
        else:
            _assert_close(got[column].to_numpy(), want[column].to_numpy(), 1e-4, column)
    walk = 2 * sum(schedule(i) for i in range(int(want["step"].iloc[-1])))

    assert set(got_vars) == set(want_vars)
    for name, value in want_vars.items():
        got = got_vars[name]
        # the key bias does not change any output (softmax ignores a shift
        # shared by all keys): its gradient is rounding noise, which Adam
        # turns into steps of ±lr in either package; it is left out
        if name.endswith("in_proj.bias"):
            value, got = np.delete(value, _VIT_KEYS, axis=0), np.delete(got, _VIT_KEYS, axis=0)
        elif name.endswith("k_proj.bias"):
            continue
        elif survival and name in ("head.bias", "norm.bias"):
            assert np.abs(got - value).max() <= walk, name
            continue
        _assert_close(got, value, 1e-4, name)


@pytest.mark.parametrize(
    "task,use_alibi,bag_size",
    [
        ("classification", False, 8),
        ("classification", True, None),
        ("regression", True, 8),
        ("regression", False, None),
        ("survival", False, None),
        ("survival", True, 8),
    ],
)
def test_train_matches_jax_cli(tmp_path, monkeypatch, task, use_alibi, bag_size):
    cohort = _cohort(tmp_path, task)
    jax_dir, torch_dir = _run_both(tmp_path, monkeypatch, "train", task, cohort, use_alibi=use_alibi, bag_size=bag_size)
    _assert_same_run(jax_dir, torch_dir)


def test_whole_slide_training_takes_the_flash_backward(tmp_path, monkeypatch):
    """``bag_size: null`` with the port's flash threshold lowered to 16: the
    port trains through the flash autograd Functions (streamed ALiBi mean
    on the flash path), the JAX package through its einsum path, with the
    same results."""
    from stamp_tpu_torch.ops import flash_attention

    calls = []
    backward = flash_attention._flash_alibi_backward
    monkeypatch.setattr(flash_attention, "_flash_alibi_backward", lambda *a: calls.append(1) or backward(*a))
    monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    cohort = _cohort(tmp_path, "classification")
    jax_dir, torch_dir = _run_both(
        tmp_path, monkeypatch, "train", "classification", cohort, use_alibi=True, bag_size=None
    )
    _assert_same_run(jax_dir, torch_dir)
    # 9 training patients, one a step, 2 epochs, 2 layers
    assert len(calls) == 9 * 2 * 2


def test_checkpoints_deploy_across_packages(tmp_path, monkeypatch):
    """The port's model.ckpt deploys in ``python -m stamp_tpu`` and the JAX
    package's in the port, with the predictions of the other package."""
    from stamp_tpu.__main__ import main as jax_main
    from stamp_tpu_torch.__main__ import main as torch_main

    cohort = _cohort(tmp_path, "classification")
    jax_dir, torch_dir = _run_both(
        tmp_path, monkeypatch, "train", "classification", cohort, use_alibi=True, bag_size=8
    )
    clini, slide, feats = cohort
    for package, main, ckpt_dir in (("jax", None, torch_dir), ("torch", torch_main, jax_dir)):
        for runner in ("jax", "torch"):
            config = tmp_path / f"deploy-{package}-{runner}.yaml"
            config.write_text(yaml.safe_dump({"deployment": {
                "output_dir": str(tmp_path / f"deploy-{package}-{runner}"),
                "checkpoint_paths": [str(ckpt_dir / "model.ckpt")], "clini_table": str(clini),
                "slide_table": str(slide), "feature_dir": str(feats), "patient_label": "patient",
                "filename_label": "slide_path", "ground_truth_label": "ground-truth", "accelerator": "cpu",
            }}))  # fmt: skip
            if runner == "jax":
                monkeypatch.setattr(sys, "argv", ["stamp", "-c", str(config), "deploy"])
                jax_main()
            else:
                torch_main(["-c", str(config), "deploy"])
        want = pd.read_csv(tmp_path / f"deploy-{package}-jax/patient-preds.csv").sort_values("patient")
        got = pd.read_csv(tmp_path / f"deploy-{package}-torch/patient-preds.csv").sort_values("patient")
        assert list(got.columns) == list(want.columns) and len(got) == 12
        for column in ("ground-truth_high", "ground-truth_low"):
            np.testing.assert_allclose(got[column], want[column], atol=1e-5, rtol=0)
