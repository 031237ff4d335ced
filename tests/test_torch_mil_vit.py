"""The port's MIL ViT (stamp_tpu_torch.models.vision_transformer) against the
JAX module on the same masked bag and the same weights, carried across with
``variables_from_jax``; both attention variants, once on the einsum path and
once with the flash wrappers taken (their plain versions on the CPU); and
the ALiBi model's training steps and distance statistic against the
benchmark's plain reference (``benchmark/reference/mil_vit_alibi.py``) and
a float64 sum."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu_torch.models import vision_transformer as torch_vit
from stamp_tpu_torch.ops import flash_attention

_DIMS = dict(dim_output=3, dim_input=24, dim_model=32, n_layers=2, n_heads=4, dim_feedforward=48)
ATOL = 1e-5  # logits, f32 on both sides


def _bag(seed: int = 0, tiles: int = 40, valid: int = 29):
    rng = np.random.default_rng(seed)
    bags = rng.normal(size=(1, tiles, _DIMS["dim_input"])).astype(np.float32)
    coords = (rng.integers(0, 12, size=(1, tiles, 2)) * 256.0).astype(np.float32)
    key_mask = np.arange(tiles)[None, :] < valid
    return bags, coords, key_mask


def _jax_variables(use_alibi: bool, bags, coords, key_mask) -> dict:
    module = JaxViT(**_DIMS, use_alibi=use_alibi)
    variables = module.init(jax.random.PRNGKey(0), jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    variables = jax.tree_util.tree_map(np.asarray, jax.device_get(dict(variables)))
    if use_alibi:
        # running mean ≈ mean distance × tiles: the post-softmax bias is then
        # as large as the softmax weights, so neither branch hides the other
        for i in range(_DIMS["n_layers"]):
            variables["alibi_stats"][f"block_{i}"]["mhsa"]["running_mean"] = np.full(
                _DIMS["n_heads"], 1500.0 * 40, np.float32
            )
    return variables


def _jax_logits(use_alibi: bool, variables, bags, coords, key_mask) -> np.ndarray:
    module = JaxViT(**_DIMS, use_alibi=use_alibi)
    out = module.apply(variables, jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask))
    return np.asarray(out)


def _torch_model(use_alibi: bool, variables) -> torch_vit.VisionTransformer:
    model = torch_vit.VisionTransformer(**_DIMS, use_alibi=use_alibi)
    model.load_state_dict(torch_vit.variables_from_jax(variables))
    return model.eval()


def _torch_logits(model, bags, coords, key_mask) -> np.ndarray:
    with torch.inference_mode():
        out = model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask))
    return out.numpy()


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_mil_vit_matches_jax(use_alibi, path, monkeypatch):
    bags, coords, key_mask = _bag()
    variables = _jax_variables(use_alibi, bags, coords, key_mask)
    want = _jax_logits(use_alibi, variables, bags, coords, key_mask)

    calls = []
    name = "flash_alibi_mha" if use_alibi else "flash_mha"
    wrapper = getattr(flash_attention, name)
    monkeypatch.setattr(flash_attention, name, lambda *a: calls.append(a[0].shape) or wrapper(*a))
    if path == "flash":
        monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    got = _torch_logits(_torch_model(use_alibi, variables), bags, coords, key_mask)

    # 41 tokens (CLS + 40 tiles) × 4 heads of one bag per layer
    assert calls == ([(4, 41, 8)] * 2 if path == "flash" else [])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_padding_keys_do_not_change_the_logits():
    """A bag padded with masked zero tiles gives the unpadded bag's logits."""
    bags, coords, key_mask = _bag(tiles=29, valid=29)
    variables = _jax_variables(True, bags, coords, key_mask)
    model = _torch_model(True, variables)
    pad = ((0, 0), (0, 11), (0, 0))
    padded = _torch_logits(model, np.pad(bags, pad), np.pad(coords, pad), np.arange(40)[None] < 29)
    np.testing.assert_allclose(padded, _torch_logits(model, bags, coords, key_mask), atol=ATOL, rtol=0)


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_variables_round_trip_exactly(use_alibi):
    bags, coords, key_mask = _bag()
    variables = _jax_variables(use_alibi, bags, coords, key_mask)
    back = torch_vit.variables_to_jax(_torch_model(use_alibi, variables).state_dict())
    flat = jax.tree_util.tree_leaves_with_path(variables)
    back_flat = jax.tree_util.tree_leaves_with_path(back)
    assert [p for p, _ in flat] == [p for p, _ in back_flat]
    for (path, a), (_, b) in zip(flat, back_flat):
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("use_alibi", [False, True], ids=["vit", "alibi"])
def test_collected_attention_matches_jax(use_alibi):
    """What the JAX module sows for heatmaps (per layer q, k and, with
    ``sow_weights``, the masked softmax maps) equals what the port collects
    into ``intermediates``, and the logits stay the JAX module's."""
    bags, coords, key_mask = _bag()
    variables = _jax_variables(use_alibi, bags, coords, key_mask)
    out, state = JaxViT(**_DIMS, use_alibi=use_alibi).apply(
        variables, jnp.asarray(bags), coords=jnp.asarray(coords), key_mask=jnp.asarray(key_mask),
        sow_weights=True, mutable=["intermediates"],
    )  # fmt: skip
    model = _torch_model(use_alibi, variables)
    inter: dict = {}
    with torch.inference_mode():
        got = model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask),
                    sow_weights=True, intermediates=inter)  # fmt: skip
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL, rtol=0)
    assert sorted(inter) == [f"block_{i}" for i in range(_DIMS["n_layers"])]
    for block, collected in inter.items():
        sown = state["intermediates"][block]["mhsa"]
        assert sorted(collected) == ["attn_k", "attn_q", "attn_weights"]
        for name, value in collected.items():
            np.testing.assert_allclose(value.numpy(), np.asarray(sown[name][0]), atol=ATOL, rtol=0)
    # q and k alone without sow_weights
    inter = {}
    with torch.inference_mode():
        model(torch.from_numpy(bags), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask),
              intermediates=inter)  # fmt: skip
    assert all(sorted(c) == ["attn_k", "attn_q"] for c in inter.values())


def test_inference_only():
    """Attention maps need a dict to go into (``sow_weights`` without one
    raises); the training forward runs (tests/test_torch_train.py holds it
    against the JAX module) and updates the ALiBi statistics once."""
    model = torch_vit.VisionTransformer(**_DIMS, use_alibi=True)
    bags, coords, key_mask = (torch.from_numpy(a) for a in _bag())
    with pytest.raises(ValueError, match="intermediates"):
        model(bags, coords=coords, key_mask=key_mask, sow_weights=True)
    out = model(bags, coords=coords, key_mask=key_mask, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(out).all() and out.requires_grad
    assert float(model.block_0.mhsa.items_so_far[0]) == 2.0
    with pytest.raises(ValueError, match="generator"):  # dropout never silently off
        torch_vit.VisionTransformer(**_DIMS, dropout=0.1)(bags, coords=coords, key_mask=key_mask, train=True)


def test_init_random_weights_is_seeded():
    a, b = (
        torch_vit.init_random_weights_(torch_vit.VisionTransformer(**_DIMS, use_alibi=True), torch.Generator().manual_seed(7))
        for _ in range(2)
    )
    for (name, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(x, y), name
    assert float(a.block_0.mhsa.running_mean[0]) == 1.0
    bias_scale = a.block_0.mhsa.bias_scale.detach()
    assert 0.0 <= float(bias_scale.min()) and float(bias_scale.max()) < 1.0


def test_training_dropout_draws_from_the_generator():
    """With dropout, a training forward depends on the generator's draws
    (equal seeds give equal logits) and differs from the eval forward."""
    model = torch_vit.VisionTransformer(**_DIMS, dropout=0.5)
    bags, coords, key_mask = (torch.from_numpy(a) for a in _bag())

    def run(seed):
        return model(bags, coords=coords, key_mask=key_mask, train=True, generator=torch.Generator().manual_seed(seed))

    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.equal(run(3), run(4))
    assert not torch.equal(run(3), model(bags, coords=coords, key_mask=key_mask))


# --- the spatial-ALiBi model's training steps against the benchmark's plain reference ---

_ALIBI_TRAIN = dict(dim_input=24, dim_model=32, n_layers=2, n_heads=4, dim_feedforward=48, dropout=0.25)
_ALIBI_CONFIG = dict(_ALIBI_TRAIN, norm_eps=1e-6)
_SCHEDULE = dict(total_steps=20, max_lr=1e-3, div_factor=25.0)
_CLASS_WEIGHTS = np.array([0.4, 0.6], np.float32)


def _alibi_task():
    from stamp_tpu_torch.modeling.tasks import LitTileClassifier

    task = LitTileClassifier(
        model_class=torch_vit.VisionTransformer, ground_truth_label="label", categories=["0", "1"],
        category_weights=_CLASS_WEIGHTS, total_steps=_SCHEDULE["total_steps"], max_lr=_SCHEDULE["max_lr"],
        div_factor=_SCHEDULE["div_factor"], use_alibi=True, **_ALIBI_TRAIN,
    )  # fmt: skip
    torch_vit.init_random_weights_(task.module, torch.Generator().manual_seed(11))
    return task


def _alibi_batches(padded: bool, tiles=(300, 211, 257)):
    """Whole-slide batches of one bag each: padded to a bucket of 512 with a
    key mask, or unpadded without one; coordinates on a 224 µm grid."""
    rng = np.random.default_rng(5)
    out = []
    for i, n in enumerate(tiles):
        t = 512 if padded else n
        bags = np.zeros((1, t, _ALIBI_TRAIN["dim_input"]), np.float32)
        bags[0, :n] = rng.normal(size=(n, _ALIBI_TRAIN["dim_input"]))
        grid = np.arange(t)
        coords = np.stack([grid % 20, grid // 20], axis=-1)[None].astype(np.float32) * 224.0
        coords[0, n:] = 0.0
        targets = np.eye(2, dtype=np.float32)[[i % 2]]
        key_mask = (np.arange(t) < n)[None] if padded else None
        out.append(((torch.from_numpy(bags), torch.from_numpy(coords), np.array([n]), torch.from_numpy(targets)),
                    None if key_mask is None else torch.from_numpy(key_mask), n))  # fmt: skip
    return out


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
@pytest.mark.parametrize("path", ["einsum", "flash"])
def test_alibi_training_steps_match_the_reference(padded, path, monkeypatch):
    """Three whole-slide steps of the port's ALiBi ``vit`` (``LitTileClassifier``,
    ``make_dp_train_step`` with ``forward_batch``, dropout 0.25) against
    ``benchmark/reference/mil_vit_alibi.py`` in blocks of 64 queries, on the
    same seeded weights, bags and dropout draws: each step's loss and
    gradient, the running means and ``items_so_far``, and AdamW's moments
    after the last step.  Both sides are plain float32 on the CPU; the
    tolerances hold float32's rounding over a few hundred tokens (the port
    sums the distance statistic in float32 and forms the ALiBi term apart from
    the softmax, the reference in float64 and as one matrix)."""
    from benchmark.reference import mil_vit_alibi as reference
    from stamp_tpu_torch.modeling.train import forward_batch
    from stamp_tpu_torch.parallel.mesh import make_dp_train_step

    if path == "flash":
        monkeypatch.setattr(torch_vit, "FLASH_ATTENTION_MIN_SEQ", 16)
    task = _alibi_task()
    state = {k: v.detach().clone() for k, v in task.module.state_dict().items()}
    optimizer = task.make_optimizer(task.module.parameters())
    generator = torch.Generator().manual_seed(13)
    step = make_dp_train_step(
        task, optimizer, None, schedule=task.lr_schedule(),
        forward=lambda batch, key_mask, group: forward_batch(task, batch, key_mask, torch.device("cpu"), train=True,
                                                             generator=generator, group=group),
    )  # fmt: skip
    params = dict(task.module.named_parameters())
    batches = _alibi_batches(padded)
    losses, grads, before = [], [], {k: torch.zeros_like(p) for k, p in params.items()}
    for count, (batch, key_mask, _n) in enumerate(batches):
        loss, _ = step(batch, key_mask, count)
        losses.append(float(loss))
        after = {k: optimizer.state[p]["exp_avg"].clone() for k, p in params.items()}
        grads.append({k: (after[k] - 0.9 * before[k]) / 0.1 for k in params})
        before = after

    ref_batches = [(b[0][:, :n], b[1][:, :n], b[3], b[0].shape[1]) for b, _k, n in batches]
    ref = reference.train(state, ref_batches, torch.from_numpy(_CLASS_WEIGHTS), _ALIBI_CONFIG, _SCHEDULE,
                          generator=torch.Generator().manual_seed(13), block=64)  # fmt: skip
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    for got, want in zip(grads, ref["grads"]):
        for k in params:
            scale = float(want[k].abs().max())
            assert float((got[k] - want[k]).abs().max()) <= 1e-4 * max(scale, 1e-3), k
    buffers = dict(task.module.named_buffers())
    for k, want in ref["buffers"].items():
        torch.testing.assert_close(buffers[k], want, rtol=1e-5, atol=0)
    assert float(buffers["block_1.mhsa.items_so_far"][0]) == 1.0 + len(batches)
    for key, moment in zip(("exp_avg", "exp_avg_sq"), ref["moments"]):
        largest = max(float(m.abs().max()) for m in moment.values())  # a key's bias moves by rounding alone
        for k, p in params.items():
            scale = max(float(moment[k].abs().max()), 1e-3 * largest)
            assert float((optimizer.state[p][key] - moment[k]).abs().max()) <= 1e-4 * scale, (key, k)


def test_alibi_statistic_is_computed_once_a_training_forward(monkeypatch):
    """One statistic a training forward, handed to every layer, and none
    outside training; while recording, the ``train/alibi_stats`` span and the
    ``train/alibi_pairs`` count (Σ (tiles + 1)² from the host's sizes)."""
    from stamp_tpu_torch.modeling.train import forward_batch
    from stamp_tpu_torch.utils import profiling

    calls = []
    statistic = torch_vit.pairwise_distance_sums
    monkeypatch.setattr(torch_vit, "pairwise_distance_sums", lambda *a, **k: calls.append(1) or statistic(*a, **k))
    task = _alibi_task()
    (batch, key_mask, n), = _alibi_batches(True, tiles=(300,))
    monkeypatch.setattr(profiling.timer, "enabled", True)
    profiling.timer.reset()
    try:
        generator = torch.Generator().manual_seed(0)
        forward_batch(task, batch, key_mask, torch.device("cpu"), train=True, generator=generator)
        records = profiling.records()
    finally:
        profiling.timer.reset()
    assert len(calls) == 1
    assert [r.name for r in records if hasattr(r, "self_ns")] == ["train/alibi_stats"]
    assert {r.name: r.n for r in records if hasattr(r, "n")}["train/alibi_pairs"] == (n + 1) ** 2
    assert float(task.module.block_0.mhsa.items_so_far[0]) == float(task.module.block_1.mhsa.items_so_far[0]) == 2.0
    torch.testing.assert_close(task.module.block_0.mhsa.running_mean, task.module.block_1.mhsa.running_mean)
    with torch.no_grad():
        forward_batch(task, batch, key_mask, torch.device("cpu"))
    assert len(calls) == 1


def _f64_pair_sums(rows, row_valid, keys, key_valid):
    """The statistic's numerator and denominator in float64 with numpy, pair by pair."""
    d = np.sqrt(((rows[:, :, None, :] - keys[:, None, :, :]) ** 2).sum(-1))
    w = row_valid[:, :, None] & key_valid[:, None, :]
    return float((d * w).sum()), int(w.sum())


@pytest.mark.parametrize("form", ["unmasked", "masked", "sp-share"])
def test_pairwise_distance_sums_cpu_path_matches_a_float64_sum(form):
    """The CPU path (row blocks of 512, float32) against a float64 sum over
    every pair: 2 bags of 1,100 tokens on a 224 µm grid (distances up to
    ~9,000 µm, 2.4 M pairs): float32 sums of a few thousand terms per block
    round to ~1e-6 of the total, so 1e-5 holds them."""
    from stamp_tpu_torch.ops.attention import pairwise_distance_sums

    rng = np.random.default_rng(3)
    t = 1100
    coords = (np.stack([np.arange(t) % 40, np.arange(t) // 40], -1) * 224.0)[None].repeat(2, 0).astype(np.float32)
    coords += rng.normal(scale=30.0, size=coords.shape).astype(np.float32)
    valid = np.ones((2, t), bool) if form == "unmasked" else np.arange(t)[None] < np.array([[900], [1100]])
    kwargs = {} if form == "unmasked" else {"mask": torch.from_numpy(valid)}
    rows, row_valid = coords, valid
    if form == "sp-share":  # a rank's share of the rows against the whole sequence's keys
        rows, row_valid = coords[:, 300:700], valid[:, 300:700]
        kwargs = {"mask": torch.from_numpy(row_valid.copy()), "coords_k": torch.from_numpy(coords),
                  "key_mask": torch.from_numpy(valid)}  # fmt: skip
    total, n_pairs = pairwise_distance_sums(torch.from_numpy(np.ascontiguousarray(rows)), **kwargs)
    want_total, want_pairs = _f64_pair_sums(rows.astype(np.float64), row_valid, coords.astype(np.float64), valid)
    assert float(n_pairs) == want_pairs
    assert abs(float(total) - want_total) <= 1e-5 * want_total
