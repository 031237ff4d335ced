"""The port's MIL backbones other than the ViT (``models/mlp.py``,
``models/trans_mil.py``, ``models/barspoon.py``) against the JAX package's
on the same seeded numpy inputs, the weights carried across with
``models.weights``:

* forward parity within 1e-5 of max |JAX| (f32 on both sides): MLP and
  Linear on slide vectors and tile bags; TransMIL on ragged bags that are
  neither a multiple of the landmarks nor one less than a square, with its
  landmark softmax and its pseudo-inverse also held alone; barspoon with two
  targets and a key mask, the positional encoding on and off, and the
  encoding alone against an f64 reference at µm coordinates up to 1e5;
* one deterministic training step (dropout off, or TransMIL's forward
  without it): the loss within 1e-5 and every gradient within 1e-4 of its
  max |JAX|;
* the JAX npz ``model.ckpt`` of each of the five backbones loads into the
  port, and the port's tree loads back bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stamp_tpu.modeling import tasks as jax_tasks
from stamp_tpu.models import barspoon as jax_barspoon
from stamp_tpu.models import mlp as jax_mlp
from stamp_tpu.models import trans_mil as jax_trans_mil
from stamp_tpu.models.vision_transformer import VisionTransformer as JaxViT
from stamp_tpu_torch.modeling import tasks
from stamp_tpu_torch.models import barspoon, mlp, trans_mil, vision_transformer, weights

FEAT_DIM = 32
REL_TOL = 1e-5  # max |Δ| / max |JAX|, f32 on both sides
GRAD_TOL = 1e-4  # per gradient, of its max |JAX|: a backward through ~10 f32 layers
_TARGETS = (("KRAS status", 2), ("grade", 3))
_BARSPOON = dict(d_model=32, num_encoder_heads=4, num_decoder_heads=4, num_encoder_layers=2,
                 num_decoder_layers=1, dim_feedforward=48)  # fmt: skip


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _tree(variables) -> dict:
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _init(module, *args, seed: int = 0, **kwargs) -> dict:
    """The JAX module's variables (jitted: flax's eager dispatch is slow)."""
    return _tree(jax.jit(lambda a, k: module.init(jax.random.PRNGKey(seed), *a, **k))(args, kwargs))


def _apply(module, variables, *args, **kwargs):
    return jax.jit(lambda v, a, k: module.apply(v, *a, **k))(variables, args, kwargs)


def _bags(seed: int, n_tiles: int, batch: int = 2):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(batch, n_tiles, FEAT_DIM)).astype(np.float32)
    coords = rng.uniform(0, 1e5, size=(batch, n_tiles, 2)).astype(np.float32)  # µm, up to 10 cm
    key_mask = np.arange(n_tiles)[None, :] < np.array([[n_tiles], [n_tiles - 9]])[:batch]
    return feats, coords, key_mask


# --- MLP and Linear ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mlp", "linear"])
@pytest.mark.parametrize("shape", [(5, FEAT_DIM), (3, 11, FEAT_DIM)], ids=["slide", "tile"])
def test_mlp_and_linear_forward(kind, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    if kind == "mlp":
        jax_module, port = jax_mlp.MLP(dim_output=3, dim_input=FEAT_DIM, dim_hidden=24, num_layers=3), mlp.MLP
        dims = dict(dim_hidden=24, num_layers=3)
    else:
        jax_module, port, dims = jax_mlp.Linear(dim_output=3, dim_input=FEAT_DIM), mlp.Linear, {}
    variables = _tree(jax_module.init(jax.random.PRNGKey(0), x))  # a few ops: not worth a compile
    want = np.asarray(jax_module.apply(variables, x))
    module = weights.load_variables_(port(dim_output=3, dim_input=FEAT_DIM, **dims), variables)
    assert _rel(module(torch.from_numpy(x)).detach(), want) <= REL_TOL


# --- TransMIL ------------------------------------------------------------------------


def test_pinv_alone():
    """The landmark softmax of a bag, then six Newton–Schulz steps; the max
    over batch and heads is global.  Measured: 1e-6 of max |JAX|; the
    tolerance is 1e-5, as everywhere in this file."""
    rng = np.random.default_rng(1)
    attn2 = jax.nn.softmax(jnp.asarray(rng.normal(size=(2, 8, 16, 16)) * 2.0, jnp.float32), axis=-1)
    want = np.asarray(jax_trans_mil.moore_penrose_iter_pinv(attn2))
    got = trans_mil.moore_penrose_iter_pinv(torch.from_numpy(np.asarray(attn2)))
    assert _rel(got, want) <= REL_TOL


def test_landmark_softmax_and_pinv_of_a_bag():
    """The Nyström block's q/k landmarks, attn2 and its pseudo-inverse on a
    bag of 37 tokens (left-padded to 48 for 16 landmarks), each step held
    before the next."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 37, 32)).astype(np.float32)
    jax_block = jax_trans_mil.NystromAttention(dim=32, dim_head=4, heads=8, num_landmarks=16)
    variables = _init(jax_block, x)
    port = trans_mil.NystromAttention(32, dim_head=4, heads=8, num_landmarks=16)
    port.load_state_dict(trans_mil.variables_from_jax(variables))

    def landmarks_and_pinv(qkv_kernel, x, pinv):
        padded = np.pad(x, ((0, 0), (11, 0), (0, 0)))
        q, k, _ = np.split(padded @ qkv_kernel, 3, axis=-1)
        q = q.reshape(2, 48, 8, 4).transpose(0, 2, 1, 3) * 0.5
        k = k.reshape(2, 48, 8, 4).transpose(0, 2, 1, 3)
        q_land, k_land = q.reshape(2, 8, 16, 3, 4).sum(3) / 3, k.reshape(2, 8, 16, 3, 4).sum(3) / 3
        attn2 = np.asarray(jax.nn.softmax(q_land @ np.swapaxes(k_land, -1, -2), axis=-1))
        return attn2, np.asarray(pinv(attn2))

    kernel = variables["params"]["to_qkv"]["kernel"]
    want_attn2, want_inv = landmarks_and_pinv(kernel, x, jax_trans_mil.moore_penrose_iter_pinv)
    got_attn2, got_inv = landmarks_and_pinv(
        port.to_qkv.weight.detach().numpy().T, x, lambda a: trans_mil.moore_penrose_iter_pinv(torch.from_numpy(a))
    )
    assert _rel(got_attn2, want_attn2) <= REL_TOL
    assert _rel(got_inv, want_inv) <= REL_TOL
    got = port(torch.from_numpy(x)).detach()
    assert _rel(got, _apply(jax_block, variables, x)) <= REL_TOL


def test_trans_mil_forward():
    """A bag of 37 tiles: not a multiple of the 16 landmarks, and 38 is no
    square (the grid of 49 repeats the first 12 tokens)."""
    x, _, _ = _bags(3, 37)
    jax_module = jax_trans_mil.TransMIL(dim_output=3, dim_input=FEAT_DIM, dim_hidden=32)
    variables = _init(jax_module, x)
    want = np.asarray(_apply(jax_module, variables, x))
    module = weights.load_variables_(trans_mil.TransMIL(dim_output=3, dim_input=FEAT_DIM, dim_hidden=32), variables)
    assert _rel(module(torch.from_numpy(x)).detach(), want) <= REL_TOL


# --- barspoon ------------------------------------------------------------------------


def test_positional_encoding_against_f64():
    """The encoding alone at µm coordinates up to 1e5, each package against
    numpy in f64 on its own f32 argument (coords / freqs, the JAX module's
    order; ``barspoon.py:125-140``).  Measured: JAX 3.2e-8, port 3.6e-8 (sin
    and cos of f32 arguments); the tolerance is 1e-6.  The f32 argument
    itself differs from the exact one by up to an ulp of 1e5, 8.7e-3 rad, in
    both packages alike.

    The port's frequencies are the correctly rounded f32 powers (the power
    taken in f64), equal on every host; the JAX module's come from XLA's f32
    ``pow``, which agrees with them on this host but may be an ulp off
    elsewhere (an ulp of a frequency moves the argument at 1e5 µm by up to
    6e-3 rad): they are held to one ulp.  Each package is compared on its
    own argument, so neither comparison depends on another library's
    ``pow``."""
    coords = np.random.default_rng(4).uniform(0, 1e5, size=(1, 500, 2)).astype(np.float32)
    d_model = 64
    freqs = 100_000 ** (jnp.arange(d_model // 4, dtype=jnp.float32) / d_model)
    scaled = jnp.asarray(coords)[..., None] / freqs
    jax_pe = np.asarray(jnp.concatenate([jnp.sin(scaled).reshape(1, 500, -1), jnp.cos(scaled).reshape(1, 500, -1)], -1))

    def exact(argument):
        argument = np.asarray(argument).astype(np.float64)
        return np.concatenate([np.sin(argument).reshape(1, 500, -1), np.cos(argument).reshape(1, 500, -1)], axis=-1)

    port_freqs = barspoon.encoding_frequencies(d_model).numpy()
    exponent = np.arange(d_model // 4, dtype=np.float32) / np.float32(d_model)
    np.testing.assert_array_equal(port_freqs, (100_000.0 ** exponent.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_max_ulp(np.asarray(freqs), port_freqs, maxulp=1)
    got = barspoon.positional_encoding(torch.from_numpy(coords), d_model).numpy()
    assert np.abs(jax_pe - exact(scaled)).max() <= 1e-6
    assert np.abs(got - exact(coords[..., None] / port_freqs)).max() <= 1e-6


@pytest.mark.parametrize("positional_encoding", [True, False], ids=["pe", "no-pe"])
def test_barspoon_forward(positional_encoding):
    x, coords, key_mask = _bags(5, 40)
    dims = dict(dim_input=FEAT_DIM, positional_encoding=positional_encoding, **_BARSPOON)
    jax_module = jax_barspoon.EncDecTransformer(target_n_outs=_TARGETS, **dims)
    variables = _init(jax_module, x, coords=coords, key_mask=key_mask)
    want = _apply(jax_module, variables, x, coords=coords, key_mask=key_mask)
    module = weights.load_variables_(barspoon.EncDecTransformer(target_n_outs=_TARGETS, **dims), variables)
    got = module(torch.from_numpy(x), coords=torch.from_numpy(coords), key_mask=torch.from_numpy(key_mask))
    assert list(got) == [t for t, _ in _TARGETS]
    for target, _ in _TARGETS:
        assert _rel(got[target].detach(), want[target]) <= REL_TOL, target
    # a key-masked bag gives the unpadded bag's output
    short = module(torch.from_numpy(x[1:, :31]), coords=torch.from_numpy(coords[1:, :31]))
    for target, _ in _TARGETS:
        assert _rel(short[target].detach(), got[target][1:].detach()) <= REL_TOL


# --- one training step ---------------------------------------------------------------


def _step_case(kind: str):
    """(JAX module, its forward kwargs, port module class and kwargs, the
    JAX and port losses, the port forward kwargs) of one seeded batch."""
    x, coords, key_mask = _bags(6, 23)
    rng = np.random.default_rng(7)
    if kind == "barspoon":
        targets = {t: np.eye(n, dtype=np.float32)[rng.integers(0, n, 2)] for t, n in _TARGETS}
        class_weights = {t: rng.uniform(0.2, 1.0, n).astype(np.float32) for t, n in _TARGETS}
        dims = dict(dim_input=FEAT_DIM, **_BARSPOON)
        jax_module = jax_barspoon.EncDecTransformer(target_n_outs=_TARGETS, **dims)
        port = barspoon.EncDecTransformer(target_n_outs=_TARGETS, **dims)
        inputs = (x,), dict(coords=coords, key_mask=key_mask)

        def jax_loss(out):
            return sum(
                jax_tasks.weighted_cross_entropy(out[t], jnp.asarray(targets[t]), jnp.asarray(class_weights[t]))
                for t, _ in _TARGETS
            )

        def port_loss(out):
            return sum(
                tasks.weighted_cross_entropy(out[t], torch.from_numpy(targets[t]), torch.from_numpy(class_weights[t]))
                for t, _ in _TARGETS
            )

        return jax_module, inputs, port, jax_loss, port_loss
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 2)]
    w = rng.uniform(0.2, 1.0, 3).astype(np.float32)
    if kind == "trans_mil":
        jax_module = jax_trans_mil.TransMIL(dim_output=3, dim_input=FEAT_DIM, dim_hidden=32)
        port = trans_mil.TransMIL(dim_output=3, dim_input=FEAT_DIM, dim_hidden=32)
        inputs = (x,), {}
    else:
        feats = x.mean(axis=1)  # slide vectors
        if kind == "mlp":
            jax_module = jax_mlp.MLP(dim_output=3, dim_input=FEAT_DIM, dim_hidden=24, dropout=0.0)
            port = mlp.MLP(dim_output=3, dim_input=FEAT_DIM, dim_hidden=24, dropout=0.0)
        else:
            jax_module, port = jax_mlp.Linear(dim_output=3, dim_input=FEAT_DIM), mlp.Linear(dim_output=3, dim_input=FEAT_DIM)
        inputs = (feats,), {}
    return (
        jax_module,
        inputs,
        port,
        lambda out: jax_tasks.weighted_cross_entropy(out, jnp.asarray(y), jnp.asarray(w)),
        lambda out: tasks.weighted_cross_entropy(out, torch.from_numpy(y), torch.from_numpy(w)),
    )


@pytest.mark.parametrize("kind", ["mlp", "linear", "trans_mil", "barspoon"])
def test_one_training_step_matches_jax(kind):
    jax_module, (args, kwargs), port, jax_loss, port_loss = _step_case(kind)
    variables = _init(jax_module, *args, seed=1, **kwargs)
    # MLP's dropout is a parameter (0 here); TransMIL's attention dropout is
    # fixed, so its deterministic forward is differentiated
    train = kind in ("mlp", "linear", "barspoon")

    def loss_of(params):
        return jax_loss(jax_module.apply({"params": params}, *args, **kwargs, train=train))

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_of))(variables["params"])
    weights.load_variables_(port, variables)
    generator = torch.Generator().manual_seed(0) if train else None
    torch_args = [torch.from_numpy(a) for a in args]
    torch_kwargs = {k: torch.from_numpy(v) for k, v in kwargs.items()}
    loss = port_loss(port(*torch_args, **torch_kwargs, train=train, generator=generator))
    loss.backward()
    assert _rel(loss.detach(), want_loss) <= REL_TOL
    want = weights._codec(port).variables_from_jax({"params": _tree(want_grads)})
    got = dict(port.named_parameters())
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for name, grad in want.items():
        if name.endswith(".k.bias"):
            # softmax ignores a shift shared by all keys: this gradient is 0
            # in exact arithmetic and rounding noise on both sides
            assert max(float(np.abs(grad).max()), float(got[name].grad.abs().max())) <= 1e-6 * scale, name
        else:
            assert _rel(got[name].grad, grad) <= GRAD_TOL, name


# --- the JAX package's checkpoints, both ways -------------------------------------------


def _jax_task_model(kind: str):
    common = dict(dim_input=FEAT_DIM, model_name=kind, total_steps=4)
    cls = dict(ground_truth_label="gt", categories=["a", "b"], category_weights=np.array([0.4, 0.6], np.float32))
    if kind == "barspoon":
        return jax_tasks.LitEncDecTransformer(
            ground_truth_label=[t for t, _ in _TARGETS],
            categories={t: [f"c{i}" for i in range(n)] for t, n in _TARGETS},
            category_weights={t: np.full(n, 1 / n, np.float32) for t, n in _TARGETS},
            **_BARSPOON, **common,
        )  # fmt: skip
    module_class = {"vit": JaxViT, "trans_mil": jax_trans_mil.TransMIL, "mlp": jax_mlp.MLP, "linear": jax_mlp.Linear}
    lit_class = jax_tasks.LitTileClassifier if kind in ("vit", "trans_mil") else jax_tasks.LitSlideClassifier
    params = {"vit": dict(dim_model=32, n_heads=4, dim_feedforward=32, use_alibi=True),
              "trans_mil": dict(dim_hidden=32), "mlp": dict(dim_hidden=24), "linear": {}}[kind]  # fmt: skip
    return lit_class(model_class=module_class[kind], **cls, **params, **common)


@pytest.mark.parametrize("kind", ["vit", "mlp", "linear", "trans_mil", "barspoon"])
def test_jax_checkpoints_load_both_ways(tmp_path, kind):
    from stamp_tpu.modeling.checkpoint import load_checkpoint as jax_load
    from stamp_tpu.modeling.checkpoint import save_checkpoint as jax_save
    from stamp_tpu_torch.modeling.checkpoint import save_checkpoint
    from stamp_tpu_torch.modeling.deploy import load_model_from_ckpt

    model = _jax_task_model(kind)
    x, coords, _ = _bags(8, 12, batch=1)
    batch = (x, coords, np.array([12]), None) if model.supported_features[0] == "tile" else (x[:, 0], None)
    variables = _tree(jax.jit(lambda b: model.init_variables(jax.random.PRNGKey(2), b))(batch))
    jax_save(tmp_path / "jax.ckpt", hyper_parameters=model.checkpoint_hparams(), variables=variables)

    task_model, loaded = load_model_from_ckpt(tmp_path / "jax.ckpt")
    module = weights.load_variables_(task_model.module, loaded)  # strict
    assert type(module).__name__ == {"vit": "VisionTransformer", "mlp": "MLP", "linear": "Linear",
                                     "trans_mil": "TransMIL", "barspoon": "EncDecTransformer"}[kind]  # fmt: skip
    if kind == "vit":
        assert isinstance(module, vision_transformer.VisionTransformer)
    save_checkpoint(tmp_path / "port.ckpt", hyper_parameters=task_model.checkpoint_hparams(),
                    variables=weights.variables_of(module))  # fmt: skip
    back = jax_load(tmp_path / "port.ckpt")
    want, got = weights.flatten(variables), weights.flatten(back["variables"])
    assert set(got) == set(want)
    for path, value in want.items():
        assert got[path].dtype == value.dtype and np.array_equal(got[path], value), path
    assert jax_tasks.instantiate_from_hparams(back["hyper_parameters"]).hparams["model_name"] == kind
