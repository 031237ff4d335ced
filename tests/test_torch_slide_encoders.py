"""The port's slide-encoder ops and models against the JAX package's, on the
CPU: LongNet's ``dilated_attention``, the Mamba2 SSD (``ssd_chunked``,
``causal_conv1d``, ``Mamba2Block``), ``CobraNet``, ``LongNetViT``,
``PrismPerceiver``, ``MadeleineNet`` and CHIEF's attention net, each at a
small width with the JAX module's weights carried across by
``*_variables_from_jax`` (and back by ``*_variables_to_jax``), and the
upstream-checkpoint loaders against the JAX converters on the checkpoint
layouts of ``tests/test_converter_parity.py``.

Tolerances: f32 throughout.  Attention and the models agree to 1e-5
(absolute) plus 1e-4 relative; the chunked SSD adds in another order than
the JAX package's (its inter-chunk scan a product instead of a tree of
products) and its decays are differences of running sums, so it is held to
2e-5 of max |y| (the JAX package's own chunked form reads 1.4e-5 of max |y|
against the recurrence in the overflow case)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from test_converter_parity import _TorchCobra, _TorchLongNetViT, _TorchMadeleine, _TorchPrism

from stamp_tpu.encoding.encoder.chief import ChiefAttentionNet as JaxChief
from stamp_tpu.encoding.encoder.chief import convert_chief_state_dict
from stamp_tpu.models import slide_encoders as jax_se
from stamp_tpu.ops import dilated_attention as jax_da
from stamp_tpu.ops import ssd as jax_ssd
from stamp_tpu_torch.encoding.encoder import chief
from stamp_tpu_torch.models import slide_encoders as se
from stamp_tpu_torch.models import slide_encoders_cobra as cobra
from stamp_tpu_torch.models import slide_encoders_longnet as longnet
from stamp_tpu_torch.ops import dilated_attention as da
from stamp_tpu_torch.ops import ssd

ATOL, RTOL = 1e-5, 1e-4
SSD_TOL = 2e-5  # of max |y|


def _tree(variables) -> dict:
    return jax.tree_util.tree_map(np.asarray, variables)


def _assert_round_trip(variables, to_jax, sd) -> None:
    back = to_jax(sd)
    flat_in = jax.tree_util.tree_flatten_with_path(variables)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_in) == len(flat_back)
    for path, leaf in flat_in:
        np.testing.assert_array_equal(flat_back[path], leaf, err_msg=str(path))


def _perturb(variables, seed: int) -> dict:
    """The tree with every leaf moved by a seeded normal (so that zero
    biases, unit scales and flax's A_log init are not all the test sees)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32), variables)


# --- LongNet dilated attention ---------------------------------------------------


@pytest.mark.parametrize(
    "length,heads,segments,dilations",
    [(37, 4, (16, 64), (1, 2)), (300, 8, (8, 32, 128, 512), (1, 2, 4, 8))],
    ids=["L37", "L300"],
)
def test_dilated_attention_matches_jax(length, heads, segments, dilations):
    """The whole op against the JAX function, and each configuration's head
    group against ``dilated_attention_reference`` (the port's and the JAX
    package's).  At L = 300 every configuration pads (w_eff = 8, 32, 128,
    304) and r = 8 makes groups of 38 positions: a transposed group order
    would not pass."""
    rng = np.random.default_rng(length)
    q, k, v = (rng.normal(size=(heads, length, 16)).astype(np.float32) for _ in range(3))
    jax_op = jax.jit(functools.partial(jax_da.dilated_attention, segment_lengths=segments, dilation_rates=dilations))
    want = np.asarray(jax_op(*map(jnp.asarray, (q, k, v))))
    got = da.dilated_attention(*map(torch.from_numpy, (q, k, v)), segment_lengths=segments, dilation_rates=dilations)
    got = got.numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    hc = heads // len(segments)
    for i, (w, r) in enumerate(zip(segments, dilations)):
        group = slice(i * hc, (i + 1) * hc)
        ref = da.dilated_attention_reference(*(torch.from_numpy(t[group]) for t in (q, k, v)), w=w, r=r).numpy()
        jax_oracle = jax.jit(functools.partial(jax_da.dilated_attention_reference, w=w, r=r))
        jax_ref = np.asarray(jax_oracle(*(jnp.asarray(t[group]) for t in (q, k, v))))
        np.testing.assert_allclose(got[group], ref, atol=ATOL, rtol=RTOL, err_msg=f"w={w}, r={r}")
        np.testing.assert_allclose(ref, jax_ref, atol=ATOL, rtol=RTOL, err_msg=f"w={w}, r={r}")


def test_dilated_attention_refuses_uneven_heads():
    q = torch.zeros(3, 10, 8)
    with pytest.raises(ValueError, match="divide evenly"):
        da.dilated_attention(q, q, q, segment_lengths=(4, 8), dilation_rates=(1, 2))


# --- the Mamba2 SSD ----------------------------------------------------------------


def _ssd_inputs(seed: int, dt_scale: float, length: int = 150, heads: int = 3, p: int = 8, n: int = 16):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(length, heads, p)).astype(np.float32)
    dt = (rng.random((length, heads)) * dt_scale).astype(np.float32)
    A = -np.asarray([1.0, 8.0, 24.0][:heads], np.float32)  # COBRA's A = −exp(A_log) reaches −24
    B, C = (rng.normal(size=(length, n)).astype(np.float32) for _ in range(2))
    return x, dt, A, B, C


@pytest.mark.parametrize("dt_scale", [0.05, 8.0], ids=["in_range", "overflowing"])
def test_ssd_chunked_matches_jax_and_the_recurrence(dt_scale):
    """L = 150 (two full chunks and a padded one).  With Δ up to 8 and A =
    −24 the positive exponent above the diagonal exceeds f32's exp range
    (checked; with COBRA's A = −24 already a mean Δ of 0.06 does): the
    output must stay finite and match."""
    x, dt, A, B, C = _ssd_inputs(0, dt_scale)
    a_cum = np.cumsum(np.pad(dt, ((0, 42), (0, 0))).reshape(3, 64, 3) * A, axis=1)
    overflows = (a_cum[:, :, None, :] - a_cum[:, None, :, :]).max() > np.log(np.finfo(np.float32).max)
    assert overflows == (dt_scale > 1)
    want = np.asarray(jax.jit(jax_ssd.ssd_chunked)(*map(jnp.asarray, (x, dt, A, B, C))))
    recurrence = np.asarray(jax.jit(jax_ssd.ssd_reference)(*map(jnp.asarray, (x, dt, A, B, C))))
    got = ssd.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C))).numpy()
    port_recurrence = ssd.ssd_reference(*map(torch.from_numpy, (x, dt, A, B, C))).numpy()
    assert np.isfinite(got).all()
    scale = np.abs(recurrence).max()
    assert np.abs(got - want).max() <= SSD_TOL * scale
    assert np.abs(got - recurrence).max() <= SSD_TOL * scale
    assert np.abs(port_recurrence - recurrence).max() <= 1e-6 * scale


def test_causal_conv1d_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(50, 24)).astype(np.float32)
    w = rng.normal(size=(4, 24)).astype(np.float32)
    b = rng.normal(size=24).astype(np.float32)
    for bias in (b, None):
        jax_bias, torch_bias = (None, None) if bias is None else (jnp.asarray(bias), torch.from_numpy(bias))
        want = np.asarray(jax_ssd.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jax_bias))
        got = ssd.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w), torch_bias)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6)


def test_softplus_matches_jax():
    """``F.softplus`` (linear above 20) against ``jax.nn.softplus``
    (``logaddexp(x, 0)``) in f32 across the range Δ takes, 20 included."""
    x = np.concatenate([np.linspace(-30, 30, 6001), [19.999, 20.0, 20.001]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(F.softplus(torch.from_numpy(x)).numpy(), want, rtol=2e-7, atol=0)


def test_mamba2_block_matches_jax():
    module = jax_ssd.Mamba2Block(d_model=32, d_state=16, headdim=8, chunk=16)
    variables = _perturb(_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((4, 32)))), 2)
    variables["params"]["A_log"] = np.log(np.linspace(1, 24, 8)).astype(np.float32)
    u = np.random.default_rng(3).normal(size=(70, 32)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(u)))
    block = ssd.Mamba2Block(32, d_state=16, headdim=8, chunk=16)
    block.load_state_dict(cobra.cobra_variables_from_jax(variables))
    with torch.inference_mode():
        got = block(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


# --- the models --------------------------------------------------------------------


@functools.cache
def _jax_cobra():
    """One JAX tree holding all four embed heads (each init makes only the
    head of its width; the rest of the tree is the same)."""
    module = jax_se.CobraNet(d_model=64, depth=2)
    init = jax.jit(module.init)
    trees = {d: _tree(init(jax.random.PRNGKey(0), jnp.zeros((8, d)))) for d in cobra.COBRA_INPUT_DIMS}
    variables = _perturb(trees[2560], 4)
    for d, tree in trees.items():
        variables["params"][f"embed_{d}"] = tree["params"][f"embed_{d}"]
    return module, variables


@pytest.mark.parametrize("width", cobra.COBRA_INPUT_DIMS)
def test_cobra_matches_jax(width):
    module, variables = _jax_cobra()
    variables = jax.tree_util.tree_map(np.copy, variables)
    sd = cobra.cobra_variables_from_jax(variables)
    model = cobra.CobraNet(d_model=64, input_dims=cobra.cobra_input_dims(sd)).eval()
    model.load_state_dict(sd)  # strict
    _assert_round_trip(variables, cobra.cobra_variables_to_jax, sd)
    feats = np.random.default_rng(width).normal(size=(90, width)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(feats)))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == (width,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cobra_refuses_other_widths_as_jax_does():
    module, variables = _jax_cobra()
    model = cobra.CobraNet(d_model=64)
    with pytest.raises(ValueError) as want:
        jax.jit(module.apply)(variables, jnp.zeros((4, 768)))
    with pytest.raises(ValueError) as got:
        model(torch.zeros(4, 768))
    assert str(got.value) == str(want.value)


def test_sincos_frequencies_within_one_ulp_of_jax():
    for dim in (64, 768):
        quarter = dim // 4
        want = np.asarray(1.0 / (10000.0 ** (jnp.arange(quarter, dtype=jnp.float32) / quarter)))
        got = longnet.sincos_frequencies(quarter).numpy()
        assert got.dtype == np.float32
        assert (np.abs(got - want) <= np.spacing(want)).all()
    coords = np.random.default_rng(5).random((50, 2)).astype(np.float32) * 200
    np.testing.assert_allclose(
        longnet.sincos_position_embedding(torch.from_numpy(coords), 64).numpy(),
        np.asarray(jax_se.sincos_position_embedding(jnp.asarray(coords), 64)),
        atol=1e-4,  # an ulp of a frequency moves the angle at 200 by up to 1.5e-5
    )


_LONGNET = dict(dim=64, depth=2, num_heads=8, segment_lengths=(8, 32, 128, 512), dilation_rates=(1, 2, 4, 8))


def test_longnet_vit_matches_jax():
    module = jax_se.LongNetViT(**_LONGNET)
    variables = _perturb(_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((4, 96)), jnp.zeros((4, 2)))), 6)
    sd = longnet.gigapath_variables_from_jax(variables)
    model = longnet.LongNetViT(**_LONGNET, input_dim=96).eval()
    model.load_state_dict(sd)
    _assert_round_trip(variables, longnet.gigapath_variables_to_jax, sd)
    rng = np.random.default_rng(7)
    feats = rng.normal(size=(299, 96)).astype(np.float32)  # 300 tokens with the CLS
    grid = (rng.random((299, 2)) * 40).astype(np.float32)  # float grid units
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(feats), jnp.asarray(grid)))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(grid)).numpy()
    assert got.shape == (64,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


_PRISM = dict(dim=32, input_dim=64, num_latents=8, depth=2, num_heads=4)


def test_prism_perceiver_matches_jax():
    module = jax_se.PrismPerceiver(**_PRISM)
    variables = _perturb(_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((4, 64)))), 8)
    sd = se.prism_variables_from_jax(variables)
    model = se.PrismPerceiver(**_PRISM).eval()
    model.load_state_dict(sd)
    _assert_round_trip(variables, se.prism_variables_to_jax, sd)
    feats = np.random.default_rng(9).normal(size=(40, 64)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(feats)))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    assert got.shape == (32,)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_madeleine_matches_jax():
    module = jax_se.MadeleineNet(dim=32, num_heads=4)
    variables = _perturb(_tree(jax.jit(module.init)(jax.random.PRNGKey(0), jnp.zeros((4, 48)))), 10)
    sd = se.madeleine_variables_from_jax(variables)
    model = se.MadeleineNet(dim=32, num_heads=4, input_dim=48).eval()
    model.load_state_dict(sd)
    _assert_round_trip(variables, se.madeleine_variables_to_jax, sd)
    feats = np.random.default_rng(11).normal(size=(40, 48)).astype(np.float32)
    want = np.asarray(jax.jit(module.apply)(variables, jnp.asarray(feats)))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_chief_net_matches_jax():
    """The random CHIEF weights are the JAX package's numpy draws, so both
    nets are the same one; the weights also round-trip."""
    params = chief.random_chief_params()
    net = chief.ChiefAttentionNet().eval()
    sd = chief.chief_variables_from_jax(params)
    net.load_state_dict(sd)
    back = chief.chief_variables_to_jax(sd)
    assert back.keys() == params.keys()
    for key, value in params.items():
        np.testing.assert_array_equal(back[key], value)
    feats = np.random.default_rng(12).normal(size=(40, 768)).astype(np.float32)
    want_scores, want_feature = JaxChief(params)(feats)
    got_scores, got_feature = net.scores_and_feature(feats, "cpu")
    np.testing.assert_allclose(got_scores, want_scores, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_feature, want_feature[0], atol=ATOL, rtol=RTOL)


# --- upstream-checkpoint loaders against the JAX converters -------------------------


def _numpy(checkpoint: dict) -> dict:
    return {k: np.asarray(v) for k, v in checkpoint.items()}


def test_gigapath_loader_matches_jax_converter():
    torch.manual_seed(0)
    oracle = _TorchLongNetViT(d_in=96, dim=64, depth=2, num_heads=8, segments=(8, 32, 128, 512), dilations=(1, 2, 4, 8))
    checkpoint = {"model." + k: v for k, v in _numpy(oracle.checkpoint()).items()}  # a prefix both strip
    rng = np.random.default_rng(13)
    feats = rng.normal(size=(70, 96)).astype(np.float32)
    grid = (rng.random((70, 2)) * 12).astype(np.float32)
    want = np.asarray(
        jax.jit(jax_se.LongNetViT(**_LONGNET).apply)(
            jax_se.convert_gigapath_slide_state_dict(checkpoint, depth=2), jnp.asarray(feats), jnp.asarray(grid)
        )
    )
    model = longnet.LongNetViT(**_LONGNET, input_dim=96).eval()
    model.load_state_dict(longnet.gigapath_state_dict({k: torch.from_numpy(v) for k, v in checkpoint.items()}, depth=2))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats), torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_prism_loader_matches_jax_converter():
    torch.manual_seed(0)
    checkpoint = _numpy(_TorchPrism(d_in=64, dim=32, n_latents=8, depth=2, num_heads=4).checkpoint())
    feats = np.random.default_rng(14).normal(size=(30, 64)).astype(np.float32)
    want = np.asarray(
        jax.jit(jax_se.PrismPerceiver(**_PRISM).apply)(
            jax_se.convert_prism_state_dict(checkpoint, depth=2), jnp.asarray(feats)
        )
    )
    model = se.PrismPerceiver(**_PRISM).eval()
    model.load_state_dict(se.prism_state_dict({k: torch.from_numpy(v) for k, v in checkpoint.items()}, depth=2))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_cobra_loader_matches_jax_converter():
    """A checkpoint with two embed heads (512 and 1024): the port's model
    holds those two, and both widths match."""
    torch.manual_seed(0)
    checkpoint = _numpy(_TorchCobra(d_in=1024, d_model=64, depth=2).checkpoint())
    other = _TorchCobra(d_in=512, d_model=64, depth=2)
    checkpoint |= {f"embed.512.{n}": p.detach().numpy() for n, p in other.embed["512"].named_parameters()}
    state = cobra.cobra_state_dict({k: torch.from_numpy(v) for k, v in checkpoint.items()}, depth=2)
    model = cobra.CobraNet(d_model=64, input_dims=cobra.cobra_input_dims(state)).eval()
    assert model.input_dims == (512, 1024)
    model.load_state_dict(state)
    variables = jax_se.convert_cobra_state_dict(checkpoint, depth=2)
    for width in (512, 1024):
        feats = np.random.default_rng(width).normal(size=(80, width)).astype(np.float32)
        want = np.asarray(jax.jit(jax_se.CobraNet(d_model=64, depth=2).apply)(variables, jnp.asarray(feats)))
        with torch.inference_mode():
            got = model(torch.from_numpy(feats)).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_madeleine_loader_matches_jax_converter():
    torch.manual_seed(0)
    oracle = _TorchMadeleine(d_in=48, dim=32, num_heads=4)
    checkpoint = {"module." + k: v for k, v in _numpy(oracle.checkpoint()).items()}
    feats = np.random.default_rng(15).normal(size=(30, 48)).astype(np.float32)
    want = np.asarray(
        jax.jit(jax_se.MadeleineNet(dim=32, num_heads=4).apply)(
            jax_se.convert_madeleine_state_dict(checkpoint), jnp.asarray(feats)
        )
    )
    model = se.MadeleineNet(dim=32, num_heads=4, input_dim=48).eval()
    model.load_state_dict(se.madeleine_state_dict({k: torch.from_numpy(v) for k, v in checkpoint.items()}))
    with torch.inference_mode():
        got = model(torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_chief_loader_matches_jax_converter():
    rng = np.random.default_rng(16)
    names = {
        "attention_net.0": (512, 768), "attention_net.3.attention_a.0": (256, 512),
        "attention_net.3.attention_b.0": (256, 512), "attention_net.3.attention_c": (1, 256),
    }  # fmt: skip
    checkpoint = {}
    for name, shape in names.items():
        checkpoint[name + ".weight"] = rng.normal(0, 0.05, shape).astype(np.float32)
        checkpoint[name + ".bias"] = rng.normal(0, 0.05, shape[0]).astype(np.float32)
    checkpoint["classifiers.weight"] = np.zeros((2, 768), np.float32)  # ignored by both
    state = chief.chief_state_dict({k: torch.from_numpy(v) for k, v in checkpoint.items()})
    want = convert_chief_state_dict(checkpoint)
    got = chief.chief_variables_to_jax(state)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
