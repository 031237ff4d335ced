"""``stamp_tpu_torch.utils.shapecheck`` against ``stamp_tpu.utils.shapecheck``
on the CPU: for every function the JAX package decorates (``flash_mha``,
``flash_alibi2d_mha``, ``fused_qkv_mha``, ``dilated_attention``, the SSD and
the MIL forwards of the ViT, TransMIL, the MLP, the linear head and
barspoon), the same wrongly shaped numpy inputs make the JAX function and
the port's raise, and well-shaped ones pass both.  The port checks a call
signature once: a second call with a signature that passed runs unchecked
(``CHECKS``), and a new one is checked again.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stamp_tpu.models import barspoon as jax_barspoon
from stamp_tpu.models import mlp as jax_mlp
from stamp_tpu.models import trans_mil as jax_trans_mil
from stamp_tpu.models import vision_transformer as jax_vit
from stamp_tpu.ops import dilated_attention as jax_dilated
from stamp_tpu.ops import flash_attention as jax_flash
from stamp_tpu.ops import ssd as jax_ssd
from stamp_tpu_torch.models import barspoon, mlp, trans_mil, vision_transformer
from stamp_tpu_torch.ops import dilated_attention, flash_attention, ssd
from stamp_tpu_torch.utils import shapecheck
from stamp_tpu_torch.utils.shapecheck import Float

RNG = np.random.default_rng(0)


def _f(*shape) -> np.ndarray:
    return RNG.normal(size=shape).astype(np.float32)


def _mask(*shape) -> np.ndarray:
    return np.ones(shape, bool)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_model(module, args, kwargs):
    """Initialize and apply a flax module (the check runs in both)."""
    variables = module.init(jax.random.PRNGKey(0), *map(jnp.asarray, args), **kwargs)
    return module.apply(variables, *map(jnp.asarray, args), **kwargs)


def _traced(fn, args, kwargs=None):
    """Trace ``fn`` on the arrays' shapes without running it (JAX checks
    the annotations while it traces; its Pallas kernels need interpret mode
    to run on the CPU)."""
    return jax.eval_shape(lambda *a: fn(*a, **(kwargs or {})), *map(jnp.asarray, args))


def _kw(kwargs, to):
    return {k: (to(v) if isinstance(v, np.ndarray) else v) for k, v in kwargs.items()}


# name → (JAX call, port call, good args, good kwargs, bad args, bad kwargs);
# each call takes (args, kwargs) of numpy arrays
CASES = {
    "fused_qkv_mha": (
        lambda a, kw: _traced(lambda qkv: jax_flash.fused_qkv_mha(qkv, 2), a),
        lambda a, kw: flash_attention.fused_qkv_mha(*_torch(a), 2),
        [_f(2, 5, 3 * 2 * 8)], {}, [_f(10, 3 * 2 * 8)], {},  # [B, N, 3·dim], not [N, 3·dim]
    ),
    "flash_mha": (
        lambda a, kw: _traced(jax_flash.flash_mha, a),
        lambda a, kw: flash_attention.flash_mha(*_torch(a)),
        [_f(2, 5, 8), _f(2, 6, 8), _f(2, 6, 8), _mask(2, 6)], {},
        [_f(2, 5, 8), _f(2, 6, 8), _f(2, 7, 8), _mask(2, 6)], {},  # v's keys are not k's
    ),
    "flash_alibi2d_mha": (
        lambda a, kw: _traced(jax_flash.flash_alibi2d_mha, a),
        lambda a, kw: flash_attention.flash_alibi2d_mha(*_torch(a)),
        [_f(2, 5, 8), _f(2, 5, 8), _f(2, 5, 8), _f(2, 5, 2), _f(2)], {},
        [_f(2, 5, 8), _f(2, 5, 8), _f(2, 5, 8), _f(2, 5, 3), _f(2)], {},  # coords [.., 3]
    ),
    "dilated_attention": (
        lambda a, kw: _traced(jax_dilated.dilated_attention, a, kw),
        lambda a, kw: dilated_attention.dilated_attention(*_torch(a), **kw),
        [_f(2, 16, 4)] * 3, dict(segment_lengths=(8, 16), dilation_rates=(1, 2)),
        [_f(2, 16, 4), _f(2, 12, 4), _f(2, 16, 4)], dict(segment_lengths=(8, 16), dilation_rates=(1, 2)),
    ),
    "ssd_chunked": (
        lambda a, kw: _traced(jax_ssd.ssd_chunked, a),
        lambda a, kw: ssd.ssd_chunked(*_torch(a)),
        [_f(10, 2, 4), _f(10, 2), -np.abs(_f(2)), _f(10, 3), _f(10, 3)], {},
        [_f(10, 2, 4), _f(10, 3), -np.abs(_f(2)), _f(10, 3), _f(10, 3)], {},  # dt's heads are not x's
    ),
    "vision_transformer": (
        lambda a, kw: _jax_model(jax_vit.VisionTransformer(dim_output=2, dim_input=6, dim_model=8, n_heads=2,
                                                           dim_feedforward=8), a, _kw(kw, jnp.asarray)),
        lambda a, kw: vision_transformer.VisionTransformer(dim_output=2, dim_input=6, dim_model=8, n_heads=2,
                                                           dim_feedforward=8)(*_torch(a), **_kw(kw, torch.from_numpy)),
        [_f(2, 5, 6)], dict(coords=_f(2, 5, 2), key_mask=_mask(2, 5)),
        [_f(2, 5, 6)], dict(coords=_f(2, 4, 2), key_mask=_mask(2, 5)),  # coords of 4 tiles
    ),
    "trans_mil": (
        lambda a, kw: _jax_model(jax_trans_mil.TransMIL(dim_output=2, dim_input=6, dim_hidden=16), a, kw),
        lambda a, kw: trans_mil.TransMIL(dim_output=2, dim_input=6, dim_hidden=16)(*_torch(a)),
        [_f(2, 5, 6)], {}, [_f(5, 6)], {},  # no batch axis
    ),
    "mlp": (
        lambda a, kw: _jax_model(jax_mlp.MLP(dim_output=2, dim_input=6, dim_hidden=8), a, kw),
        lambda a, kw: mlp.MLP(dim_output=2, dim_input=6, dim_hidden=8)(*_torch(a)),
        [_f(2, 5, 6)], {}, [_f(2, 3, 5, 6)], {},  # neither [B, F] nor [B, T, F]
    ),
    "linear": (
        lambda a, kw: _jax_model(jax_mlp.Linear(dim_output=2, dim_input=6), a, kw),
        lambda a, kw: mlp.Linear(dim_output=2, dim_input=6)(*_torch(a)),
        [_f(2, 6)], {}, [_f(6)], {},
    ),
    "barspoon": (
        lambda a, kw: _jax_model(jax_barspoon.EncDecTransformer(dim_input=6, target_n_outs=(("t", 2),), d_model=8,
                                                                num_encoder_heads=2, num_decoder_heads=2,
                                                                dim_feedforward=8), a, _kw(kw, jnp.asarray)),
        lambda a, kw: barspoon.EncDecTransformer(dim_input=6, target_n_outs=[("t", 2)], d_model=8,
                                                 num_encoder_heads=2, num_decoder_heads=2,
                                                 dim_feedforward=8)(*_torch(a), **_kw(kw, torch.from_numpy)),
        [_f(2, 5, 6)], dict(coords=_f(2, 5, 2)), [_f(2, 5, 6)], dict(coords=_f(2, 5, 2), key_mask=_mask(2, 4)),
    ),
}  # fmt: skip


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrong_shapes_raise_in_both_packages(name):
    jax_call, port_call, good, good_kw, bad, bad_kw = CASES[name]
    jax_call(good, good_kw)
    port_call(good, good_kw)
    with pytest.raises(TypeError):
        jax_call(bad, bad_kw)
    before = shapecheck.CHECKS
    with pytest.raises(TypeError):
        port_call(bad, bad_kw)
    assert shapecheck.CHECKS == before + 1  # the wrapper checked it: a new signature


def test_a_signature_is_checked_once():
    qkv = torch.from_numpy(_f(2, 13, 3 * 2 * 8))  # a signature no other test uses
    first = shapecheck.CHECKS
    flash_attention.fused_qkv_mha(qkv, 2)
    assert shapecheck.CHECKS == first + 1
    flash_attention.fused_qkv_mha(torch.from_numpy(_f(2, 13, 3 * 2 * 8)), 2)  # same shapes, dtype, device
    assert shapecheck.CHECKS == first + 1
    flash_attention.fused_qkv_mha(torch.from_numpy(_f(3, 13, 3 * 2 * 8)), 2)  # a new batch
    flash_attention.fused_qkv_mha(qkv.double(), 2)  # a new dtype
    flash_attention.fused_qkv_mha(qkv, 1)  # a new head count
    assert shapecheck.CHECKS == first + 4


def test_a_bad_signature_is_not_remembered():
    bad = torch.from_numpy(_f(7, 3 * 2 * 8))
    for _ in range(2):
        before = shapecheck.CHECKS
        with pytest.raises(TypeError):
            flash_attention.fused_qkv_mha(bad, 2)
        assert shapecheck.CHECKS == before + 1


def test_the_check_runs_before_the_function():
    """A wrongly shaped call never reaches the body (on the card: no
    kernel launch; chip_smoke.py phase 17d shows it there)."""
    calls = []

    @shapecheck.shapechecked
    def fn(x: Float[torch.Tensor, "a b"]) -> None:
        calls.append(x.shape)

    with pytest.raises(TypeError):
        fn(torch.zeros(3))
    assert calls == []


def test_mlp_takes_tile_bags_and_feature_vectors():
    """The MLP's union annotation: [B, F] and [B, T, F] both pass, each
    checked once."""
    model = mlp.MLP(dim_output=2, dim_input=6, dim_hidden=8)
    assert model(torch.zeros(3, 6)).shape == (3, 2)
    assert model(torch.zeros(3, 4, 6)).shape == (3, 2)
