"""The port's Cox losses (``stamp_tpu_torch.ops.cox``) against the JAX
package's (``stamp_tpu.ops.cox``) on the same numpy inputs, values and
gradients, and against the torchsurv doctest values that tests/test_cox.py
holds the JAX package to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stamp_tpu.ops import cox as jax_cox
from stamp_tpu_torch.ops import cox

RTOL = 1e-5  # f32 on both sides; only the summation order differs

_LOG_HZ = [0.1, 0.2, 0.3, 0.4, 0.5]
_EVENT = [1.0, 0.0, 1.0, 0.0, 1.0]


def _t(values) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32)


@pytest.mark.parametrize(
    "time,kwargs,want",
    [
        ([1.0, 2.0, 3.0, 4.0, 5.0], {}, 1.0071),
        ([1.0, 2.0, 3.0, 4.0, 5.0], {"reduction": "sum"}, 3.0214),
        ([1.0, 2.0, 2.0, 4.0, 5.0], {}, 1.0873),
        ([1.0, 2.0, 2.0, 4.0, 5.0], {"ties_method": "breslow"}, 1.0873),
    ],
)
def test_torchsurv_doctest_values(time, kwargs, want):
    got = cox.neg_partial_log_likelihood(_t(_LOG_HZ), _t(time), _t(_EVENT), **kwargs)
    assert abs(float(got) - want) <= 1e-3


def test_no_events_and_nan_labels():
    zeros = _t([0.0] * 5)
    time = _t([1.0, 2.0, 3.0, 4.0, 5.0])
    assert float(cox.neg_partial_log_likelihood(_t(_LOG_HZ), time, zeros)) == 0.0
    assert float(cox.cox_loss_breslow(_t(_LOG_HZ), time, zeros)) == 0.0
    time[1] = torch.nan
    assert torch.isfinite(cox.neg_partial_log_likelihood(_t(_LOG_HZ), time, _t(_EVENT)))


def _cohort(seed: int, n: int, *, ties: bool, nan: bool):
    rng = np.random.default_rng(seed)
    log_hz = rng.normal(size=n).astype(np.float32)
    time = (rng.integers(1, 6, size=n) if ties else rng.permutation(n) + 1).astype(np.float32)
    event = (rng.random(n) < 0.6).astype(np.float32)
    if nan:
        time[rng.integers(0, n)] = np.nan
        event[rng.integers(0, n)] = np.nan
    return log_hz, time, event


@pytest.mark.parametrize("ties_method", ["efron", "breslow"])
@pytest.mark.parametrize("ties,nan", [(False, False), (True, False), (True, True)])
def test_neg_partial_log_likelihood_matches_jax(ties_method, ties, nan):
    log_hz, time, event = _cohort(7, 24, ties=ties, nan=nan)
    want, want_grad = jax.value_and_grad(
        lambda x: jax_cox.neg_partial_log_likelihood(x, jnp.asarray(time), jnp.asarray(event), ties_method=ties_method)
    )(jnp.asarray(log_hz))
    x = torch.from_numpy(log_hz).requires_grad_()
    got = cox.neg_partial_log_likelihood(x, torch.from_numpy(time), torch.from_numpy(event), ties_method=ties_method)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=RTOL * 1e-2)


@pytest.mark.parametrize("ties,nan", [(False, False), (True, False), (True, True)])
def test_cox_loss_breslow_matches_jax(ties, nan):
    """The Breslow loss is the survival validation metric (no gradient
    taken in training); gradients are compared where the labels are all
    known."""
    log_hz, time, event = _cohort(8, 24, ties=ties, nan=nan)
    want, want_grad = jax.value_and_grad(
        lambda x: jax_cox.cox_loss_breslow(x, jnp.asarray(time), jnp.asarray(event))
    )(jnp.asarray(log_hz))
    x = torch.from_numpy(log_hz).requires_grad_()
    got = cox.cox_loss_breslow(x, torch.from_numpy(time), torch.from_numpy(event))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    if not nan:
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=RTOL * 1e-2)
