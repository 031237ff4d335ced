"""The port's training step on a ``{dp: 2, sp: 2}`` mesh: one fleet of 4
gloo ranks for the module, each holding one row's half of the tiles
(``torch_sequence_util``).  ``vit``, ALiBi and barspoon against the JAX
package's ``make_dp_train_step(..., sp_axis="sp")`` on a ``(2, 2)`` mesh
of virtual devices, from the same weights; ALiBi with dropout (each rank
keeps its row's and tiles' part of the unsharded masks) and TransMIL (its
pseudo-inverse scale a max over the ranks, whose gradient goes back to the
ranks that hold it) against the port's single-process step: the loss, the
state after the step and the gradients after the all-reduce, summed over
the sequence groups and over the rows (``assert_step``'s tolerances)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

import torch_sequence_util as seq
from stamp_tpu_torch.parallel._dist_dryrun import launch_local_fleet

MESH = {"dp": 2, "sp": 2}
CASES = ["vit", "alibi", "barspoon", "alibi_dropout", "trans_mil"]


@pytest.fixture(scope="module")
def fleet(tmp_path_factory):
    """The steps in one 4-rank fleet; meanwhile, in this process, each
    case's single-process step and, for the JAX cases, the JAX step."""
    root = tmp_path_factory.mktemp("dp_sp_fleet")
    jobs, refs = [], {}
    for name in CASES:
        arrays = seq.step_batch(name, 4, 12)
        state, variables = seq.initial_state(name, arrays)
        jobs.append(seq.write_step_job(root, name, MESH, 4, 12, state))
        refs[name] = (state, variables, arrays)
    with ThreadPoolExecutor(1) as pool:
        run = pool.submit(launch_local_fleet, ["jobs", seq.jobs_file(root, jobs)], n_processes=4, timeout=600,
                          env_extra={"OMP_NUM_THREADS": "1"})  # fmt: skip
        want = {
            name: (seq.single_step(name, state, arrays),
                   None if variables is None else seq.jax_step(name, variables, arrays, MESH))
            for name, (state, variables, arrays) in refs.items()
        }  # fmt: skip
        run.result()
    return root, want


@pytest.mark.parametrize("name", CASES)
def test_dp_sp_step(fleet, name):
    root, want = fleet
    (single_loss, single_state, grads), jax_result = want[name]
    result = dict(np.load(root / name / "result.npz"))
    lr = seq.first_lr(name)
    if jax_result is not None:
        jax_loss, jax_state = jax_result
        seq.assert_step(result, jax_loss, jax_state, None, lr)
    seq.assert_step(result, single_loss, single_state, grads, lr)
