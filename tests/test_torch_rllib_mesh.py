"""The learner sharded over a ``data`` mesh (``learners(mesh=...)``), on
2 and 4 gloo CPU ranks against the unmeshed learner on the whole
minibatch, in the test's own process.

Every rank is handed the same minibatches and keeps its block of rows
(of columns for IMPALA's t-major batch). Two updates each of PPO (with
its per-minibatch advantage normalisation), DQN (TD targets in the
batch), SAC, CQL (noise columns of B·n rows, and a replicated scalar)
and IMPALA, and one PPO ``train()`` built with the mesh: parameters
within 1e-5 of the larger of each leaf's largest |value| and the
learning rate of the unmeshed update's, every metric within 1e-5 (or
1e-6 absolute, for a mean of ~1 terms near 0), and
the parameters and optimizer state of every rank equal bit for bit. A
minibatch whose rows do not divide over the ranks raises ValueError.
The ranks run tests/torch_rllib_mesh_cases.py (no JAX), each spawned
group once per world size.
"""

import numpy as np
import pytest

import torch_rllib_mesh_cases as cases
from ray_tpu_torch.parallel import _spawn
from torch_rllib_helpers import leaves_close

TOL = 1e-5
LR = 3e-4


@pytest.fixture(scope="module", params=[2, 4], ids=["world2", "world4"])
def ranks(request):
    return _spawn.run(cases.run, request.param, timeout=240)


def _metrics_close(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for k in want:
        # PPO's policy loss is a mean of terms of size ~1 (normalised
        # advantages) that nearly cancel: 1e-6 of the terms, absolute.
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kind", cases.KINDS)
def test_meshed_update_is_the_whole_minibatch_update(ranks, kind):
    want = cases.updates(kind)
    got = ranks[0][kind]
    for g, w in zip(got["metrics"], want["metrics"]):
        _metrics_close(g, w)
    leaves_close(got["params"], want["params"], TOL, LR)
    for other in ranks[1:]:
        for part in ("params", "opt_state"):
            assert other[kind][part].keys() == got[part].keys()
            for k, v in got[part].items():
                np.testing.assert_array_equal(other[kind][part][k], v, err_msg=f"{part} {k}")
        assert other[kind]["metrics"] == got["metrics"]


def test_ppo_algorithm_through_the_mesh(ranks):
    want = cases.ppo_algorithm()
    got = ranks[0]["ppo_algorithm"]
    _metrics_close(got["metrics"], want["metrics"])
    leaves_close(got["params"], want["params"], TOL, LR)
    for other in ranks[1:]:
        for k, v in got["params"].items():
            np.testing.assert_array_equal(other["ppo_algorithm"]["params"][k], v)


def test_rows_that_do_not_divide_raise(ranks):
    world = len(ranks)
    for r in ranks:
        assert r["indivisible"] == (f"a minibatch of {cases.ROWS - 1} rows does not divide "
                                    f"over the {world} ranks of the data mesh")


def test_mesh_of_another_shape_is_refused():
    class Mesh2D:
        ndim, mesh_dim_names, shape = 2, ("data", "tensor"), (2, 2)

    with pytest.raises(ValueError, match="one dimension 'data'"):
        cases.learner("ppo", Mesh2D())
