"""The slice end to end: the port's ``solve_batch(maxiter=1)`` vs JAX
``solve_batch`` on the reduced ANYmal walk, same x0s and warm start, float64
on CPU — the bar of tests/test_fddp_batch.py:51-58 (identical iter and
steplength, cost rtol 1e-8, us within 1e-6) plus the direction fields K, k,
Vx and fs within 1e-8 of their max-abs."""

import numpy as np
import pytest

import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import jax_walk, max_rel, np_, solve_pair, to_port


@pytest.fixture(scope="module")
def solved(solve_cache):  # noqa: F811
    return solve_pair("solve_batch", 1, solve_cache)


def test_same_decisions(solved):
    ref, out = solved
    np.testing.assert_array_equal(np.asarray(ref.iter), np_(out.iter))
    np.testing.assert_array_equal(np.asarray(ref.steplength),
                                  np_(out.steplength))
    np.testing.assert_array_equal(np.asarray(ref.is_feasible),
                                  np_(out.is_feasible))


def test_cost_and_controls(solved):
    ref, out = solved
    np.testing.assert_allclose(np_(out.cost), np.asarray(ref.cost), rtol=1e-8)
    assert float(np.max(np.abs(np.asarray(ref.us) - np_(out.us)))) < 1e-6


@pytest.mark.parametrize("field", ["K", "k", "Vx", "fs", "xs"])
def test_direction_fields(solved, field):
    ref, out = solved
    assert max_rel(getattr(ref, field), getattr(out, field)) < 1e-8


def test_unsupported_configs_gate():
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.core.solvers import fddp_batch
    prob = to_port(jax_walk()[0])
    assert fddp_batch.supports(prob, SolverSettings(
        maxiter=1, record_trace=False, parallel_linesearch=False))
    for bad in (dict(box=True), dict(parallel_linesearch=True),
                dict(record_trace=True), dict(ms_chunk=4)):
        kw = dict(maxiter=1, record_trace=False, parallel_linesearch=False)
        kw.update(bad)
        assert not fddp_batch.supports(prob, SolverSettings(**kw))
