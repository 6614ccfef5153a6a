"""The slice end to end: the port's ``solve_batch(maxiter=1)`` vs JAX
``solve_batch`` on the reduced ANYmal walk, same x0s and warm start, float64
on CPU — the bar of tests/test_fddp_batch.py:51-58 (identical iter and
steplength, cost rtol 1e-8, us within 1e-6) plus the direction fields K, k,
Vx and fs within 1e-8 of their max-abs."""

import numpy as np
import pytest

import jax.numpy as jnp

from tests._torch_parity import jax_walk, max_rel, np_, t64, to_port


@pytest.fixture(scope="module")
def solved():
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.core.solvers import fddp_batch as jfb
    from crocoddyl_tpu_torch import SolverSettings, solve_batch
    prob, xs0, us0, x0s = jax_walk()
    st_j = ct.SolverSettings(maxiter=1, record_trace=False,
                             parallel_linesearch=False)
    ref = jfb.solve_batch(prob, x0s, xs_init=xs0, us_init=us0,
                          settings=st_j)
    st_t = SolverSettings(maxiter=1, record_trace=False,
                          parallel_linesearch=False)
    out = solve_batch(to_port(prob), t64(x0s), xs_init=t64(xs0),
                      us_init=t64(us0), settings=st_t)
    return ref, out


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
                dict(record_trace=True)):
        kw = dict(maxiter=1, record_trace=False, parallel_linesearch=False)
        kw.update(bad)
        assert not fddp_batch.supports(prob, SolverSettings(**kw))
