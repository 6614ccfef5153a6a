"""The port's ahead-of-time layer (crocoddyl_tpu_torch/utils/aot.py:
``torch.export`` in place of ``jax.export``) against the eager functions
and the JAX package, float64 on the CPU:

- the export/import round trip of the unicycle's ``calc`` and of a
  problem's rollout and cost from ``(x0, us)`` (the tape the reference's
  ActionModelCodeGen records, core/codegen/action-base.hpp): the eager
  function's results and JAX's same function's at rtol 1e-12, at the
  example arguments and at others of the same shapes;
- ``export_bytes`` on a whole ``solve`` raises (its ladder and line search
  branch on tensor values on the host), where tests/test_aot.py:30-42
  exports JAX's;
- ``precompile`` returns a callable giving the eager result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

T = 10


def _port_problem():
    from crocoddyl_tpu_torch import ShootingProblem, replicate_model
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    m = UnicycleModel()
    return ShootingProblem(x0=torch.tensor([-1.0, -1.0, 1.0],
                                           dtype=torch.float64),
                           running=replicate_model(m, T), terminal=m)


def _jax_problem():
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    m = UnicycleModel()
    return ct.ShootingProblem(x0=jnp.asarray([-1.0, -1.0, 1.0]),
                              running=ct.replicate_model(m, T), terminal=m)


def _inputs(seed):
    """(x0, us, x, u) drawn with numpy."""
    rng = np.random.default_rng(seed)
    return (np.array([-1.0, -1.0, 1.0]) + 0.1 * rng.standard_normal(3),
            0.3 * rng.standard_normal((T, 2)), rng.standard_normal(3),
            rng.standard_normal(2))


def _port_rollout_cost(problem):
    def fn(x0, us):
        p = problem.replace(x0=x0)
        xs = p.rollout(us)
        return xs, p.calc(xs, us)[1].sum()
    return fn


def _jax_rollout_cost(problem):
    def fn(x0, us):
        p = problem.replace(x0=x0)
        xs = p.rollout(us)
        return xs, jnp.sum(p.calc(xs, us)[1])
    return jax.jit(fn)


def _same(got, want, rtol=1e-12):
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g.detach()), np.asarray(w),
                                   rtol=rtol, atol=0)


def test_export_calc_round_trip():
    from crocoddyl_tpu.models.unicycle import UnicycleModel as JaxUnicycle
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    from crocoddyl_tpu_torch.utils import aot
    m, jm = UnicycleModel(), JaxUnicycle()
    jcalc = jax.jit(jm.calc)
    _, _, x, u = (torch.tensor(a) for a in _inputs(0))
    data = aot.export_bytes(m.calc, x, u)
    assert isinstance(data, bytes) and len(data) > 100
    g = aot.import_bytes(data)
    for seed in (0, 1):
        _, _, x, u = _inputs(seed)
        tx, tu = torch.tensor(x), torch.tensor(u)
        got = g(tx, tu)
        _same(got, m.calc(tx, tu))
        _same(got, jcalc(jnp.asarray(x), jnp.asarray(u)))


def test_export_rollout_cost_round_trip():
    from crocoddyl_tpu_torch.utils import aot
    fn = _port_rollout_cost(_port_problem())
    jfn = _jax_rollout_cost(_jax_problem())
    x0, us, _, _ = (torch.tensor(a) for a in _inputs(0))
    g = aot.import_bytes(aot.export_bytes(fn, x0, us))
    for seed in (0, 2):
        x0, us, _, _ = _inputs(seed)
        got = g(torch.tensor(x0), torch.tensor(us))
        assert got[0].shape == (T + 1, 3)
        _same(got, fn(torch.tensor(x0), torch.tensor(us)))
        _same(got, jfn(jnp.asarray(x0), jnp.asarray(us)))


def test_export_of_a_whole_solve_raises():
    """A solve's regularization ladder and line search read tensor values
    on the host: ``export_bytes`` refuses it, and saves nothing."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    from crocoddyl_tpu_torch.utils import aot
    problem = _port_problem()

    def solve_cost(x0):
        return solve(problem.replace(x0=x0), settings=SolverSettings(
            maxiter=20, record_trace=False), device="cpu").cost

    with pytest.raises(ValueError, match="branches on tensor values"):
        aot.export_bytes(solve_cost, problem.x0)


def test_precompile_executes():
    from crocoddyl_tpu_torch import SolverSettings, solve
    from crocoddyl_tpu_torch.utils import aot
    problem = _port_problem()

    def solve_cost(x0):
        return solve(problem.replace(x0=x0), settings=SolverSettings(
            maxiter=20, record_trace=False), device="cpu").cost

    x0 = problem.x0
    compiled = aot.precompile(solve_cost, x0)
    assert float(compiled(x0)) == float(solve_cost(x0))
