"""The port's ahead-of-time layer (crocoddyl_tpu_torch/utils/aot.py:
``torch.export`` in place of ``jax.export``) against the eager functions
and the JAX package, float64 on the CPU:

- the export/import round trip of the unicycle's ``calc`` and of a
  problem's rollout and cost from ``(x0, us)`` (the tape the reference's
  ActionModelCodeGen records, core/codegen/action-base.hpp): the eager
  function's results and JAX's same function's at rtol 1e-12, at the
  example arguments and at others of the same shapes;
- the round trip of a whole ``solve`` (the unicycle of
  tests/test_aot.py:30-42, whose JAX solve that test exports): the loaded
  program against the eager port solve (rtol 1e-12) and against JAX's
  (the ROADMAP bar); tests/test_torch_solve.py does the same for the
  reduced walk's replans and batch step;
- what ``export_bytes`` refuses, with a ValueError that names it: an
  ``iter_callback``, and the node kinds whose derivatives go through
  ``torch.func`` transforms;
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


SOLVE_FIELDS = ("cost", "iter", "steplength", "is_feasible", "converged",
                "diverged", "xreg", "stop", "xs", "us", "K")


def _port_solve(problem, settings):
    """x0 -> the fields SOLVE_FIELDS and the trace's cost column of the
    port's solve from x0."""
    from crocoddyl_tpu_torch import solve

    def fn(x0):
        sol = solve(problem.replace(x0=x0), settings=settings, device="cpu")
        return tuple(getattr(sol, f) for f in SOLVE_FIELDS) + (
            sol.trace.cost,)
    return fn


@jax.jit
def _jax_solve(x0):
    """JAX's solve of tests/test_aot.py's ``_solve_cost`` (the unicycle,
    T=10, maxiter=20): (cost, iter, us)."""
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    m = UnicycleModel()
    prob = ct.ShootingProblem(x0=x0, running=ct.replicate_model(m, T),
                              terminal=m)
    sol = ct.solve(prob, settings=ct.SolverSettings(maxiter=20,
                                                    record_trace=False))
    return sol.cost, sol.iter, sol.us


def test_export_solve_round_trip():
    """The whole unicycle solve of tests/test_aot.py:30-42 (T=10,
    maxiter=20) through ``export_bytes``, ``torch.export.save`` and
    ``import_bytes``: its loops and branches are recorded, so the loaded
    program gives the eager port solve's decisions and values (rtol 1e-12,
    the trace's NaN columns past the last iteration included) at the
    example x0 and at another, and JAX's solve at the ROADMAP bar (same
    iteration count, cost rtol 1e-8, controls within 1e-6)."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.utils import aot
    problem = _port_problem()
    fn = _port_solve(problem, SolverSettings(maxiter=20))
    data = aot.export_bytes(fn, problem.x0)
    assert isinstance(data, bytes) and len(data) > 100
    g = aot.import_bytes(data)
    for seed in (None, 2):
        x0 = problem.x0 if seed is None else torch.tensor(_inputs(seed)[0])
        got, want = g(x0), fn(x0)
        for name, a, b in zip(SOLVE_FIELDS + ("trace.cost",), got, want):
            if a.is_floating_point():
                np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                           rtol=1e-12, atol=0, err_msg=name)
            else:
                assert torch.equal(a, b), name
        cost, it, us = _jax_solve(jnp.asarray(x0.numpy()))
        assert int(got[1]) == int(it) and bool(got[4])
        np.testing.assert_allclose(float(got[0]), float(cost), rtol=1e-8)
        assert float(np.max(np.abs(np.asarray(got[9]) - np.asarray(us)))) \
            < 1e-6


def test_export_refuses_iter_callback():
    """An ``iter_callback`` runs on the host: ``export_bytes`` refuses a
    solve that sets one, with a ValueError that says so."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.utils import aot
    problem = _port_problem()
    fn = _port_solve(problem, SolverSettings(
        maxiter=20, iter_callback=lambda it, cost, xs: None))
    with pytest.raises(ValueError, match="iter_callback"):
        aot.export_bytes(fn, problem.x0)


@pytest.mark.parametrize("kind", ["RigidBodyNode", "ImpulseNode"])
def test_export_refuses_nodes_with_torch_func_derivatives(kind):
    """The nodes whose derivatives go through ``torch.func`` transforms,
    which torch.export cannot record in a solve: a ``RigidBodyNode`` that
    the node kernel does not admit (the reduced walk with a FrameRotation
    cost on its running knots) and the true-impulse walk's
    ``ImpulseNode``.  ``export_bytes`` raises a ValueError that names the
    node kind; both solve eagerly."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.utils import aot
    if kind == "RigidBodyNode":
        from tests.test_torch_generic_node import _mixed_problems
        problem = _mixed_problems()["generic_running"]
    else:
        from tests.test_torch_segments import _torch_problem
        problem = _torch_problem("quad_walk")
        assert any(type(s).__name__ == kind for s in problem.segments)
    fn = _port_solve(problem, SolverSettings(maxiter=1))
    with pytest.raises(ValueError, match=f"cannot record an? {kind}"):
        aot.export_bytes(fn, problem.x0)


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
