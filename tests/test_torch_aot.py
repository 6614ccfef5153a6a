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
- the round trip of a solve over every node kind that takes its
  derivatives outside the node kernel (a generic ``RigidBodyNode`` running
  stack or terminal, the true-impulse walk's ``ImpulseNode``s, an
  ``ActionModel`` with the default AD derivatives): the loaded program
  against the eager port solve (the same decisions, cost rtol 1e-12);
- what ``export_bytes`` refuses, with a ValueError that names it: an
  ``iter_callback`` (a host callback, which ``jax.export`` refuses too);
- ``precompile`` returns a callable giving the eager result.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

T = 10


def _port_problem(m=None):
    from crocoddyl_tpu_torch import ShootingProblem, replicate_model
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    m = UnicycleModel() if m is None else m
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
    solve that sets one, with a ValueError that says so (``jax.export``
    refuses a host callback too)."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.utils import aot
    problem = _port_problem()
    fn = _port_solve(problem, SolverSettings(
        maxiter=20, iter_callback=lambda it, cost, xs: None))
    with pytest.raises(ValueError, match="iter_callback"):
        aot.export_bytes(fn, problem.x0)


def _node_kind_problem(case):
    """The problems of ``test_export_solve_round_trip_node_kinds``."""
    if case in ("generic_running", "generic_terminal"):
        from tests.test_torch_generic_node import _mixed_problems
        return _mixed_problems()[case]
    if case == "impulse_walk":
        from tests.test_torch_segments import _torch_problem
        return _torch_problem("quad_walk")
    from crocoddyl_tpu_torch import ActionModel
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel

    class ADUnicycle(UnicycleModel):
        calc_diff = ActionModel.calc_diff
        calc_diff_terminal = ActionModel.calc_diff_terminal
    return _port_problem(ADUnicycle())


DECISIONS = ("iter", "steplength", "is_feasible", "converged", "diverged",
             "xreg")


@pytest.mark.parametrize("case", ["generic_running", "generic_terminal",
                                  "impulse_walk", "ad_unicycle"])
def test_export_solve_round_trip_node_kinds(case):
    """``solve(maxiter=1)`` of a problem whose nodes take their derivatives
    outside the node kernel, through ``export_bytes``, ``torch.export.save``
    and ``import_bytes``: the reduced walk with a FrameRotation cost on
    every running knot (a generic ``RigidBodyNode`` running stack) or a
    FramePlacement cost on its terminal (a generic terminal), the reduced
    true-impulse walk (8 segments, ``ImpulseNode``s at the switch knots),
    and the unicycle at T=10 with ``ActionModel``'s default AD derivatives.
    The loaded program gives the eager port solve's decisions, its cost at
    rtol 1e-12 and every other field within 1e-12 of its max-abs, at the
    example x0.  The eager solves are held to JAX elsewhere: the generic
    node by tests/test_torch_generic_node.py::test_generic_node_matches_jax
    (and the mixed stacks to the all-generic evaluation by
    ``test_mixed_problem_keeps_kernel_on_admitted_stack``), the
    true-impulse walk's iteration by
    tests/test_torch_segments.py::test_segmented_walk_solve_matches_jax,
    the AD derivatives by
    tests/test_torch_solver_surface.py::test_derivatives_match_jax and
    their unicycle solve by ``test_unicycle_ad_derivatives_solve_matches_
    oracle`` there."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.ops import fused_node
    from crocoddyl_tpu_torch.utils import aot
    problem = _node_kind_problem(case)
    assert not problem.on_lanes
    assert any(not fused_node.supports(m)
               for m in (*problem.segments, problem.terminal))
    fn = _port_solve(problem, SolverSettings(maxiter=1))
    g = aot.import_bytes(aot.export_bytes(fn, problem.x0))
    got, want = g(problem.x0), fn(problem.x0)
    for name, a, b in zip(SOLVE_FIELDS + ("trace.cost",), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if name in DECISIONS or not a.is_floating_point():
            assert torch.equal(a, b), name
        elif name == "cost":
            np.testing.assert_allclose(float(a), float(b), rtol=1e-12,
                                       atol=0)
        else:
            assert float((a - b).abs().max()) <= 1e-12 * float(
                b.abs().max()), name


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
