"""The rest of the port's ``solve``: FDDP and DDP, Box-FDDP and Box-DDP, the
parallel and the sequential line search, the trace, the iteration callback
and ``polish``, on the unicycle and LQR anchors and on the reduced walk,
float64 on CPU.

- unicycle (T=20) and random LQR, FDDP and DDP, against the NumPy oracle
  of tests/oracle.py with the bar of tests/test_solvers_toy.py: the same
  ``iter`` and ``converged``, cost rtol 1e-9, xs within 1e-7, us within
  1e-6 (LQR: us, K within 1e-7, Vx, Vxx within 1e-6), the trace's cost
  rtol 5e-7 and steplength rtol 1e-12; the unicycle anchor with default
  settings: converged in 9 iterations at cost 249.56089793…;
- unicycle Box-FDDP and Box-DDP with |u| ≤ 1, each with the parallel and
  the sequential line search, against JAX ``solve``: ``iter``,
  ``steplength``, ``converged``, ``is_feasible`` and ``xreg`` equal, cost
  rtol 1e-9, us within 1e-8, the trace's columns within 1e-9 of their
  max-abs (feasible equal);
- ``DiffLQRModel`` and the AD default derivatives of ``ActionModel``
  against the JAX derivatives within 1e-10 of each block's max-abs; the
  unicycle solved through the AD derivatives against the oracle;
- on the reduced walk: which passes run under ``fused_scans=True``
  (kernels 4 and 5 through their dispatchers under DDP, the parallel line
  search and the trace; the generic passes under box), and the default
  settings' replan, through the generic passes and under
  ``fused_scans=True``, against the sequential replan that
  tests/test_torch_solve.py holds to JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import (jax_walk, max_rel, np_, solve_pair, t64,
                                 to_port, torch_walk)
from tests.oracle import lqr_oracle, unicycle_oracle

T = 20
X0 = [-1.0, -1.0, 1.0]
LQR = ("Fx", "Fu", "f0", "Lxx", "Lxu", "Luu", "lx", "lu")


def _unicycle(model=None):
    from crocoddyl_tpu_torch import ShootingProblem, replicate_model
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    m = model if model is not None else UnicycleModel()
    return ShootingProblem(x0=t64(X0), running=replicate_model(m, T),
                           terminal=m)


def _against_oracle(sol, oracle, ok):
    assert bool(sol.converged) == ok
    assert int(sol.iter) == oracle.iter
    np.testing.assert_allclose(np_(sol.cost), oracle.cost, rtol=1e-9)
    np.testing.assert_allclose(np_(sol.xs), oracle.xs, atol=1e-7)
    np.testing.assert_allclose(np_(sol.us), oracle.us, atol=1e-6)
    for i, row in enumerate(oracle.trace):
        np.testing.assert_allclose(np_(sol.trace.cost[i]), row["cost"],
                                   rtol=5e-7)
        np.testing.assert_allclose(np_(sol.trace.steplength[i]),
                                   row["steplength"], rtol=1e-12)


@pytest.mark.parametrize("fd", [True, False], ids=["fddp", "ddp"])
def test_unicycle_matches_oracle(fd):
    from crocoddyl_tpu_torch import SolverSettings, solve
    sol = solve(_unicycle(), settings=SolverSettings(
        maxiter=30, feasibility_driven=fd), device="cpu")
    oracle = unicycle_oracle(np.asarray(X0), T, feasibility_driven=fd)
    _against_oracle(sol, oracle, oracle.solve(maxiter=30))


def test_unicycle_anchor_default_settings():
    """The anchor of the verify notes: SolverSettings() but maxiter=50."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    prob = _unicycle()
    sol = solve(prob, settings=SolverSettings(maxiter=50), device="cpu")
    assert bool(sol.converged) and int(sol.iter) == 9
    np.testing.assert_allclose(float(sol.cost), 249.56089793082, rtol=1e-11)
    assert np.isnan(np_(sol.trace.cost[9:])).all()
    assert not np_(sol.trace.feasible[9:]).any()
    # the problem's own evaluation of the returned (feasible) trajectory
    xnext, costs = prob.calc(sol.xs, sol.us)
    np.testing.assert_allclose(float(costs.sum()), float(sol.cost),
                               rtol=1e-12)
    assert max_rel(sol.xs, prob.rollout(sol.us)) < 1e-12
    assert max_rel(sol.xs[1:], xnext) < 1e-12
    derivs, dterm = prob.calc_diff(sol.xs, sol.us)
    assert derivs.Fu.shape == (T, 3, 2) and dterm.Lxx.shape == (3, 3)


@pytest.mark.parametrize("fd", [True, False], ids=["fddp", "ddp"])
def test_random_lqr_matches_oracle(fd):
    from crocoddyl_tpu_torch import (ShootingProblem, SolverSettings,
                                     replicate_model, solve)
    from crocoddyl_tpu_torch.models.lqr import random_lqr_model
    nx, nu, horizon = 5, 2, 15
    m = random_lqr_model(np.random.default_rng(0), nx, nu)
    prob = ShootingProblem(x0=torch.full((nx,), 0.5, dtype=torch.float64),
                           running=replicate_model(m, horizon), terminal=m)
    sol = solve(prob, settings=SolverSettings(maxiter=20,
                                              feasibility_driven=fd),
                device="cpu")
    oracle = lqr_oracle({k: np_(getattr(m, k)) for k in LQR},
                        np.full((nx,), 0.5), horizon, feasibility_driven=fd)
    ok = oracle.solve(maxiter=20)
    assert bool(sol.converged) == ok
    assert int(sol.iter) == oracle.iter
    np.testing.assert_allclose(np_(sol.cost), oracle.cost, rtol=1e-9)
    np.testing.assert_allclose(np_(sol.us), oracle.us, atol=1e-7)
    np.testing.assert_allclose(np_(sol.K), oracle.K, atol=1e-7)
    np.testing.assert_allclose(np_(sol.Vx), oracle.Vx, atol=1e-6)
    np.testing.assert_allclose(np_(sol.Vxx), oracle.Vxx, atol=1e-6)


@pytest.mark.parametrize("parallel", [True, False],
                         ids=["parallel", "sequential"])
@pytest.mark.parametrize("fd", [True, False], ids=["boxfddp", "boxddp"])
def test_unicycle_box_matches_jax(fd, parallel):
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.core.solvers import fddp as jfddp
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    from crocoddyl_tpu_torch.core.solvers import fddp
    make = ((jfddp.box_fddp_settings, fddp.box_fddp_settings) if fd
            else (jfddp.box_ddp_settings, fddp.box_ddp_settings))
    kw = dict(maxiter=50, parallel_linesearch=parallel)
    m = UnicycleModel()
    jprob = ct.ShootingProblem(x0=jnp.asarray(X0),
                               running=ct.replicate_model(m, T), terminal=m)
    ref = ct.solve(jprob, settings=make[0](**kw), u_lb=-jnp.ones(2),
                   u_ub=jnp.ones(2))
    out = fddp.solve(to_port(jprob), settings=make[1](**kw),
                     u_lb=-torch.ones(2), u_ub=torch.ones(2), device="cpu")
    for name in ("iter", "steplength", "converged", "is_feasible", "xreg"):
        assert np_(getattr(out, name)) == np.asarray(getattr(ref, name)), name
    np.testing.assert_allclose(np_(out.cost), np.asarray(ref.cost),
                               rtol=1e-9)
    assert np.max(np.abs(np_(out.us) - np.asarray(ref.us))) < 1e-8
    assert np.max(np.abs(np_(out.us))) == 1.0       # the bounds bind
    n = int(ref.iter)
    for name in ("cost", "stop", "grad", "xreg", "ureg", "steplength"):
        a = np.asarray(getattr(ref.trace, name))
        b = np_(getattr(out.trace, name))
        assert np.isnan(b[n:]).all() and np.isnan(a[n:]).all(), name
        assert max_rel(a[:n], b[:n]) < 1e-9, name
    np.testing.assert_array_equal(np_(out.trace.feasible),
                                  np.asarray(ref.trace.feasible))


def _lanes_to_np(d):
    return {f: np_(getattr(d, f)) for f in ("Fx", "Fu", "Lx", "Lu", "Lxx",
                                            "Lxu", "Luu")}


@pytest.mark.parametrize("model", ["diff_lqr", "diff_lqr_terminal",
                                   "ad_unicycle", "ad_diff_lqr"])
def test_derivatives_match_jax(model):
    """The closed forms of DiffLQRModel (and its dt=0 terminal) and the AD
    default of ActionModel (called on the unicycle and on DiffLQRModel in
    place of their closed forms) against the JAX derivatives."""
    from crocoddyl_tpu.core.action import ActionModel as JA
    from crocoddyl_tpu.models.lqr import diff_lqr_model
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    from crocoddyl_tpu_torch.core.action import ActionModel as TA
    rng = np.random.default_rng(7)
    if "unicycle" in model:
        jm = UnicycleModel()
        nx, nu = 3, 2
    else:
        jm = diff_lqr_model(3, 2, dt=0.0 if "terminal" in model else 0.1)
        jm = jm.replace(Fq=jnp.asarray(rng.standard_normal((3, 3))),
                        Lxu=jnp.asarray(rng.standard_normal((6, 2))))
        nx, nu = 6, 2
    tm = to_port(jm)
    x, u = rng.standard_normal(nx), rng.standard_normal(nu)
    if model.startswith("ad_"):
        ref = jax.jit(JA.calc_diff)(jm, jnp.asarray(x), jnp.asarray(u))
        out = TA.calc_diff(tm, t64(x), t64(u))
    else:
        ref = jax.jit(type(jm).calc_diff)(jm, jnp.asarray(x), jnp.asarray(u))
        out = tm.calc_diff(t64(x), t64(u))
    for name, b in _lanes_to_np(out).items():
        a = np.asarray(getattr(ref, name))
        assert b.shape == a.shape, name
        assert np.max(np.abs(a - b)) <= 1e-10 * max(np.max(np.abs(a)),
                                                     1.0), name
    xn_r, c_r = jax.jit(type(jm).calc)(jm, jnp.asarray(x), jnp.asarray(u))
    xn, c = tm.calc(t64(x), t64(u))
    assert max_rel(xn_r, xn) < 1e-14 and max_rel(c_r, c) < 1e-14


def test_unicycle_ad_derivatives_solve_matches_oracle():
    """A unicycle whose derivatives come from the AD default goes through
    the generic path (vmapped calc_both over the knots) to the oracle's
    solution: its residuals are linear, so the Gauss-Newton closed form
    and the exact Hessian agree."""
    from crocoddyl_tpu_torch import ActionModel, SolverSettings, solve
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel

    class ADUnicycle(UnicycleModel):
        calc_diff = ActionModel.calc_diff
        calc_diff_terminal = ActionModel.calc_diff_terminal

    sol = solve(_unicycle(ADUnicycle()), settings=SolverSettings(maxiter=30),
                device="cpu")
    oracle = unicycle_oracle(np.asarray(X0), T)
    _against_oracle(sol, oracle, oracle.solve(maxiter=30))


def test_iter_callback_trace_and_polish(tmp_path):
    """``iter_callback`` once per iteration with the trace's cost; the
    trace's table and the saved solution; ``polish`` of a float32 solve."""
    from crocoddyl_tpu_torch import SolverSettings, polish, solve
    from crocoddyl_tpu_torch.utils import callbacks
    from crocoddyl_tpu_torch.utils.casting import cast_floats
    calls = []
    sol = solve(_unicycle(), settings=SolverSettings(
        maxiter=50, iter_callback=lambda i, c, xs: calls.append(
            (i, float(c), tuple(xs.shape)))), device="cpu")
    n = int(sol.iter)
    assert [c[0] for c in calls] == list(range(n))
    assert all(c[2] == (T + 1, 3) for c in calls)
    np.testing.assert_array_equal([c[1] for c in calls],
                                  np_(sol.trace.cost[:n]))
    table = callbacks.format_trace(sol.trace, sol.iter).splitlines()
    assert table[0] == callbacks.HEADER and len(table) == n + 1
    log = callbacks.SolverLog()
    log.append(sol)
    assert log.iters == [n] and log.costs == [float(sol.cost)]
    callbacks.save_solution(str(tmp_path / "sol.pkl"), sol)
    back = callbacks.load_solution(str(tmp_path / "sol.pkl"))
    np.testing.assert_array_equal(back["us"], np_(sol.us))
    np.testing.assert_array_equal(back["trace"]["cost"], np_(sol.trace.cost))
    names = callbacks.save_solution_csv(str(tmp_path / "uni"), sol, dt=0.1)
    assert np.loadtxt(names[1], delimiter=",", skiprows=1).shape == (T, 3)
    sol32 = solve(cast_floats(_unicycle(), torch.float32),
                  settings=SolverSettings(maxiter=50, th_stop=1e-6),
                  device="cpu")
    assert sol32.cost.dtype == torch.float32
    pol = polish(_unicycle(), sol32, device="cpu")
    assert pol.cost.dtype == torch.float64 and int(pol.iter) <= 2
    np.testing.assert_allclose(float(pol.cost), float(sol.cost), rtol=1e-9)


@pytest.mark.parametrize("case", ["ddp", "parallel", "trace", "box",
                                  "default"])
def test_walk_dispatch(case, monkeypatch):
    """Kernel 1 linearizes the walk on every path; under
    ``fused_scans=True`` kernels 4 and 5 run (through their dispatchers,
    which take the plain versions on the CPU) unless there are bounds; the
    generic passes run under bounds and with the default
    ``fused_scans=False`` (fddp.py:556-561)."""
    import crocoddyl_tpu_torch as ctt
    from crocoddyl_tpu_torch.core.solvers import fddp
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    counts = {}

    def count(mod, name):
        orig = getattr(mod, name)

        def wrapper(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return orig(*a, **k)
        monkeypatch.setattr(mod, name, wrapper)
    count(fn, "calc_both_lanes")
    for name in ("riccati_backward_fused", "trial_rollout_fused"):
        count(fsc, name)
    for name in ("_backward_pass", "_forward_pass"):
        count(fddp, name)
    prob = torch_walk()
    xs0 = prob.x0[None].expand(prob.T + 1, -1)
    us0 = prob.quasi_static(xs0)
    settings = {
        "ddp": ctt.ddp_settings(maxiter=1, parallel_linesearch=False,
                                record_trace=False, fused_scans=True),
        "parallel": ctt.SolverSettings(maxiter=1, record_trace=False,
                                       fused_scans=True),
        "trace": ctt.SolverSettings(maxiter=1, parallel_linesearch=False,
                                    fused_scans=True),
        "box": ctt.box_fddp_settings(maxiter=1, fused_scans=True),
        "default": ctt.SolverSettings(maxiter=1, parallel_linesearch=False,
                                      record_trace=False)}[case]
    kw = {}
    if case == "box":
        lim = 0.15 * prob.state.model.effort_limit[6:]
        kw = dict(u_lb=-lim, u_ub=lim, is_feasible=True)
        xs0 = prob.rollout(us0)
    plain = (fsc.riccati_backward_fused_plain, fsc.trial_rollout_fused_plain)
    before = [f.calls for f in plain]
    sol = ctt.solve(prob, xs0, us0, settings, device="cpu", **kw)
    assert bool(torch.isfinite(sol.cost))
    assert counts["calc_both_lanes"] >= 1
    kernels = [counts.get(n, 0) for n in ("riccati_backward_fused",
                                          "trial_rollout_fused")]
    generic = [counts.get(n, 0) for n in ("_backward_pass", "_forward_pass")]
    if case in ("box", "default"):
        assert kernels == [0, 0] and min(generic) >= 1, counts
    else:
        assert min(kernels) >= 1 and generic == [0, 0], counts
        assert [f.calls - b for f, b in zip(plain, before)] == kernels
    assert (sol.trace is None) == (not settings.record_trace)


@pytest.mark.parametrize("fused_scans", [False, True],
                         ids=["default", "fused_scans"])
def test_walk_default_settings_replan(fused_scans, solve_cache):  # noqa: F811
    """``SolverSettings(maxiter=1)`` (the parallel line search and the
    trace) on the reduced walk, through the generic passes (the default)
    and through kernels 4 and 5 (``fused_scans=True``: their plain versions
    here, the parallel search one kernel-5 trial at a time), takes the step
    of the sequential replan that tests/test_torch_solve.py holds to JAX
    (that one's port solve ran in another process, from a warm start that
    XLA computed there: the bar of ``_same_solution``), and its trace's
    first row is the solution's."""
    import crocoddyl_tpu_torch as ctt
    from tests.test_torch_solve import _same_solution
    ref = solve_pair("solve", 1, solve_cache)[1]
    prob, xs0, us0, _ = jax_walk()
    sol = ctt.solve(to_port(prob), t64(xs0), t64(us0),
                    ctt.SolverSettings(maxiter=1, fused_scans=fused_scans),
                    device="cpu")
    _same_solution(ref, sol, ("iter", "steplength", "is_feasible", "xreg"))
    tr = sol.trace
    row = [float(getattr(tr, f)[0]) for f in ("cost", "stop", "grad", "xreg",
                                              "ureg", "steplength")]
    assert row == [float(sol.cost), float(sol.stop), -float(sol.d1),
                   float(sol.xreg), float(sol.ureg), float(sol.steplength)]
    assert bool(tr.feasible[0]) == bool(sol.is_feasible)
    assert tr.cost.shape == (1,)
