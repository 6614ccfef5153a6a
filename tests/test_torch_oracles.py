"""The last settings of ``solve`` and the two oracles of the port against
the JAX package, float64 on the CPU:

- ``parallel_riccati.backward_pass_parallel`` on derivatives drawn with
  numpy (the shapes of tests/test_parallel_riccati.py), with and without
  gaps and xreg: JAX's at 1e-10 of each output's max-abs, and the port's
  sequential pass at JAX's own bars (1e-8; 1e-7 with xreg);
- ``_forward_pass_ms`` on the unicycle of tests/test_ms_forward.py
  (T=29, ``ms_chunk=7``: four chunks and a remainder): JAX's at 1e-10;
  with one chunk of the whole horizon it is the sequential
  ``_forward_pass`` (1e-12), on the unicycle and on the reduced walk;
- ``solve`` on the unicycle anchors with ``ms_chunk=8`` and with
  ``parallel_riccati=True`` against the sequential solve at the bars of
  tests/test_ms_forward.py:60-80 and tests/test_parallel_riccati.py:80-95;
- ``kkt.solve`` on the LQR and unicycle problems of tests/test_kkt_box.py:
  JAX's iterations, cost (1e-10 relative) and trajectories (1e-8); one
  dense KKT step on the true-impulse walk (8 segments) against the
  Riccati gains of the port's sequential pass without regularization;
- ``utils/numdiff`` (action, state, actuation, activation, contact) at
  h = 1e-3: JAX's differences at 1e-8 of their max-abs (the models agree
  to rounding, which a difference divides by h, a second one by h²).

The JAX references run in child processes (``start_references``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import (max_rel, np_, reference, start_references,
                                 t64, to_port, torch_walk)

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
OUTS = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")
# {case: (T, ndx, nu, seed, gaps, xreg, ureg)}: tests/test_parallel_riccati.py
RICCATI = {"no_gaps": (23, 7, 3, 0, False, 0.0, 1e-9),
           "gaps": (23, 7, 3, 0, True, 0.0, 1e-9),
           "xreg": (11, 5, 2, 3, False, 1e-3, 1e-3)}
# the differences' step against JAX's: the two packages' models agree to
# rounding (~1e-16 of their values), which a first difference multiplies
# by 1/h and a second one by 1/h², so at h = 1e-3 the two implementations
# agree to ~1e-10 of the values
H = 1e-3
NUMDIFF = ("action", "state", "actuation", "activation", "contact")


# ---------------------------------------------------------------------------
# Inputs, the same in both packages
# ---------------------------------------------------------------------------

def _random_derivs(case):
    """(derivs, dterm, fs) as numpy dicts: the construction of
    tests/test_parallel_riccati.py:22-42, drawn with numpy."""
    T, ndx, nu, seed, gaps, _, _ = RICCATI[case]
    rng = np.random.default_rng(seed)
    n = rng.standard_normal
    A = n((T, ndx, ndx))
    B = n((T, nu, nu))
    run = dict(Fx=np.eye(ndx) + 0.1 * n((T, ndx, ndx)),
               Fu=0.3 * n((T, ndx, nu)), Lx=n((T, ndx)), Lu=n((T, nu)),
               Lxx=A @ A.swapaxes(-1, -2) + 0.5 * np.eye(ndx),
               Lxu=0.1 * n((T, ndx, nu)),
               Luu=B @ B.swapaxes(-1, -2) + np.eye(nu))
    At = n((ndx, ndx))
    term = dict(Fx=np.eye(ndx), Fu=np.zeros((ndx, nu)), Lx=np.ones(ndx),
                Lu=np.zeros(nu), Lxx=At @ At.T + np.eye(ndx),
                Lxu=np.zeros((ndx, nu)), Luu=np.zeros((nu, nu)))
    fs = 0.1 * n((T + 1, ndx)) if gaps else np.zeros((T + 1, ndx))
    return run, term, fs


def _jax_unicycle(T, **kw):
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    m = UnicycleModel(**kw)
    return ct.ShootingProblem(x0=jnp.asarray([-1.0, -1.0, 1.0]),
                              running=ct.replicate_model(m, T), terminal=m)


def _ms_problem():
    """tests/test_ms_forward.py:18-22 at T=29."""
    return _jax_unicycle(29, dt=jnp.asarray(0.1),
                         cost_weights=jnp.asarray([10., 1.]))


def _ms_inputs(T):
    """(xs, us, k, K) around the unicycle's x0, drawn with numpy."""
    rng = np.random.default_rng(11)
    xs = np.array([-1.0, -1.0, 1.0]) + 0.1 * rng.standard_normal((T + 1, 3))
    return (xs, 0.1 * rng.standard_normal((T, 2)),
            0.05 * rng.standard_normal((T, 2)),
            0.05 * rng.standard_normal((T, 2, 3)))


@functools.lru_cache(maxsize=None)
def _kkt_problem(case):
    """tests/test_kkt_box.py:20-30."""
    if case == "unicycle":
        return _jax_unicycle(20)
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.models.lqr import random_lqr_model
    m = random_lqr_model(jax.random.PRNGKey(0), 4, 2)
    return ct.ShootingProblem(x0=jnp.full((4,), 0.3),
                              running=ct.replicate_model(m, 10), terminal=m)


KKT_ITERS = {"lqr": 20, "unicycle": 60}


def _numdiff_case(kind, pkg):
    """(function, arguments) of one numdiff check in the JAX package
    (``pkg`` "jax") or the port ("torch"), at numpy-seeded points: the
    unicycle action, the quadruped state, its floating-base actuation, a
    weighted barrier activation and a point contact."""
    rng = np.random.default_rng(13)
    if pkg == "jax":
        from crocoddyl_tpu.dynamics import robots
        from crocoddyl_tpu.dynamics.states import StateMultibody
        from crocoddyl_tpu.models.multibody import activations, actuations
        from crocoddyl_tpu.models.multibody.contacts import Contact3D
        from crocoddyl_tpu.models.unicycle import UnicycleModel
        from crocoddyl_tpu.utils import numdiff
        arr = jnp.asarray
        m = robots.quadruped()
        q = np.asarray(robots.quadruped_standing_q(m))
    else:
        from crocoddyl_tpu_torch.dynamics import robots
        from crocoddyl_tpu_torch.dynamics.states import StateMultibody
        from crocoddyl_tpu_torch.models.multibody import (activations,
                                                          actuations)
        from crocoddyl_tpu_torch.models.multibody.contacts import Contact3D
        from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
        from crocoddyl_tpu_torch.utils import numdiff
        arr = t64
        m = robots.quadruped()
        q = robots.quadruped_standing_q(m).numpy()
    if kind == "action":
        return numdiff.numdiff_action, (
            UnicycleModel(), arr(rng.standard_normal(3)),
            arr(rng.standard_normal(2)), H)
    nv = m.nv
    x = np.concatenate([q, 0.3 * rng.standard_normal(nv)])
    x[:3] += 0.05 * rng.standard_normal(3)
    if kind == "state":
        x1 = x.copy()
        x1[7:] += 0.1 * rng.standard_normal(x.size - 7)
        return numdiff.numdiff_state, (StateMultibody(model=m), arr(x),
                                       arr(x1), H)
    if kind == "actuation":
        return numdiff.numdiff_actuation, (
            actuations.FloatingBaseActuation(nv=nv), arr(x),
            arr(rng.standard_normal(nv - 6)), H)
    if kind == "activation":
        n = 6
        return numdiff.numdiff_activation, (
            activations.ActivationWeightedQuadraticBarrier(
                lb=arr(-0.5 * np.ones(n)), ub=arr(0.5 * np.ones(n)),
                weights=arr(1.0 + np.arange(n))),
            arr(rng.standard_normal(n)), H)
    c = Contact3D(fid=m.frame_id("LF_FOOT"), pref=arr([0.3, 0.2, 0.0]),
                  gains=arr([10.0, 4.0]), active=arr(1.0))
    return numdiff.numdiff_contact, (c, StateMultibody(model=m), arr(x),
                                     arr(0.5 * rng.standard_normal(nv)), H)


def _flat(out):
    """A numdiff result (derivatives, a tuple or one array) as {name:
    array}."""
    if hasattr(out, "Fx"):
        return {f: np.asarray(np_(getattr(out, f))) for f in FIELDS}
    if isinstance(out, tuple):
        return {str(i): np.asarray(np_(o)) for i, o in enumerate(out)}
    return {"0": np.asarray(np_(out))}


# ---------------------------------------------------------------------------
# JAX references computed in child processes
# ---------------------------------------------------------------------------

def jax_reference(job):
    """The JAX side of one job (the child of ``start_references`` calls
    this): "solvers" the parallel Riccati passes, the multiple-shooting
    rollout and the KKT solves; "numdiff" the finite differences."""
    from crocoddyl_tpu.core.action import NodeDerivs
    from crocoddyl_tpu.core.solvers import fddp, kkt
    from crocoddyl_tpu.core.solvers.parallel_riccati import (
        backward_pass_parallel)
    out = {}
    if job == "numdiff":
        for kind in NUMDIFF:
            fn, args = _numdiff_case(kind, "jax")
            out.update({f"{kind}.{k}": v
                        for k, v in _flat(fn(*args)).items()})
        return out
    for case, (_, _, _, _, _, xreg, ureg) in RICCATI.items():
        run, term, fs = _random_derivs(case)
        res = jax.jit(backward_pass_parallel)(
            NodeDerivs(**{k: jnp.asarray(v) for k, v in run.items()}),
            NodeDerivs(**{k: jnp.asarray(v) for k, v in term.items()}),
            jnp.asarray(fs), jnp.asarray(xreg), jnp.asarray(ureg))
        out.update({f"par.{case}.{n}": v for n, v in zip(OUTS, res)})
        out[f"par.{case}.failed"] = res[-1]
    prob = _ms_problem()
    xs, us, k, K = (jnp.asarray(a) for a in _ms_inputs(prob.T))
    _, _, fs, _ = fddp._calc_diff(prob, xs, us, jnp.zeros((), bool))
    out["ms.fs"] = fs
    ms = jax.jit(lambda a: fddp._forward_pass_ms(prob, xs, us, k, K, fs, a,
                                                 ms_chunk=7))
    for a in (1.0, 0.5):
        out.update({f"ms{a}.{n}": v for n, v in zip(
            ("xs", "us", "cost", "failed"), ms(jnp.asarray(a)))})
    for case, maxiter in KKT_ITERS.items():
        sol = kkt.solve(_kkt_problem(case), maxiter=maxiter)
        out.update({f"kkt.{case}.{f}": getattr(sol, f) for f in (
            "xs", "us", "cost", "stop", "iter", "converged")})
    return {k: np.asarray(v) for k, v in out.items()}


JOBS = {job: f"tests.test_torch_oracles:jax_reference:{job}"
        for job in ("solvers", "numdiff")}


@pytest.fixture(scope="module", autouse=True)
def _references(solve_cache):  # noqa: F811
    start_references(JOBS.values(), solve_cache)
    return solve_cache


# ---------------------------------------------------------------------------
# The associative-scan Riccati pass
# ---------------------------------------------------------------------------

def _torch_derivs(case):
    from crocoddyl_tpu_torch.core.action import NodeDerivs
    run, term, fs = _random_derivs(case)
    return (NodeDerivs(**{k: t64(v) for k, v in run.items()}),
            NodeDerivs(**{k: t64(v) for k, v in term.items()}), t64(fs))


@pytest.mark.parametrize("case", list(RICCATI))
def test_backward_pass_parallel_matches_jax(case, _references):
    """The associative scan combines in ``lax.associative_scan``'s order:
    every output within 1e-10 of its max-abs, the same failure flag."""
    from crocoddyl_tpu_torch.core.solvers.parallel_riccati import (
        backward_pass_parallel)
    ref = reference(JOBS["solvers"], _references)
    xreg, ureg = RICCATI[case][5:]
    res = backward_pass_parallel(*_torch_derivs(case), xreg, ureg)
    for n, got in zip(OUTS, res):
        assert max_rel(ref[f"par.{case}.{n}"], got) < 1e-10, n
    assert bool(res[-1]) == bool(ref[f"par.{case}.failed"])
    assert not bool(res[-1])


@pytest.mark.parametrize("case", list(RICCATI))
def test_backward_pass_parallel_matches_sequential(case):
    """The parallel pass is an exact reformulation of the sequential one:
    tests/test_parallel_riccati.py's bars (rtol = atol = 1e-8, 1e-7 with
    xreg folded into the knots' Lxx)."""
    from crocoddyl_tpu_torch.core.solvers import fddp
    from crocoddyl_tpu_torch.core.solvers.parallel_riccati import (
        backward_pass_parallel)
    xreg, ureg = RICCATI[case][5:]
    args = _torch_derivs(case)
    seq = fddp._backward_pass(*args, xreg, ureg)
    par = backward_pass_parallel(*args, xreg, ureg)
    tol = 1e-7 if xreg else 1e-8
    n = 5 if xreg else 6
    for name, a, b in zip(OUTS[:n], seq, par):
        torch.testing.assert_close(b, a, rtol=tol, atol=tol, msg=name)
    assert not bool(par[-1])


# ---------------------------------------------------------------------------
# The multiple-shooting rollout and the solver settings
# ---------------------------------------------------------------------------

def test_forward_pass_ms_matches_jax(_references):
    """``ms_chunk=7`` on T=29: four chunks of 7 rolled out as rows and a
    remainder of 1, each from integrate(xs[t0], fs[t0]): 1e-10 at α = 1
    and 0.5 (one pass, the step lengths as rows)."""
    from crocoddyl_tpu_torch.core.solvers import fddp
    ref = reference(JOBS["solvers"], _references)
    prob = to_port(_ms_problem())
    xs, us, k, K = (t64(a) for a in _ms_inputs(prob.T))
    _, _, fs, _ = fddp._calc_diff(prob, xs, us, False)
    assert max_rel(ref["ms.fs"], fs) < 1e-12
    out = fddp._forward_pass_ms(prob, xs, us, k, K, fs, [1.0, 0.5], 7)
    for i, a in enumerate((1.0, 0.5)):
        for j, n in enumerate(("xs", "us", "cost")):
            assert max_rel(ref[f"ms{a}.{n}"], out[j][i]) < 1e-10, (a, n)
        assert bool(out[3][i]) == bool(ref[f"ms{a}.failed"])
    assert out[0].shape == (2, prob.T + 1, 3)


@pytest.mark.parametrize("problem", ["unicycle", "walk"])
def test_forward_pass_ms_single_chunk_equals_sequential(problem):
    """One chunk over the whole horizon starts from integrate(xs[0], fs[0])
    = x0: the sequential rollout within 1e-12 of each output's max-abs
    (tests/test_ms_forward.py:25-46), at the gaps of an infeasible
    candidate."""
    from crocoddyl_tpu_torch.core.solvers import fddp
    if problem == "unicycle":
        prob = to_port(_jax_unicycle(30, dt=jnp.asarray(0.1),
                                     cost_weights=jnp.asarray([10., 1.])))
        xs, us, k, K = (t64(a) for a in _ms_inputs(prob.T))
    else:
        prob = torch_walk()
        rng = np.random.default_rng(12)
        xs = prob.x0[None].repeat(prob.T + 1, 1)
        us = prob.quasi_static(xs)
        xs[:, :3] += t64(1e-3 * rng.standard_normal((prob.T + 1, 3)))
        k = t64(0.05 * rng.standard_normal((prob.T, prob.nu)))
        K = t64(1e-3 * rng.standard_normal((prob.T, prob.nu,
                                            prob.state.ndx)))
    _, _, fs, _ = fddp._calc_diff(prob, xs, us, False)
    assert fs.abs().max() > 0
    ref = fddp._forward_pass(prob, xs, us, k, K, fs, [1.0, 0.5])
    got = fddp._forward_pass_ms(prob, xs, us, k, K, fs, [1.0, 0.5], prob.T)
    for a, b in zip(ref, got):
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            assert max_rel(a, b) < 1e-12


@pytest.mark.parametrize("setting", ["ms_chunk", "parallel_riccati"])
def test_unicycle_solve_settings(setting):
    """The unicycle anchors: ``ms_chunk=8`` at T=40 converges like the
    sequential solve (tests/test_ms_forward.py:60-80: gaps below 1e-3, cost
    rtol 1e-4, us atol 1e-2); ``parallel_riccati=True`` at T=20 meets the
    anchor (True 9 249.5608979…; cost rtol 1e-9, us atol 1e-6,
    tests/test_parallel_riccati.py:80-95)."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    if setting == "ms_chunk":
        prob = to_port(_jax_unicycle(40, dt=jnp.asarray(0.1),
                                     cost_weights=jnp.asarray([10., 1.])))
        base = solve(prob, settings=SolverSettings(
            maxiter=60, record_trace=False), device="cpu")
        got = solve(prob, settings=SolverSettings(
            maxiter=60, record_trace=False, ms_chunk=8, th_stop=1e-3,
            th_gaptol=1e-4), device="cpu")
        assert bool(base.converged) and bool(got.converged)
        assert float(got.fs.abs().max()) < 1e-3
        np.testing.assert_allclose(float(got.cost), float(base.cost),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np_(got.us), np_(base.us), atol=1e-2)
        return
    prob = to_port(_jax_unicycle(20))
    base = solve(prob, settings=SolverSettings(
        maxiter=50, record_trace=False), device="cpu")
    got = solve(prob, settings=SolverSettings(
        maxiter=50, record_trace=False, parallel_riccati=True), device="cpu")
    assert bool(got.converged) and int(got.iter) == 9
    np.testing.assert_allclose(float(got.cost), 249.5608979, rtol=1e-9)
    np.testing.assert_allclose(float(got.cost), float(base.cost), rtol=1e-9)
    np.testing.assert_allclose(np_(got.us), np_(base.us), atol=1e-6)


# ---------------------------------------------------------------------------
# The dense KKT oracle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(KKT_ITERS))
def test_kkt_solve_matches_jax(case, _references):
    """Newton on the dense KKT system: the same iterations and convergence,
    cost 1e-10 relative, xs and us 1e-8 of their max-abs."""
    from crocoddyl_tpu_torch.core.solvers import kkt
    ref = reference(JOBS["solvers"], _references)
    sol = kkt.solve(to_port(_kkt_problem(case)), maxiter=KKT_ITERS[case])
    assert int(sol.iter) == int(ref[f"kkt.{case}.iter"])
    assert bool(sol.converged) == bool(ref[f"kkt.{case}.converged"])
    assert bool(sol.converged)
    np.testing.assert_allclose(float(sol.cost),
                               float(ref[f"kkt.{case}.cost"]), rtol=1e-10)
    for f in ("xs", "us"):
        assert max_rel(ref[f"kkt.{case}.{f}"], getattr(sol, f)) < 1e-8, f


def test_kkt_step_matches_riccati_on_segmented_walk():
    """One dense Newton step on the true-impulse walk (8 segments, T=22) at
    a perturbed infeasible candidate is the step of the port's sequential
    Riccati pass without state regularization (ureg 1e-9 in both):
    du_t = −k_t − K_t·dx_t and
    dx_{t+1} = Fx·dx_t + Fu·du_t + f_{t+1}, within 1e-6 of the steps'
    max-abs (the KKT matrix is solved by a dense LU)."""
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.core.solvers import fddp, kkt
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    prob = QuadrupedGaitFactory(
        m, ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"],
        default_q=q0).walking_problem(x0, 0.1, 0.05, 1e-2, step_knots=4,
                                      support_knots=1, pseudo_impulse=False)
    assert len(prob.segments) == 8
    rng = np.random.default_rng(21)
    xs = x0[None].repeat(prob.T + 1, 1)
    xs[1:, prob.state.nq:] += t64(0.01 * rng.standard_normal(
        (prob.T, m.nv)))
    us = prob.quasi_static(xs)
    # an impulse knot's controls move nothing (Luu = 0): both regularize
    # them by the same ureg, the KKT system in its control blocks
    dxs, dus = kkt.newton_step(prob, xs, us, ureg=1e-9)[:2]
    derivs, dterm, fs, _ = fddp._calc_diff(prob, xs, us, False)
    _, _, _, k, K, _, failed = fddp._backward_pass(derivs, dterm, fs, 0.0,
                                                   1e-9)
    assert not bool(failed) and fs.abs().max() > 1e-4
    sx, su = dxs.abs().max(), dus.abs().max()
    dx = fs[0]
    assert (dxs[0] - dx).abs().max() < 1e-12 * sx
    for t in range(prob.T):
        du = -k[t] - K[t] @ dx
        assert (dus[t] - du).abs().max() < 1e-6 * su, t
        dx = derivs.Fx[t] @ dx + derivs.Fu[t] @ du + fs[t + 1]
        assert (dxs[t + 1] - dx).abs().max() < 1e-6 * sx, t


# ---------------------------------------------------------------------------
# Finite differences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", NUMDIFF)
def test_numdiff_matches_jax(kind, _references):
    """Each finite-difference checker at h = 1e-3 against JAX's: 1e-8 of
    each result's max-abs, plus, for the action's Hessians (a difference
    of differences), the rounding of its cost amplified by 1/h²."""
    ref = reference(JOBS["numdiff"], _references)
    fn, args = _numdiff_case(kind, "torch")
    got = _flat(fn(*args))
    want = {k.split(".", 1)[1]: v for k, v in ref.items()
            if k.startswith(kind + ".")}
    assert set(got) == set(want)
    noise = 0.0
    if kind == "action":
        model, x, u, h = args
        noise = 16 * np.finfo(float).eps * float(model.calc(x, u)[1]) / h ** 2
    for k, v in want.items():
        assert got[k].shape == v.shape, k
        bar = 1e-8 * np.abs(v).max() + (noise if k in ("Lxx", "Lxu", "Luu")
                                         else 0.0)
        assert np.abs(got[k] - v).max() <= bar, k
