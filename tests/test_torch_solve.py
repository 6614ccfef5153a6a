"""The b=1 lane: the port's single-problem ``solve`` and the plain versions
of its kernels 4 (Riccati pass) and 5 (trial rollout) against the JAX
package, float64 on CPU, on the reduced ANYmal walk.

- kernel 4's plain version vs ``fddp._backward_pass`` on random
  derivatives (the fixture of tests/test_fused_scans.py:20-38, drawn with
  numpy): relative 1e-9 of each output's max-abs, the same failure flag,
  also when a negative ureg forces a failure;
- kernel 5's plain version plus the terminal node vs ``fddp._forward_pass``
  at α=0.5 (tests/test_fused_scans.py:68-96): relative 1e-9;
- ``solve(device="cpu")`` with ``fused_scans=True`` (the plain versions
  of kernels 4 and 5) vs JAX ``ct.solve`` (its generic scans) from the
  quasi-static warm start, both exits: identical decisions, cost rtol 1e-8, us within 1e-6,
  the direction fields and xs within 1e-8 of their max-abs (the gaps fs
  within 1e-8 of the states' max-abs, see ``_same_solution``);
- the gate (what ``solve`` refuses, and the multiple-shooting rollout and
  two segments that it takes) and the device rule of the entry points;
- the export of a whole ``solve`` (the replan with and without
  ``fused_scans``) and ``solve_batch`` (the batch step at B=4) with
  ``utils/aot``: the loaded program against the eager port.

Both exits' JAX and port solves run once a session, together, in one
fresh process (``solve_pair``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import (jax_forward_pass, jax_walk, max_rel, np_,
                                 solve_pair, t64, to_port, torch_walk)

SEQ = dict(record_trace=False, parallel_linesearch=False)


def _rand_derivs(T, ndx, nu, seed):
    """Derivatives, terminal derivatives and gaps shaped as in
    tests/test_fused_scans.py:20-38, drawn with numpy."""
    rng = np.random.default_rng(seed)

    def rnd(*s):
        return 0.1 * rng.standard_normal(s)
    eye = np.eye(ndx)
    run = dict(Fx=np.tile(eye, (T, 1, 1)) + 0.01 * rnd(T, ndx, ndx),
               Fu=rnd(T, ndx, nu), Lx=rnd(T, ndx), Lu=rnd(T, nu),
               Lxx=np.tile(eye, (T, 1, 1)), Lxu=0.01 * rnd(T, ndx, nu),
               Luu=np.tile(np.eye(nu), (T, 1, 1)))
    term = dict(Fx=eye, Fu=np.zeros((ndx, nu)), Lx=rnd(ndx),
                Lu=np.zeros(nu), Lxx=eye, Lxu=np.zeros((ndx, nu)),
                Luu=np.zeros((nu, nu)))
    return run, term, rnd(T + 1, ndx)


@pytest.mark.parametrize("forced_failure", [False, True])
def test_plain_riccati_fused_matches_backward_pass(forced_failure):
    from crocoddyl_tpu.core.action import NodeDerivs as JD
    from crocoddyl_tpu.core.solvers import fddp
    from crocoddyl_tpu_torch.core.action import NodeDerivs as TD
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    run, term, fs = _rand_derivs(15, 36, 12, seed=0)
    xreg, ureg = 1e-9, (-1e6 if forced_failure else 1e-9)
    ref = jax.jit(fddp._backward_pass)(
        JD(**{k: jnp.asarray(v) for k, v in run.items()}),
        JD(**{k: jnp.asarray(v) for k, v in term.items()}), jnp.asarray(fs),
        jnp.asarray(xreg), jnp.asarray(ureg))
    out = tfs.riccati_backward_fused(
        TD(**{k: t64(v) for k, v in run.items()}),
        TD(**{k: t64(v) for k, v in term.items()}), t64(fs), xreg, ureg)
    assert bool(np_(out[-1])) == bool(ref[-1]) == forced_failure
    if not forced_failure:
        names = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")
        for name, a, b in zip(names, ref[:-1], out[:-1]):
            assert np_(b).shape == np.asarray(a).shape, name
            assert max_rel(a, b) < 1e-9, name


def test_plain_rollout_fused_matches_forward_pass():
    """Kernel 5's plain version, then the terminal node as the solver adds
    it (integrate the last state, ``calc_terminal``), vs the JAX forward
    pass at α=0.5."""
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    prob, xs0, us0, _ = jax_walk()
    port = to_port(prob)
    T, nu, ndx = prob.T, prob.nu, prob.state.ndx
    rng = np.random.default_rng(3)
    k = 0.1 * rng.standard_normal((T, nu))
    K = 0.01 * rng.standard_normal((T, nu, ndx))
    fs = 0.01 * rng.standard_normal((T + 1, ndx))
    alpha = 0.5
    inf = np.full((T, nu), np.inf)
    xs_ref, us_ref, cost_ref, failed_ref = jax_forward_pass()(
        *map(jnp.asarray, (k, K, fs, alpha, -inf, inf)))
    xs_r, us_r, x_last, cost_r, failed = tfs.trial_rollout_fused(
        port.segments[0], port.x0, t64(xs0), t64(us0), t64(k), t64(K),
        t64(fs), alpha)
    xT = port.state.integrate(x_last, (alpha - 1.0) * t64(fs[-1]))
    cost = cost_r + port.terminal.calc_terminal(xT)
    assert bool(np_(failed)) == bool(failed_ref)
    assert max_rel(xs_ref, torch.cat([xs_r, xT[None]])) < 1e-9
    assert max_rel(us_ref, us_r) < 1e-9
    assert max_rel(cost_ref, cost) < 1e-9


def _same_solution(ref, out, decisions):
    for name in decisions:
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      np_(getattr(out, name)), err_msg=name)
    np.testing.assert_allclose(np_(out.cost), np.asarray(ref.cost),
                               rtol=1e-8)
    assert float(np.max(np.abs(np.asarray(ref.us) - np_(out.us)))) < 1e-6
    for name in ("K", "k", "Vx", "Vxx", "xs"):
        a, b = getattr(ref, name), getattr(out, name)
        assert np_(b).shape == np.asarray(a).shape, name
        assert max_rel(a, b) < 1e-8, name
    # the gaps are differences of states: at the warm start their max-abs
    # (3e-8) is nine orders below the states' (13), so their roundoff is
    # the states' and they are held to 1e-8 of max|xs|
    fs_ref, fs_out = np.asarray(ref.fs), np_(out.fs)
    assert fs_out.shape == fs_ref.shape
    assert np.max(np.abs(fs_ref - fs_out)) <= 1e-8 * np.max(np.abs(
        np.asarray(ref.xs)))


def test_solve_replan_matches_jax(solve_cache):  # noqa: F811
    """maxiter=1, the MPC replan: the direction fields belong to the
    candidate before the step (fddp.py:817-824)."""
    _same_solution(*solve_pair("solve", 1, solve_cache),
                   ("iter", "steplength", "is_feasible"))


def test_solve_multi_iteration_matches_jax(solve_cache):  # noqa: F811
    """maxiter=20: the loop exit, with the direction recomputed at the
    returned trajectory and xreg/ureg/diverged kept from the loop
    (fddp.py:825-866)."""
    _same_solution(*solve_pair("solve", 20, solve_cache),
                   ("iter", "steplength", "is_feasible", "converged",
                    "xreg", "ureg", "diverged"))


@pytest.mark.parametrize("case", ["ms_chunk", "ms_chunk_ddp", "two_segments",
                                  "running_rk4", "terminal_rk4",
                                  "box_without_bounds"])
def test_solve_gate_refuses(case, monkeypatch):
    """What ``solve`` refuses raises a ValueError that says why, and only
    that: multiple shooting under DDP (fddp.py:491-496) and a box solve
    without bounds.  The multiple-shooting FDDP rollout (``ms_chunk``) and
    a problem of two segments are taken: the first iteration's trials go
    through ``_forward_pass_ms`` with the sequential solve's direction, and
    two segments of one structure solve as the one segment of their
    concatenated knots (same decisions, cost rtol 1e-8).  An RK4 node,
    which the node kernel does not admit, is a generic ``RigidBodyNode``
    that ``solve`` takes; ``solve_batch`` (and kernels 4 and 5) refuse
    it."""
    from crocoddyl_tpu_torch import (SolverSettings, box_fddp_settings,
                                     solve, solve_batch)
    from crocoddyl_tpu_torch.core.solvers import fddp
    from crocoddyl_tpu_torch.ops import fused_scans
    from crocoddyl_tpu_torch.utils.struct import tree_map
    prob = to_port(jax_walk()[0])
    settings = SolverSettings(maxiter=1, **SEQ)
    assert fddp.supports(prob, settings)
    match = "unsupported"
    if case == "ms_chunk":
        ms = settings.replace(ms_chunk=4)
        assert fddp.supports(prob, ms)
        passes = []
        for name in ("_forward_pass", "_forward_pass_ms"):
            fn = getattr(fddp, name)
            monkeypatch.setattr(fddp, name, lambda *a, fn=fn, name=name:
                                passes.append(name) or fn(*a))
        got = solve(prob, settings=ms, device="cpu")
        assert set(passes) == {"_forward_pass_ms"}
        ref = solve(prob, settings=settings, device="cpu")
        for f in ("k", "K", "Vx", "fs"):
            torch.testing.assert_close(getattr(got, f), getattr(ref, f))
        assert torch.isfinite(got.cost) and not bool(got.is_feasible)
        return
    if case == "two_segments":
        two = prob.replace(running=(prob.running, prob.running))
        one = prob.replace(running=tree_map(lambda l: torch.cat([l, l]),
                                            prob.running))
        assert fddp.supports(two, settings) and two.T == one.T
        assert two.seg_lengths == (prob.T, prob.T) and not two.on_lanes
        got = solve(two, settings=settings, device="cpu")
        ref = solve(one, settings=settings, device="cpu")
        for f in ("iter", "steplength", "is_feasible", "xreg"):
            assert bool(getattr(got, f) == getattr(ref, f)), f
        # the decisions' bar (tests/test_fddp_batch.py:51-58): the blocks'
        # node counts differ, and so does their rounding
        np.testing.assert_allclose(float(got.cost), float(ref.cost),
                                   rtol=1e-8)
        return
    if case == "ms_chunk_ddp":
        settings = settings.replace(ms_chunk=4, feasibility_driven=False)
    elif case.endswith("rk4"):
        stack = case.split("_")[0]
        prob = prob.replace(**{stack: getattr(prob, stack).replace(
            integrator="rk4")})
        assert fddp.supports(prob, settings) and not prob.on_lanes
        assert fused_scans.supports_problem(prob, settings) == (
            stack == "terminal")
        with pytest.raises(ValueError, match=match):
            solve_batch(prob, prob.x0[None], settings=settings,
                        device="cpu")
        return
    else:
        settings = box_fddp_settings(maxiter=1)
        match = "requires control bounds"
    assert fddp.supports(prob, settings) == (case == "box_without_bounds")
    with pytest.raises(ValueError, match=match):
        solve(prob, settings=settings, device="cpu")


@pytest.mark.parametrize("entry", ["solve", "solve_batch"])
def test_entry_points_need_the_card_or_cpu(entry, monkeypatch):
    """With no CUDA device and no explicit device, both entry points raise
    and say how to ask for the CPU; there is no fallback."""
    import crocoddyl_tpu_torch as ctt
    prob, xs0, us0, x0s = jax_walk()
    port = to_port(prob)
    settings = ctt.SolverSettings(maxiter=1, **SEQ)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "solve":
            ctt.solve(port, t64(xs0), t64(us0), settings)
        else:
            ctt.solve_batch(port, t64(x0s), t64(xs0), t64(us0), settings)


EXPORT_FIELDS = ("cost", "iter", "steplength", "is_feasible", "converged",
                 "diverged", "xreg", "ureg", "stop", "d0", "d1", "xs", "us",
                 "k", "K", "Vx", "Vxx", "Qu", "fs")
DECISIONS = ("iter", "steplength", "is_feasible", "converged", "diverged",
             "xreg")


def _export_case(case):
    """(fn, the argument tuples to run) of a round trip on the reduced walk
    from its quasi-static warm start, the first the example: ``fn``
    returns EXPORT_FIELDS of the solution.  The fused-scans replan runs at
    a second warm start too; the others at the example only (the
    unicycle's round trip in tests/test_torch_aot.py runs at two x0)."""
    import crocoddyl_tpu_torch as ctt
    prob = torch_walk()
    xs0 = prob.x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)

    def fields(sol):
        return tuple(getattr(sol, f) for f in EXPORT_FIELDS)
    if case == "solve_batch":
        rng = np.random.default_rng(0)
        nq, B = prob.state.nq, 4

        x0s = prob.x0[None].repeat(B, 1)
        x0s[:, nq:] += t64(0.01 * rng.standard_normal((B, prob.state.nv)))
        settings = ctt.SolverSettings(maxiter=1, **SEQ)
        return (lambda x0s, xs, us: fields(ctt.solve_batch(
            prob, x0s, xs, us, settings, device="cpu")), [(x0s, xs0, us0)])
    settings = ctt.SolverSettings(maxiter=1,
                                  fused_scans=case == "fused_scans")
    return (lambda xs, us: fields(ctt.solve(prob, xs, us, settings,
                                            device="cpu")),
            [(xs0, us0)] + [(xs0, 1.01 * us0)] * (case == "fused_scans"))


@pytest.mark.parametrize("case", ["fused_scans", "default", "solve_batch"])
def test_export_walk_round_trip(case):
    """A whole solve of the reduced walk through ``aot.export_bytes``,
    ``torch.export.save`` and ``aot.import_bytes``: the MPC replan
    ``solve(maxiter=1)`` with ``fused_scans=True`` (the plain versions of
    kernels 1, 4 and 5 as the ops the card's program launches) and with
    the default settings (kernel 1 and the generic passes), and the batch
    step ``solve_batch(maxiter=1)`` at B=4 (kernels 1, 2 and 3).  The
    ladder, the line search and the BoxQP-free passes are recorded as
    loops and branches; at the example start (and for the fused-scans
    replan at another) the loaded program takes the eager solve's decisions (equal)
    with its costs within rtol 1e-12, and every other field within 1e-12
    of its max-abs."""
    from crocoddyl_tpu_torch.utils import aot
    fn, runs = _export_case(case)
    program = aot.import_bytes(aot.export_bytes(fn, *runs[0]))
    for args in runs:
        got, want = program(*args), fn(*args)
        for name, a, b in zip(EXPORT_FIELDS, got, want):
            assert a.shape == b.shape and a.dtype == b.dtype, name
            if name in DECISIONS:
                assert torch.equal(a, b), name
            elif name == "cost":
                torch.testing.assert_close(a, b, rtol=1e-12, atol=0)
            else:
                assert max_rel(b, a) <= 1e-12, name
