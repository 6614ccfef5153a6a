"""The box solvers' pieces: the port's BoxQP, its box backward pass and its
clamped trial rollout against the JAX package, float64 on CPU.

- ``core/solvers/boxqp.solve`` against the JAX one on random PD 12×12
  problems (bounds that bind, all bounds infinite) and on indefinite ones:
  x and Hff⁻¹ within 1e-10 of their max-abs, the free set, the failure
  flag and the iteration count equal;
- the generic ``_backward_pass`` with the BoxQP gains against JAX
  ``fddp._backward_pass(..., box_args)`` on the random derivatives of
  tests/test_torch_solve.py, with binding bounds, a few knots without
  bounds, and the candidate feasible or not: every output within 1e-9 of
  its max-abs, the failure flag equal;
- the generic ``_forward_pass`` with clamped controls against JAX
  ``fddp._forward_pass(..., u_lb, u_ub)`` on the reduced walk, three step
  lengths as the rows of one pass: within 1e-9 of each output's max-abs;
- the box backward pass on the reduced walk's own derivatives at the
  URDF's limits, where the reference itself moves by ~1e-5 under a 1e-14
  change of its inputs: the port within 10 times that of the JAX pass.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import (jax_forward_pass, jax_walk, max_rel, np_,
                                 t64, to_port)
from tests.test_torch_solve import _rand_derivs

QP_KW = dict(maxiter=100, th_acceptstep=0.1, th_grad=1e-5, reg=0.0)


def _qp_case(case, seed, n=12):
    """(H, q, lb, ub, xinit) drawn with numpy."""
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((n, n))
    if case == "indefinite":
        H = 0.5 * (M + M.T)
    else:
        H = M @ M.T / n + np.eye(n)
    q = 5.0 * rng.standard_normal(n)
    if case == "unbounded":
        lb, ub = np.full(n, -np.inf), np.full(n, np.inf)
    else:
        lb, ub = -0.3 * np.ones(n), 0.3 * np.ones(n)
    return H, q, lb, ub, 0.1 * rng.standard_normal(n)


@pytest.mark.parametrize("case", ["binding", "unbounded", "indefinite"])
def test_boxqp_matches_jax(case):
    from crocoddyl_tpu.core.solvers import boxqp as jqp
    from crocoddyl_tpu_torch.core.solvers import boxqp as tqp
    ref_solve = jax.jit(lambda *a: jqp.solve(*a, **QP_KW))
    iters = []
    for seed in range(4):
        args = _qp_case(case, seed)
        ref = ref_solve(*map(jnp.asarray, args))
        out = tqp.solve(*map(t64, args), **QP_KW)
        assert bool(out.failed) == bool(ref.failed) == (case == "indefinite")
        assert int(out.iterations) == int(ref.iterations)
        np.testing.assert_array_equal(np_(out.free), np.asarray(ref.free))
        if case == "indefinite":
            np.testing.assert_array_equal(np_(out.x), np.asarray(ref.x))
            continue
        assert max_rel(ref.x, out.x) < 1e-10
        assert max_rel(ref.Hff_inv, out.Hff_inv) < 1e-10
        iters.append(int(ref.iterations))
    if case == "binding":
        # a clamped and a free coordinate keep max|g| above th_grad: the
        # loop runs to maxiter, through the port's fixed-point exit
        assert QP_KW["maxiter"] in iters, iters


def _box_backward(feasible):
    """The JAX and the port box backward pass on the same inputs."""
    from crocoddyl_tpu.core.action import NodeDerivs as JD
    from crocoddyl_tpu.core.solvers import fddp
    from crocoddyl_tpu_torch.core.action import NodeDerivs as TD
    from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
    T, ndx, nu = 15, 36, 12
    run, term, fs = _rand_derivs(T, ndx, nu, seed=0)
    rng = np.random.default_rng(5)
    us = rng.standard_normal((T, nu))
    lb, ub = us - 0.05, us + 0.05
    lb[3], ub[3] = -np.inf, np.inf       # a knot without bounds
    ub[7] = np.inf                       # and one with lower bounds only
    k_warm = 0.01 * rng.standard_normal((T, nu))
    ref = jax.jit(lambda d, dT, f, us, lb, ub, kw: fddp._backward_pass(
        d, dT, f, 1e-9, 1e-9, (us, lb, ub, kw, feasible, QP_KW)))(
        JD(**{k: jnp.asarray(v) for k, v in run.items()}),
        JD(**{k: jnp.asarray(v) for k, v in term.items()}),
        *map(jnp.asarray, (fs, us, lb, ub, k_warm)))
    use_box = [bool(np.isfinite(lb[t]).any() or np.isfinite(ub[t]).any())
               and feasible for t in range(T)]
    out = tfddp._backward_pass(
        TD(**{k: t64(v) for k, v in run.items()}),
        TD(**{k: t64(v) for k, v in term.items()}), t64(fs), 1e-9, 1e-9,
        (t64(us), t64(lb), t64(ub), t64(k_warm), use_box, QP_KW))
    return ref, out, us, lb, ub


@pytest.mark.parametrize("feasible", [True, False])
def test_box_backward_pass_matches_jax(feasible):
    ref, out, us, lb, ub = _box_backward(feasible)
    assert bool(np_(out[-1])) == bool(ref[-1]) is False
    for name, a, b in zip(("Vx", "Vxx", "Qu", "k", "K", "Quuk"), ref[:-1],
                          out[:-1]):
        assert np_(b).shape == np.asarray(a).shape, name
        assert max_rel(a, b) < 1e-9, name
    # the bounds bind where they apply: u − k sits on a bound
    u_new = us - np_(out[3])
    on_bound = np.isclose(u_new, lb) | np.isclose(u_new, ub)
    assert on_bound.any() == feasible


def test_clamped_forward_pass_matches_jax():
    """The port's trial rollout with bounds at three step lengths, as rows
    of one pass, against the JAX forward pass at each."""
    from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
    prob, xs0, us0, _ = jax_walk()
    port = to_port(prob)
    T, nu, ndx = prob.T, prob.nu, prob.state.ndx
    rng = np.random.default_rng(3)
    k = 0.1 * rng.standard_normal((T, nu))
    K = 0.01 * rng.standard_normal((T, nu, ndx))
    fs = 0.01 * rng.standard_normal((T + 1, ndx))
    u_lb = np.asarray(us0) - 0.05
    u_ub = np.asarray(us0) + 0.05
    alphas = [1.0, 0.5, 0.25]
    out = tfddp._forward_pass(port, t64(xs0), t64(us0), t64(k), t64(K),
                              t64(fs), alphas, t64(u_lb), t64(u_ub))
    clamped = 0
    for i, alpha in enumerate(alphas):
        xs_r, us_r, cost_r, failed_r = jax_forward_pass()(
            *map(jnp.asarray, (k, K, fs, alpha, u_lb, u_ub)))
        assert bool(np_(out[3][i])) == bool(failed_r) is False
        assert max_rel(xs_r, out[0][i]) < 1e-9
        assert max_rel(us_r, out[1][i]) < 1e-9
        assert max_rel(cost_r, out[2][i]) < 1e-9
        clamped += int(np.sum(np.isclose(np.asarray(us_r), u_lb)
                              | np.isclose(np.asarray(us_r), u_ub)))
    assert clamped > 0


def test_box_backward_pass_on_the_walk_within_reference_sensitivity():
    """On the reduced walk's derivatives at the rollout of its quasi-static
    controls, with the URDF's 40 N m limits, most BoxQPs run to maxiter and
    the box pass moves with the rounding of its inputs: a 1e-14 relative
    change of the node derivatives moves the JAX pass's k by ~1e-5 of its
    max-abs (the pass without box: < 1e-8).  The port is held to the JAX
    pass within 10 times that sensitivity, each output, and to the same
    failure flag."""
    from crocoddyl_tpu.core.action import NodeDerivs as JD
    from crocoddyl_tpu.core.solvers import fddp
    from crocoddyl_tpu_torch.core.solvers import boxqp as tqp
    from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
    from crocoddyl_tpu_torch.utils.struct import tree_map
    prob, xs0, us0, _ = jax_walk()
    port = to_port(prob)
    T, nu = port.T, port.nu
    us = t64(us0)
    d, dT, fs, _ = tfddp._calc_diff(port, port.rollout(us), us, True)
    g = torch.Generator().manual_seed(0)
    d_pert = tree_map(lambda l: l * (1 + 1e-14 * torch.randn(
        l.shape, generator=g, dtype=l.dtype)), d)
    lim = port.state.model.effort_limit[6:].expand(T, nu)
    k_warm = torch.zeros(T, nu, dtype=torch.float64)

    def jd(tree):
        return JD(**{f: jnp.asarray(np_(getattr(tree, f))) for f in (
            "Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")})
    jbp = jax.jit(lambda d: fddp._backward_pass(
        d, jd(dT), jnp.asarray(np_(fs)), 1e-9, 1e-9,
        tuple(map(jnp.asarray, (np_(us), np_(-lim), np_(lim),
                                np_(k_warm)))) + (True, QP_KW)))
    ref, ref_pert = jbp(jd(d)), jbp(jd(d_pert))
    iters = []
    orig = tqp.solve

    def counted(*a, **k):
        sol = orig(*a, **k)
        iters.append(int(sol.iterations))
        return sol
    tqp.solve = counted
    try:
        out = tfddp._backward_pass(d, dT, fs, 1e-9, 1e-9,
                                   (us, -lim, lim, k_warm, [True] * T, QP_KW))
    finally:
        tqp.solve = orig
    assert QP_KW["maxiter"] in iters
    assert bool(np_(out[-1])) == bool(ref[-1]) is False
    names = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")
    sens = {n: max_rel(a, b) for n, a, b in zip(names, ref, ref_pert)}
    assert sens["k"] > 1e-7, sens
    for name, a, b in zip(names, ref[:-1], out[:-1]):
        assert max_rel(a, b) <= 10 * max(sens[name], 1e-12), (name, sens)
    plain = tfddp._backward_pass(d, dT, fs, 1e-9, 1e-9)
    plain_pert = tfddp._backward_pass(d_pert, dT, fs, 1e-9, 1e-9)
    assert max_rel(plain[3], plain_pert[3]) < 1e-8
