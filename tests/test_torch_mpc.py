"""The port's horizon rotation and warm-start shift (``core/mpc.py``), the
receding-horizon loop, and the solvers' settings gates, float64 on CPU:

- ``circular_append`` (with and without ``new_model``/``new_x0``), its
  refusal of two segments, and ``shift_warm_start`` against the JAX
  functions on the varied unicycle of tests/test_mpc.py:21-30 and on the
  reduced walk: leaves equal (the same roll of the same numbers);
- a rotated reduced walk is a new problem: its node linearization (plain
  version of kernel 1) and its kernel descriptor are the unrotated
  problem's at the rolled knots, and the unrotated problem is untouched;
- the unicycle receding-horizon loop of tests/test_mpc.py:128-159 (8
  ticks, ``maxiter=3``) against JAX's: the plant's x0 and the cost of every
  tick within 1e-9 relative;
- the gates: ``solve_batch`` refuses ``iter_callback``, both solvers refuse
  ``parallel_riccati=True`` (which passes ``fused_scans`` selects on the
  walk: tests/test_torch_solver_surface.py::test_walk_dispatch).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import (jax_walk, leaves_of, max_rel, np_,
                                 perturbed_nodes, t64, to_port, torch_walk)

SEQ = dict(record_trace=False, parallel_linesearch=False)


def _varied_problem(T=12):
    """tests/test_mpc.py:21-30: a unicycle horizon whose cost weights ramp
    along the knots, so that a rotation shows."""
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    m = UnicycleModel()
    stacked = ct.replicate_model(m, T)
    w = jnp.stack([jnp.linspace(1.0, 2.0, T), jnp.linspace(0.1, 0.5, T)], -1)
    return ct.ShootingProblem(x0=jnp.asarray([-1.0, -1.0, 1.0]),
                              running=stacked.replace(cost_weights=w),
                              terminal=m)


def _same_leaves(ref, out):
    import torch.utils._pytree as pt
    flat, _ = pt.tree_flatten_with_path(out)
    got = {pt.keystr(p): np_(l) for p, l in flat}
    want = leaves_of(ref)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("problem", ["unicycle", "walk"])
@pytest.mark.parametrize("args", ["plain", "new_model_x0"])
def test_circular_append_matches_jax(problem, args):
    from crocoddyl_tpu.core import mpc as jmpc
    from crocoddyl_tpu_torch.core import mpc
    from crocoddyl_tpu_torch.utils.struct import tree_leaves, tree_map
    jprob = _varied_problem() if problem == "unicycle" else jax_walk()[0]
    tprob = to_port(jprob)
    jkw, tkw = {}, {}
    if args == "new_model_x0":
        x_new = np.asarray(jprob.x0) + 0.5
        jkw = dict(new_model=jax.tree.map(lambda l: l[3] * 7.0,
                                          jprob.running),
                   new_x0=jnp.asarray(x_new))
        tkw = dict(new_model=tree_map(lambda l: l[3] * 7.0, tprob.running),
                   new_x0=t64(x_new))
    out = mpc.circular_append(tprob, **tkw)
    _same_leaves(jmpc.circular_append(jprob, **jkw), out)
    assert out is not tprob and out.running is not tprob.running
    _same_leaves(jprob, tprob)      # the rotated problem is a new one
    # the list oracle of tests/test_mpc.py:34-43: knots 1.., then knot 0
    # or the new model
    knots = mpc._unstack(tprob.running)
    last = [tkw["new_model"]] if tkw else knots[:1]
    oracle = mpc.stack_nodes(knots[1:] + last)
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(oracle), tree_leaves(out.running)))


def test_circular_append_rejects_two_segments():
    from crocoddyl_tpu_torch.core.mpc import circular_append
    from crocoddyl_tpu_torch.utils.struct import tree_map
    prob = to_port(_varied_problem())
    seg = prob.replace(running=(tree_map(lambda l: l[:5], prob.running),
                                tree_map(lambda l: l[5:], prob.running)))
    with pytest.raises(ValueError, match="rotate_segmented"):
        circular_append(seg)


@pytest.mark.parametrize("measured", [False, True])
def test_shift_warm_start_matches_jax(measured):
    from crocoddyl_tpu.core.mpc import shift_warm_start as jshift
    from crocoddyl_tpu_torch.core.mpc import shift_warm_start
    rng = np.random.default_rng(4)
    xs, us, xm = (rng.standard_normal(s) for s in ((6, 2), (5, 1), (2,)))
    ref = jshift(jnp.asarray(xs), jnp.asarray(us),
                 jnp.asarray(xm) if measured else None)
    txs, tus = t64(xs), t64(us)
    out = shift_warm_start(txs, tus, t64(xm) if measured else None)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(np.asarray(a), np_(b))
    np.testing.assert_array_equal(np_(txs), xs)     # inputs untouched
    np.testing.assert_array_equal(np_(tus), us)


def test_rotated_walk_linearizes_at_rolled_knots():
    """The plain node linearization of the rotated reduced walk at the
    rolled trajectory is the unrotated walk's at the same knots, its
    kernel descriptor's parameter rows are the rolled ones (it is built
    anew: the rotated problem is a new object), and the unrotated problem
    still linearizes as before."""
    from crocoddyl_tpu_torch.core.mpc import circular_append
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    prob = torch_walk()
    T = prob.T
    xs, us = perturbed_nodes(prob)
    xs = t64(np.concatenate([xs, xs[-1:]]))
    us = t64(us)
    d0, dT0, xn0, c0 = prob.calc_diff_full(xs, us)
    rot = circular_append(prob)
    assert rot.knots is not prob.knots
    xs_r = torch.cat([torch.roll(xs[:T], -1, 0), xs[T:]])
    d1, dT1, xn1, c1 = rot.calc_diff_full(xs_r, torch.roll(us, -1, 0))
    idx = (torch.arange(T) + 1) % T
    for f in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu"):
        assert max_rel(getattr(d0, f)[idx], getattr(d1, f)) < 1e-14, f
        assert max_rel(getattr(dT0, f), getattr(dT1, f)) < 1e-14, f
    assert max_rel(xn0[idx], xn1) < 1e-14
    assert max_rel(c0[torch.cat([idx, torch.tensor([T])])], c1) < 1e-14
    cpu = torch.device("cpu")
    p0 = ck.descriptor(prob.knots, cpu, torch.float64)
    p1 = ck.descriptor(rot.knots, cpu, torch.float64)
    assert torch.equal(p0.meta, p1.meta) and torch.equal(p0.robot, p1.robot)
    assert torch.equal(p0.par[torch.cat([idx, torch.tensor([T])])], p1.par)
    again = prob.calc_diff_full(xs, us)
    assert torch.equal(again[0].Fu, d0.Fu) and torch.equal(again[3], c0)


def test_unicycle_receding_horizon_matches_jax():
    """tests/test_mpc.py:128-159 in both packages: a converged plan, then 8
    ticks of plant step, rotation, shifted warm start and a maxiter=3
    replan; the plant's x0 and each tick's cost agree within 1e-9."""
    import crocoddyl_tpu as ct
    import crocoddyl_tpu_torch as ctt
    from crocoddyl_tpu.core.mpc import circular_append as jappend
    from crocoddyl_tpu.core.mpc import shift_warm_start as jshift
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    from crocoddyl_tpu_torch.utils.struct import tree_map
    m = UnicycleModel()
    jprob = ct.ShootingProblem(x0=jnp.asarray([-1.0, -1.0, 1.0]),
                               running=ct.replicate_model(m, 20), terminal=m)
    first = dict(maxiter=50, record_trace=False)
    replan = dict(maxiter=3, record_trace=False)
    jsol = ct.solve(jprob, settings=ct.SolverSettings(**first))
    tprob = to_port(jprob)
    tsol = ctt.solve(tprob, settings=ctt.SolverSettings(**first),
                     device="cpu")
    assert bool(jsol.converged) and bool(tsol.converged)

    @jax.jit
    def jstep(prob, xs, us):
        x_next, _ = jax.tree.map(lambda l: l[0], prob.running).calc(
            prob.x0, us[0])
        prob2 = jappend(prob, new_x0=x_next)
        xs2, us2 = jshift(xs, us, x_next)
        return prob2, ct.solve(prob2, xs_init=xs2, us_init=us2,
                               settings=ct.SolverSettings(**replan))

    jxs, jus, txs, tus = jsol.xs, jsol.us, tsol.xs, tsol.us
    for tick in range(8):
        jprob, js = jstep(jprob, jxs, jus)
        x_next, _ = tree_map(lambda l: l[0], tprob.running).calc(
            tprob.x0, tus[0])
        tprob = ctt.circular_append(tprob, new_x0=x_next)
        xs2, us2 = ctt.shift_warm_start(txs, tus, x_next)
        ts = ctt.solve(tprob, xs2, us2, ctt.SolverSettings(**replan),
                       device="cpu")
        assert not bool(ts.diverged)
        assert int(ts.iter) == int(js.iter), tick
        assert max_rel(jprob.x0, tprob.x0) < 1e-9, tick
        np.testing.assert_allclose(float(ts.cost), float(js.cost), rtol=1e-9)
        jxs, jus, txs, tus = js.xs, js.us, ts.xs, ts.us
    assert float(torch.linalg.norm(tprob.x0[:2])) < float(np.sqrt(2.0))


@pytest.mark.parametrize("case", ["batch_iter_callback",
                                  "batch_parallel_riccati",
                                  "solve_parallel_riccati"])
def test_solver_gates_refuse(case):
    """What the JAX gates refuse (fddp_batch.py:42-50) and what the port
    does not have yet (the associative-scan Riccati pass) raise a
    ValueError."""
    import crocoddyl_tpu_torch as ctt
    from crocoddyl_tpu_torch.core.solvers import fddp, fddp_batch
    prob = torch_walk()
    ok = ctt.SolverSettings(maxiter=1, fused_scans=True,
                            parallel_riccati=False, th_gaptol=1e-7, **SEQ)
    assert fddp_batch.supports(prob, ok) and fddp.supports(prob, ok)
    bad = ok.replace(**({"iter_callback": lambda *a: None}
                        if case == "batch_iter_callback"
                        else {"parallel_riccati": True}))
    x0s = prob.x0[None].expand(2, -1)
    with pytest.raises(ValueError, match="unsupported"):
        if case.startswith("batch"):
            ctt.solve_batch(prob, x0s, settings=bad, device="cpu")
        else:
            ctt.solve(prob, settings=bad, device="cpu")
