"""``vmap_solve``: the port's ``solve`` over a batch of problems (the
counterpart of ``jax.vmap(fddp.solve)``), float64 on the CPU.

Every problem of a batch takes the decisions of its own single ``solve``
(``iter``, ``steplength``, ``is_feasible``, ``converged``, ``diverged``
and ``xreg`` equal), with its cost within rtol 1e-8 and its controls within
atol 1e-6 (the batched products and factorizations round otherwise than
the single ones, and the walk's Riccati pass amplifies it):

- the 16 unicycle solves of tests/test_mesh.py:22-35 against the port's
  single solves (cost rtol 1e-12, controls atol 1e-10) and JAX's
  ``vmap``ped solve (the reference tests/test_torch_parallel.py already
  computes), and the three initial states of
  tests/test_solvers_toy.py:100-115 against tests/oracle.py;
- the reduced walk with three Baumgarte gains, built by the ported
  example (crocoddyl_tpu_torch/examples/baumgarte_grid_search.py), under
  the default settings (the parallel line search with the trace), DDP,
  Box-FDDP, ``fused_scans`` (the plain kernels 4 and 5 with a problem axis
  of 3) and the sequential line search with the trace, and under the
  default settings and ``fused_scans`` against JAX's ``vmap``ped solve of
  the same grid;
- a batch of generic nodes (the arm's Box-DDP), a segmented batch (the
  true-impulse walk) and a batch whose robots differ (a mass sweep, which
  leaves the lane path);

and a batched ``maxiter=1`` solve dispatches as many ATen ops at B=2 as at
B=6; the mesh calls ``solve_fn`` once a rank; a batched solve refuses an
``iter_callback`` and export.
"""

import functools

import numpy as np
import pytest
import torch

from tests import _torch_fleet as fleet
from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import max_rel, np_, reference, start_references
from tests.oracle import unicycle_oracle
from tests.test_torch_parallel import JOBS as PARALLEL_JOBS
from tests.test_torch_parallel import x0s_of_test_mesh

DECISIONS = ("iter", "steplength", "is_feasible", "converged", "diverged",
             "xreg")
TRACE = ("cost", "stop", "grad", "xreg", "ureg", "steplength", "feasible")
GAINS = (0.0, 25.0, 100.0)
# the port's walk cases (``_walk_case``) held to JAX's ``vmap``ped solve of
# the same grid under the default settings (``jax_reference``).  JAX's own
# ``fused_scans`` solve runs its Pallas kernels in interpret mode on the
# CPU, whose compile under ``vmap`` would double the reference's ~5 min; its
# costs agree with the default settings' within 6e-10 relative here, and
# its decisions are equal, so the port's fused kernels are held to the
# default settings' reference at the same bars
JAX_WALK_CASES = ("default", "fused_scans")


def jax_reference(job):
    """The JAX side (the child of ``start_references`` calls this): one
    ``jax.vmap``ped solve of the reduced walk (step_knots=3,
    support_knots=1) at GAINS, as examples/baumgarte_grid_search.py:35-64
    builds and solves the grid, at maxiter=3 under the default settings
    (no trace: the decisions do not read it)."""
    import jax
    import jax.numpy as jnp

    import crocoddyl_tpu as ct
    from crocoddyl_tpu.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = jnp.concatenate([q0, jnp.zeros(m.nv)])
    probs = []
    for kv in GAINS:
        class Factory(QuadrupedGaitFactory):
            contact_gains = (0.0, float(kv))
        probs.append(Factory(m, fleet.FEET, default_q=np.asarray(q0))
                     .walking_problem(x0, 0.15, 0.1, 1e-2, step_knots=3,
                                      support_knots=1))
    stacked = jax.tree.map(lambda *ls: jnp.stack(ls), *probs)
    xs0 = jnp.tile(x0[None], (probs[0].T + 1, 1))
    us0 = probs[0].quasi_static(xs0)
    st = ct.SolverSettings(maxiter=3, record_trace=False)
    sol = jax.jit(jax.vmap(lambda p: ct.solve(
        p, xs_init=xs0, us_init=us0, settings=st)))(stacked)
    return {f: np.asarray(getattr(sol, f)) for f in ("us", "cost") + DECISIONS}


# the JAX reference of the 16 unicycle solves, computed for
# tests/test_torch_parallel.py (no JAX compile of its own), and the walk's
JOBS = {"unicycle": PARALLEL_JOBS["unicycle"],
        "walks": "tests.test_torch_vmap_solve:jax_reference:walks"}


def batch_of(problems):
    from crocoddyl_tpu_torch.utils.struct import tree_map
    return tree_map(lambda *ls: torch.stack(ls), *problems)


def replicated(problem, x0s):
    """``problem`` over the initial states x0s (B, nx)."""
    from crocoddyl_tpu_torch.utils.struct import tree_map
    return tree_map(lambda l: l.expand((len(x0s),) + l.shape),
                    problem).replace(x0=x0s)


def batched(solve_fn, problem):
    from crocoddyl_tpu_torch import vmap_solve
    return vmap_solve(solve_fn)(problem)


def same_decisions(batch, singles, cost_rtol=1e-8, us_atol=1e-6):
    for i, one in enumerate(singles):
        for f in DECISIONS:
            assert torch.equal(getattr(batch, f)[i], getattr(one, f)), (
                f, i, getattr(batch, f)[i], getattr(one, f))
        np.testing.assert_allclose(np_(batch.cost[i]), np_(one.cost),
                                   rtol=cost_rtol, atol=0)
        np.testing.assert_allclose(np_(batch.us[i]), np_(one.us), rtol=0,
                                   atol=us_atol)


@pytest.fixture(scope="module", autouse=True)
def _references(solve_cache):  # noqa: F811
    start_references(JOBS.values(), solve_cache)
    return solve_cache


@pytest.fixture(scope="module")
def unicycles():
    """(the 16 single solves, their batched solve)."""
    prob = fleet.unicycle_problem()
    x0s = torch.as_tensor(x0s_of_test_mesh())
    singles = [fleet.unicycle_solve(prob.replace(x0=x0)) for x0 in x0s]
    return singles, batched(fleet.unicycle_solve, replicated(prob, x0s))


def test_unicycles_match_single_solves(unicycles):
    singles, batch = unicycles
    assert batch.cost.shape == (16,) and batch.xs.shape == (16, 21, 3)
    same_decisions(batch, singles, cost_rtol=1e-12, us_atol=1e-10)


def test_unicycles_match_jax(unicycles, _references):
    _, batch = unicycles
    ref = reference(JOBS["unicycle"], _references)
    for f in DECISIONS[:-1]:
        assert np.array_equal(np_(getattr(batch, f)), ref[f]), f
    np.testing.assert_allclose(np_(batch.cost), ref["cost"], rtol=1e-8)
    np.testing.assert_allclose(np_(batch.us), ref["us"], rtol=0, atol=1e-6)


@pytest.mark.parametrize("case", ["ms_chunk", "parallel_riccati",
                                  "box_ddp_sequential", "polish"])
def test_unicycle_settings(case):
    """Four of the unicycles under the settings the walk cases leave out:
    the multiple-shooting rollout, the associative-scan backward pass,
    Box-DDP with the sequential line search (each at the 16 unicycles'
    bars), and ``polish`` of a float32 batched solve (at the walk's bars:
    the float32 solve it starts from rounds by the batch's products);
    each problem against its single solve."""
    from crocoddyl_tpu_torch import (SolverSettings, box_ddp_settings,
                                     cast_floats, polish, solve)
    prob = fleet.unicycle_problem()
    x0s = torch.as_tensor(x0s_of_test_mesh())[:4]
    st = {"ms_chunk": SolverSettings(maxiter=15, ms_chunk=5),
          "parallel_riccati": SolverSettings(maxiter=40,
                                             parallel_riccati=True),
          "box_ddp_sequential": box_ddp_settings(
              maxiter=10, parallel_linesearch=False),
          "polish": SolverSettings(maxiter=5)}[case]
    kw = dict(u_lb=-torch.ones(2), u_ub=torch.ones(2)) if st.box else {}

    def run(p):
        if case != "polish":
            return solve(p, settings=st, device="cpu", **kw)
        p32 = cast_floats(p, torch.float32)
        return polish(p, solve(p32, settings=st, device="cpu"), iters=2,
                      device="cpu")
    singles = [run(prob.replace(x0=x0)) for x0 in x0s]
    bars = {} if case == "polish" else dict(cost_rtol=1e-12, us_atol=1e-10)
    same_decisions(batched(run, replicated(prob, x0s)), singles, **bars)


def test_three_x0s_match_oracle():
    """tests/test_solvers_toy.py:100-115: one batched solve of three
    initial states against the NumPy oracle."""
    from crocoddyl_tpu_torch import (ShootingProblem, SolverSettings,
                                     replicate_model, solve)
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    T, m = 20, UnicycleModel()
    x0s = torch.tensor([[-1.0, -1.0, 1.0], [0.5, 0.8, -0.3],
                        [2.0, 0.0, 0.1]], dtype=torch.float64)
    prob = ShootingProblem(x0=x0s[0], running=replicate_model(m, T),
                           terminal=m)
    sols = batched(lambda p: solve(p, settings=SolverSettings(
        maxiter=30, record_trace=False), device="cpu"),
        replicated(prob, x0s))
    for i, x0 in enumerate(x0s.numpy()):
        oracle = unicycle_oracle(x0, T)
        ok = oracle.solve(maxiter=30)
        assert bool(sols.converged[i]) == ok
        assert int(sols.iter[i]) == oracle.iter
        np.testing.assert_allclose(np_(sols.cost[i]), oracle.cost,
                                   rtol=1e-9)


@functools.lru_cache(maxsize=None)
def walks():
    """The reduced walk (step_knots=3, support_knots=1) at GAINS, through
    the ported example: (problems, batch, xs0, us0)."""
    from crocoddyl_tpu_torch.examples.baumgarte_grid_search import (
        grid_problems)
    return grid_problems(GAINS, step_knots=3, support_knots=1)


def _walk_case(name):
    from crocoddyl_tpu_torch import (SolverSettings, box_fddp_settings,
                                     ddp_settings)
    lim = torch.full((12,), 20.0, dtype=torch.float64)
    return {
        "default": (SolverSettings(maxiter=3), {}),
        "ddp": (ddp_settings(maxiter=3), {}),
        "box_fddp": (box_fddp_settings(maxiter=3), dict(u_lb=-lim,
                                                        u_ub=lim)),
        "fused_scans": (SolverSettings(maxiter=3, fused_scans=True), {}),
        "sequential_trace": (SolverSettings(
            maxiter=3, parallel_linesearch=False), {}),
    }[name]


@pytest.mark.parametrize("name", ["default", "ddp", "box_fddp",
                                  "fused_scans", "sequential_trace"])
def test_walk_gains_match_single_solves(name, _references):
    """Each gain's walk takes its single solve's decisions; the trace's
    columns are its single solve's; under ``fused_scans`` the plain
    kernels 4 and 5 run once a pass for the three problems.  Under
    JAX_WALK_CASES the batch also takes the decisions of JAX's ``vmap``ped
    solve of the same grid (``jax_reference``), at the same bars."""
    from crocoddyl_tpu_torch import solve
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    probs, batch, xs0, us0 = walks()
    st, kw = _walk_case(name)

    def run(p):
        return solve(p, xs_init=xs0, us_init=us0, settings=st, device="cpu",
                     **kw)
    plain = (fsc.riccati_backward_fused_plain, fsc.trial_rollout_fused_plain)

    def counted(fn, *args):
        before = [f.calls for f in plain]
        out = fn(*args)
        return out, np.array([f.calls - b for f, b in zip(plain, before)])
    singles, each = zip(*(counted(run, p) for p in probs))
    sol, calls = counted(batched, run, batch)
    assert batch.on_lanes and sol.xs.shape == (3, batch.T + 1, 37)
    same_decisions(sol, singles)
    for col in TRACE:
        # the decisions' columns equal, the cost's at the cost's bar; the
        # stopping criterion Σ Qu² and the expected improvement's d1 (~1e11
        # on this walk) at rtol 1e-6
        rtol = dict(cost=1e-8, stop=1e-6, grad=1e-6).get(col, 0)
        for i, one in enumerate(singles):
            np.testing.assert_allclose(
                np_(getattr(sol.trace, col)[i]),
                np_(getattr(one.trace, col)), rtol=rtol, atol=0, err_msg=col)
    if name in JAX_WALK_CASES:
        ref = reference(JOBS["walks"], _references)
        for f in DECISIONS:
            assert np.array_equal(np_(getattr(sol, f)), ref[f]), f
        np.testing.assert_allclose(np_(sol.cost), ref["cost"], rtol=1e-8,
                                   atol=0)
        np.testing.assert_allclose(np_(sol.us), ref["us"], rtol=0, atol=1e-6)
    if name == "fused_scans":
        # the three problems share every call: as many as the single solve
        # that needs most at each step, fewer than the three's sum
        assert np.all(calls >= np.max(each, 0)), (calls, each)
        assert np.all(calls < np.sum(each, 0)), (calls, each)
    else:
        assert calls.tolist() == [0, 0]


def test_generic_node_batch_box_ddp():
    """The arm of examples/boxfddp_vs_boxddp.py (generic nodes, T=10),
    Box-DDP at ±0.15 × the effort limits, from three initial states."""
    import chip_smoke
    from crocoddyl_tpu_torch import arm7, box_ddp_settings, solve
    arm, xs0, us0 = chip_smoke.arm_problem(torch, T=10, dt=2e-3)
    lim = 0.15 * arm7().effort_limit
    rng = np.random.default_rng(0)
    x0s = arm.x0 + torch.tensor(0.05 * rng.standard_normal((3, 14)))

    def run(p):
        return solve(p, xs_init=xs0, us_init=us0, device="cpu",
                     settings=box_ddp_settings(maxiter=10), u_lb=-lim,
                     u_ub=lim)
    singles = [run(arm.replace(x0=x0)) for x0 in x0s]
    sol = batched(run, replicated(arm, x0s))
    assert not arm.on_lanes
    same_decisions(sol, singles)


def test_segmented_batch():
    """The true-impulse walk (step_knots=4, support_knots=1: 8 segments,
    T=22), two initial states."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    prob = QuadrupedGaitFactory(m, fleet.FEET, default_q=q0).walking_problem(
        x0, 0.25, 0.15, 1e-2, step_knots=4, support_knots=1,
        pseudo_impulse=False)
    assert len(prob.segments) == 8
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)
    x0s = torch.stack([x0, x0 + 0.01 * (torch.arange(x0.shape[0]) >= m.nq)])

    def run(p):
        return solve(p, xs_init=xs0, us_init=us0, device="cpu",
                     settings=SolverSettings(maxiter=3))
    singles = [run(prob.replace(x0=x)) for x in x0s]
    same_decisions(batched(run, replicated(prob, x0s)), singles)


def test_robots_that_differ():
    """A mass sweep: the lane nodes read one robot for every knot, so the
    batch takes the generic path; each problem still takes its single
    (lane) solve's decisions."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots

    def walk(scale):
        m = robots.quadruped()
        m = m.replace(mass=scale * m.mass)
        q0 = robots.quadruped_standing_q(m)
        x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
        return QuadrupedGaitFactory(m, fleet.FEET, default_q=q0) \
            .walking_problem(x0, 0.15, 0.1, 1e-2, step_knots=3,
                             support_knots=1)
    probs = [walk(1.0), walk(1.2)]
    batch = batch_of(probs)
    assert probs[0].on_lanes and not batch.on_lanes
    x0 = probs[0].x0
    xs0 = x0[None].expand(probs[0].T + 1, -1).clone()
    us0 = probs[0].quasi_static(xs0)

    def run(p):
        return solve(p, xs_init=xs0, us_init=us0, device="cpu",
                     settings=SolverSettings(maxiter=3))
    singles = [run(p) for p in probs]
    assert not torch.equal(singles[0].cost, singles[1].cost)
    same_decisions(batched(run, batch), singles)


class _CountOps(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("case", ["unicycle", "walk"])
def test_one_program(case):
    """A batched maxiter=1 solve of B equal problems (equal trip counts)
    dispatches the same number of ATen ops at B=2 and at B=6."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    if case == "unicycle":
        prob, xs0, us0 = fleet.unicycle_problem(), None, None
    else:
        probs, _, xs0, us0 = walks()
        prob = probs[0]
    counts = []
    for B in (2, 6):
        batch = replicated(prob, prob.x0.expand(B, -1).clone())
        with _CountOps() as c:
            sol = batched(lambda p: solve(
                p, xs_init=xs0, us_init=us0, device="cpu",
                settings=SolverSettings(maxiter=1)), batch)
        counts.append(c.n)
        assert sol.cost.shape == (B,)
    assert counts[0] == counts[1] > 0, counts


def test_mesh_calls_solve_fn_once_per_rank(unicycles):
    """``sharded_solve_x0`` and ``batched_solve_fn`` on a one-rank mesh
    call ``solve_fn`` once, on the whole slice, and give the batched
    solve's results."""
    from crocoddyl_tpu_torch.parallel import (batched_solve_fn, data_mesh,
                                              sharded_solve_x0)
    _, whole = unicycles
    mesh = data_mesh(device="cpu")
    prob = fleet.unicycle_problem()
    x0s = torch.as_tensor(x0s_of_test_mesh())[:4]
    calls = []

    def solve_fn(p):
        calls.append(tuple(p.x0.shape))
        return fleet.unicycle_solve(p)
    a = sharded_solve_x0(solve_fn, prob, mesh)(x0s)
    b = batched_solve_fn(solve_fn, mesh)(replicated(prob, x0s))
    assert calls == [(4, 3), (4, 3)]
    for sol in (a, b):
        assert torch.equal(sol.cost, whole.cost[:4])
        assert torch.equal(sol.us, whole.us[:4])


def test_batched_solve_refusals():
    """A batched solve refuses an iter_callback and export; ``solve``
    takes a batch of problems directly, as ``vmap_solve`` calls it."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    from crocoddyl_tpu_torch.utils import aot
    prob = fleet.unicycle_problem()
    batch = replicated(prob, prob.x0.expand(2, -1).clone())
    cb = SolverSettings(maxiter=2, iter_callback=lambda *a: None)
    with pytest.raises(ValueError, match="iter_callback"):
        batched(lambda p: solve(p, settings=cb, device="cpu"), batch)
    st = SolverSettings(maxiter=2)
    direct = solve(batch, settings=st, device="cpu")
    through = batched(lambda p: solve(p, settings=st, device="cpu"), batch)
    assert torch.equal(direct.cost, through.cost)
    assert torch.equal(direct.us, through.us)

    def program(x0s):
        return batched(lambda p: solve(p, settings=SolverSettings(
            maxiter=2), device="cpu"), batch.replace(x0=x0s)).cost
    with pytest.raises(ValueError, match="batched solve"):
        aot.export_bytes(program, batch.x0)


def test_fused_plain_problem_axis():
    """The plain kernels 4 and 5 over P=3 problems (through their ops)
    against three single-problem calls: the failure flags equal, the
    Riccati pass's outputs within 1e-8 of their scale and the rollout's
    within 1e-12 (the plain lane code sums otherwise over 3 lanes than
    over 1, and the walk's pass amplifies it to ~5e-10 in k; on the card,
    ``chip_smoke.py`` holds the kernels at P to P single launches
    bitwise)."""
    from crocoddyl_tpu_torch.core.solvers.fddp import _calc_diff
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    from crocoddyl_tpu_torch.utils.struct import tree_leaves, tree_map
    probs, batch, xs0, us0 = walks()
    P = len(probs)
    xs, us = xs0.expand(P, -1, -1), us0.expand(P, -1, -1)
    derivs, dterm, fs, _ = _calc_diff(batch, xs, us, False)
    # the CUDA kernels take contiguous (P, T, ...) arrays
    assert all(a.is_contiguous() for a in tree_leaves((derivs, dterm, fs)))
    xreg = torch.tensor([1e-9, 1e-3, 1.0], dtype=torch.float64)
    out = fsc.riccati_backward_fused(derivs, dterm, fs, xreg, xreg)
    k, K = out[3], out[4]
    alpha = torch.tensor([1.0, 0.5, 0.25], dtype=torch.float64)
    roll = fsc.trial_rollout_fused(batch.segment_knots, batch.x0, xs, us, k,
                                   K, fs, alpha)
    for p in range(P):
        def at(t, p=p):
            return tree_map(lambda a: a[p], t)
        one = fsc.riccati_backward_fused(at(derivs), at(dterm), fs[p],
                                         xreg[p], xreg[p])
        assert torch.equal(out[-1][p], one[-1])
        for a, b in zip(out[:-1], one[:-1]):
            assert max_rel(b, a[p]) <= 1e-8
        one = fsc.trial_rollout_fused(probs[p].segments[0], batch.x0[p],
                                      xs[p], us[p], k[p], K[p], fs[p],
                                      alpha[p])
        assert torch.equal(roll[-1][p], one[-1])
        for a, b in zip(roll[:-1], one[:-1]):
            assert max_rel(b, a[p]) <= 1e-12
