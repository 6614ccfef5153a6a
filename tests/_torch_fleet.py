"""The ranks of tests/test_torch_parallel.py: functions that
``crocoddyl_tpu_torch.parallel.spawn`` runs in spawned gloo ranks on the
CPU.  They import only torch, numpy and the port (a rank is a fresh
process: no JAX, and nothing of tests/_torch_parity.py, whose import starts
the session's JAX references).  Not a test module itself.
"""

from __future__ import annotations

import numpy as np
import torch

FEET = ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"]
# the unicycle solves of tests/test_mesh.py:38-40
UNICYCLE_MAXITER = 40
# the uneven batch of the fleet metrics, and the batched problem's size
B_UNEVEN = 7
B_PROBLEMS = 6
# the reduced walk's split: B problems, solve_batch(maxiter=WALK_MAXITER)
B_WALK = 4
WALK_MAXITER = 1


def unicycle_problem():
    """tests/test_mesh.py:22-26 in the port."""
    from crocoddyl_tpu_torch import ShootingProblem, replicate_model
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    m = UnicycleModel()
    return ShootingProblem(x0=torch.tensor([-1.0, -1.0, 1.0],
                                           dtype=torch.float64),
                           running=replicate_model(m, 20), terminal=m)


def unicycle_solve(p):
    from crocoddyl_tpu_torch import SolverSettings, solve
    return solve(p, settings=SolverSettings(maxiter=UNICYCLE_MAXITER,
                                            record_trace=False),
                 device="cpu")


def walk():
    """The reduced ANYmal walk of tests/test_fddp_batch.py:29-30
    (step_knots=3, support_knots=1) built by the port's factory, its
    quasi-static warm start, and B_WALK initial states with seeded velocity
    perturbations: (problem, xs0, us0, x0s)."""
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.anymal(dtype=torch.float64)
    q0 = robots.anymal_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    prob = fac.walking_problem(x0, 0.25, 0.15, 1e-2, step_knots=3,
                               support_knots=1)
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)
    x0s = np.tile(x0.numpy()[None], (B_WALK, 1))
    x0s[:, m.nq:] += 0.01 * np.random.default_rng(0).standard_normal(
        (B_WALK, m.nv))
    return prob, xs0, us0, torch.tensor(x0s)


def walk_solve(prob, x0s, xs0, us0):
    from crocoddyl_tpu_torch import SolverSettings, solve_batch
    return solve_batch(prob, x0s, xs_init=xs0, us_init=us0,
                       settings=SolverSettings(maxiter=WALK_MAXITER,
                                               record_trace=False,
                                               parallel_linesearch=False),
                       device="cpu")


def solution_dict(sol):
    return {f: getattr(sol, f) for f in (
        "xs", "us", "cost", "iter", "steplength", "is_feasible",
        "converged", "diverged")}


def rank_all(rank, x0s):
    """Everything the tests ask of two ranks, in one spawn: the unicycle
    solves of ``x0s`` sharded and gathered, the fleet metrics over all of
    them and over the uneven first B_UNEVEN, ``batched_solve_fn`` over a
    problem batched from the first B_PROBLEMS, and the reduced walk split
    through ``solve_batch`` (this rank's slice and the gathered batch)."""
    from crocoddyl_tpu_torch.parallel import mesh as pmesh
    from crocoddyl_tpu_torch.utils.struct import tree_map
    torch.set_num_threads(1)
    mesh = pmesh.data_mesh(2)
    out = {"rank": mesh.rank, "size": mesh.size, "backend": mesh.backend,
           "device": str(mesh.device),
           "slice": pmesh.host_local_batch(len(x0s))}
    prob = unicycle_problem()
    x0s = torch.as_tensor(x0s)
    sol = pmesh.sharded_solve_x0(unicycle_solve, prob, mesh)(x0s)
    out["local_cost"] = sol.cost
    out["unicycle"] = solution_dict(pmesh.gather(sol, mesh))
    out["metrics"] = pmesh.fleet_metrics(sol, mesh)
    uneven = pmesh.sharded_solve_x0(unicycle_solve, prob, mesh)(
        x0s[:B_UNEVEN])
    out["metrics_uneven"] = pmesh.fleet_metrics(uneven, mesh)
    out["uneven_local"] = int(uneven.cost.shape[0])

    probs = tree_map(lambda l: l.expand((B_PROBLEMS,) + l.shape).clone(),
                     prob).replace(x0=x0s[:B_PROBLEMS].clone())
    costs = pmesh.batched_solve_fn(lambda p: unicycle_solve(p).cost,
                                   mesh)(probs)
    out["batched_local"] = costs
    out["batched"] = pmesh.gather(costs, mesh)

    wprob, xs0, us0, wx0s = walk()
    wsol = pmesh.sharded_solve_x0(
        lambda p, xs: walk_solve(p, xs, xs0, us0), wprob, mesh,
        batched=True)(wx0s)
    out["walk_local"] = solution_dict(wsol)
    out["walk"] = solution_dict(pmesh.gather(wsol, mesh))
    return out
