"""Baumgarte-gain grid search (port of examples/baumgarte_grid_search.py,
the analogue of RH5/plotGridSearch.py).

The quadruped walk is built once per contact gain Kv; the walks share one
structure (the gains are tensor leaves), so stacking them gives a batch of
problems that ``vmap_solve`` solves as one FDDP program: one node-kernel
launch a linearization for the whole grid on the card.

Run from the repository's root::

    python3 -m crocoddyl_tpu_torch.examples.baumgarte_grid_search
    python3 -m crocoddyl_tpu_torch.examples.baumgarte_grid_search \\
        --device cpu --out /path/to/grid.csv

The table goes to standard output and to a CSV (kv, converged, iters,
final_cost), by default ``chiprun_out/baumgarte_grid_search.csv`` under
the repository's root.
"""

from __future__ import annotations

import argparse
import csv
import os

import torch

GRID = (0.0, 12.5, 25.0, 50.0, 100.0, 200.0)
FEET = ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"]
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_OUT = os.path.join(ROOT, "chiprun_out", "baumgarte_grid_search.csv")


def make_problem(kv, step_knots=6, support_knots=1):
    """The example's walk (examples/baumgarte_grid_search.py:35-48) with
    contact gains (0, kv), float64 on the CPU: (problem, x0)."""
    from ..apps.gaits import QuadrupedGaitFactory
    from ..dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=q0.dtype)])

    class Factory(QuadrupedGaitFactory):
        contact_gains = (0.0, float(kv))

    fac = Factory(m, FEET, default_q=q0)
    prob = fac.walking_problem(x0, 0.15, 0.1, 1e-2, step_knots=step_knots,
                               support_knots=support_knots)
    return prob, x0


def grid_problems(grid=GRID, step_knots=6, support_knots=1):
    """(the single problems, their batch, the shared warm start xs0, us0):
    x0 held at every knot and the first problem's quasi-static controls
    (examples/baumgarte_grid_search.py:51-57)."""
    from ..utils.struct import tree_map
    probs = [make_problem(kv, step_knots, support_knots)[0] for kv in grid]
    x0 = probs[0].x0
    xs0 = x0[None].expand(probs[0].T + 1, -1).clone()
    us0 = probs[0].quasi_static(xs0)
    batch = tree_map(lambda *ls: torch.stack(ls), *probs)
    return probs, batch, xs0, us0


def sweep(batch, xs0, us0, settings=None, device=None):
    """One batched solve of the grid; returns the Solution (leaves with the
    grid's axis)."""
    from .. import SolverSettings, solve, vmap_solve
    settings = settings or SolverSettings(maxiter=60, record_trace=False)
    return vmap_solve(lambda p: solve(p, xs_init=xs0, us_init=us0,
                                      settings=settings, device=device))(
        batch)


def write_csv(path, grid, sol):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["kv", "converged", "iters", "final_cost"])
        for kv, c, it, cv in zip(grid, sol.cost.tolist(), sol.iter.tolist(),
                                 sol.converged.tolist()):
            w.writerow([kv, bool(cv), int(it), float(c)])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--out", default=DEFAULT_OUT, help="the CSV's path")
    args = ap.parse_args(argv)
    _, batch, xs0, us0 = grid_problems()
    sol = sweep(batch, xs0, us0, device=args.device)
    print(f"{'Kv':>8} {'converged':>10} {'iters':>6} {'final cost':>14}")
    out = {}
    for kv, c, it, cv in zip(GRID, sol.cost.tolist(), sol.iter.tolist(),
                             sol.converged.tolist()):
        print(f"{kv:8.1f} {str(bool(cv)):>10} {int(it):6d} {c:14.6e}")
        out[float(kv)] = (c, int(it), bool(cv))
    write_csv(args.out, GRID, sol)
    print("wrote", args.out)
    return out


if __name__ == "__main__":
    main()
