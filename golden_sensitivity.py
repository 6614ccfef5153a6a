#!/usr/bin/env python3
"""How far the JAX package's own solves of golden anchors move under
rounding-level perturbations, on the CPU in float64.

For the anchors examples/double_pendulum.py, examples/arm_manipulation.py,
the CoP walk of examples/bipedal_walk_cop.py (``bipedal_walk_cop_fast``),
examples/humanoid_taichi.py (``humanoid_taichi_fast``) and
examples/quadrotor.py (``quadrotor``, ``quadrotor_ubound``), solve from x0
and from x0 with its first velocity component moved by 1e-15, 1e-13 and
1e-11, with the configuration of tests/golden_configs.py (a warm start of
the state tiled from that x0 and the quasi-static controls where the
example takes one), and print converged, iterations, cost and the cost's
rtol to tests/golden.json.  The true-impulse walk of
tests/test_gaits.py:104-118 (``quadruped_walk_true_impulse``: 8 segments,
T=22, ``maxiter=60``) has no record there: its solves are held to the
solve from x0 instead.  An anchor
whose solve leaves the bar of tests/test_examples_golden.py (iterations
within 1, cost rtol 1e-5) under such a perturbation holds only
bit-identical rounding, and a port cannot be held to it.

For the double pendulum it also runs the port's generic backward pass
(crocoddyl_tpu_torch) and the JAX one on the same node derivatives (the
warm start of the solve) and prints their largest gain difference.

Usage: ``python3 golden_sensitivity.py [anchor ...]`` from the repository
root (CPU; all anchors by default, ~15 min; the biped's and the humanoid's
solves take minutes to compile).
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "examples"))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp  # noqa: E402


def anchors():
    """{golden: (problem, settings, warm)}: ``warm`` solves from the state
    tiled from x0 and the quasi-static controls."""
    import arm_manipulation
    import bipedal_walk_cop
    import double_pendulum
    import humanoid_taichi
    import quadrotor
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.dynamics import robots
    m = robots.biped()
    q0 = robots.biped_standing_q(m)
    cop = bipedal_walk_cop.CoPBipedGaitFactory(
        m, ["right_sole", "left_sole"], default_q=np.asarray(q0))
    cop = cop.walking_problem(jnp.concatenate([q0, jnp.zeros(m.nv)]), 0.6,
                              0.1, 0.03, step_knots=6, support_knots=3)
    return {
        "double_pendulum": (double_pendulum.make_problem(),
                            ct.SolverSettings(maxiter=300), False),
        "arm_manipulation": (arm_manipulation.make_problem()[0],
                             ct.ddp_settings(maxiter=100), False),
        "bipedal_walk_cop_fast": (cop, ct.SolverSettings(maxiter=150), True),
        "humanoid_taichi_fast": (humanoid_taichi.make_problem(T_phase=4)[0],
                                 ct.SolverSettings(maxiter=40), True),
        "quadrotor": (quadrotor.make_problem(),
                      ct.SolverSettings(maxiter=200), False),
        "quadrotor_ubound": (quadrotor.make_problem(ubound=True),
                             ct.SolverSettings(maxiter=200), False),
        "quadruped_walk_true_impulse": (
            impulse_walk(), ct.SolverSettings(maxiter=60,
                                              record_trace=False), True)}


def impulse_walk():
    """tests/test_gaits.py:104-118: the quadruped's walk with true impulse
    switch knots (8 segments, T=22)."""
    from crocoddyl_tpu.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    fac = QuadrupedGaitFactory(m, ["LF_FOOT", "RF_FOOT", "LH_FOOT",
                                   "RH_FOOT"], default_q=np.asarray(q0))
    return fac.walking_problem(jnp.concatenate([q0, jnp.zeros(m.nv)]), 0.1,
                               0.05, 1e-2, step_knots=4, support_knots=1,
                               pseudo_impulse=False)


def main(names):
    import crocoddyl_tpu as ct
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)
    table = anchors()
    for name in names or table:
        prob, settings, warm = table[name]
        g = golden.get(name)
        nq = prob.state.nq
        for eps in (0.0, 1e-15, 1e-13, 1e-11):
            p = prob.replace(x0=prob.x0.at[nq].add(eps))
            xs = us = None
            if warm:
                xs = jnp.tile(p.x0[None], (p.T + 1, 1))
                us = p.quasi_static(xs)
            sol = ct.solve(p, xs_init=xs, us_init=us, settings=settings)
            if g is None:     # no record: the solve from x0 is the bar
                g = dict(converged=bool(sol.converged), iters=int(sol.iter),
                         cost=float(sol.cost))
            rc = abs(float(sol.cost) - g["cost"]) / abs(g["cost"])
            ok = (bool(sol.converged) == g["converged"]
                  and abs(int(sol.iter) - g["iters"]) <= 1 and rc <= 1e-5)
            print(f"{name} x0 + {eps:g}: converged {bool(sol.converged)}, "
                  f"{int(sol.iter)} iterations, cost {float(sol.cost)!r}, "
                  f"rtol {rc:.3e} to the golden ({g['iters']}, "
                  f"{g['cost']!r}): bar {'met' if ok else 'not met'}",
                  flush=True)
    if not names or "double_pendulum" in names:
        riccati_gap(table["double_pendulum"][0])


def riccati_gap(prob):
    """The port's and the JAX package's backward passes on the same node
    derivatives: the largest difference of the gains over their max-abs."""
    import torch
    from crocoddyl_tpu.core.solvers import fddp as jf
    from crocoddyl_tpu_torch.core.action import NodeDerivs
    from crocoddyl_tpu_torch.core.solvers import fddp as tf
    xs = jnp.tile(prob.x0[None], (prob.T + 1, 1))
    us = jnp.zeros((prob.T, prob.nu))
    d, dterm, _, _ = prob.calc_diff_full(xs, us)
    fs = jnp.zeros_like(xs)
    ref = jf._backward_pass(d, dterm, fs, 1e-9, 1e-9)

    def port(nd):
        return NodeDerivs(**{f: torch.tensor(np.asarray(getattr(nd, f)))
                             for f in NodeDerivs.__dataclass_fields__})
    reg = torch.tensor(1e-9, dtype=torch.float64)
    out = tf._backward_pass(port(d), port(dterm),
                            torch.tensor(np.asarray(fs)), reg, reg)
    for i, name in ((3, "k"), (4, "K")):
        a, b = np.asarray(ref[i]), out[i].numpy()
        print(f"double_pendulum backward pass, port vs JAX on the same "
              f"derivatives: {name} max-abs difference over max-abs "
              f"{np.abs(a - b).max() / np.abs(a).max():.3e}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
