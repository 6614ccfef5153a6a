#!/usr/bin/env python3
"""How far the JAX package's own solves of two golden anchors move under
rounding-level perturbations, on the CPU in float64.

For examples/double_pendulum.py and examples/arm_manipulation.py, solve
from x0 and from x0 with its first velocity component moved by 1e-15,
1e-13 and 1e-11, with the example's own settings, and print converged,
iterations, cost and the cost's rtol to tests/golden.json.  An anchor
whose solve leaves the bar of tests/test_examples_golden.py (iterations
within 1, cost rtol 1e-5) under such a perturbation holds only
bit-identical rounding, and a port cannot be held to it.

For the double pendulum it also runs the port's generic backward pass
(crocoddyl_tpu_torch) and the JAX one on the same node derivatives (the
warm start of the solve) and prints their largest gain difference.

Usage: ``python3 golden_sensitivity.py`` from the repository root (CPU,
a few minutes).
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


def main():
    import arm_manipulation
    import double_pendulum
    import crocoddyl_tpu as ct
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)
    anchors = {
        "double_pendulum": (double_pendulum.make_problem(),
                            ct.SolverSettings(maxiter=300)),
        "arm_manipulation": (arm_manipulation.make_problem()[0],
                             ct.ddp_settings(maxiter=100))}
    for name, (prob, settings) in anchors.items():
        g = golden[name]
        nq = prob.state.nq
        for eps in (0.0, 1e-15, 1e-13, 1e-11):
            p = prob.replace(x0=prob.x0.at[nq].add(eps))
            sol = ct.solve(p, settings=settings)
            rc = abs(float(sol.cost) - g["cost"]) / abs(g["cost"])
            ok = (bool(sol.converged) == g["converged"]
                  and abs(int(sol.iter) - g["iters"]) <= 1 and rc <= 1e-5)
            print(f"{name} x0 + {eps:g}: converged {bool(sol.converged)}, "
                  f"{int(sol.iter)} iterations, cost {float(sol.cost)!r}, "
                  f"rtol {rc:.3e} to the golden ({g['iters']}, "
                  f"{g['cost']!r}): bar {'met' if ok else 'not met'}",
                  flush=True)
    riccati_gap(anchors["double_pendulum"][0])


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
    main()
