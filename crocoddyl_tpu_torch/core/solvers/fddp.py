"""Solver settings and solution (port of ``SolverSettings`` and ``Solution``
from crocoddyl_tpu/core/solvers/fddp.py).

The single-problem ``solve`` is not ported yet; the main path is
:func:`~crocoddyl_tpu_torch.core.solvers.fddp_batch.solve_batch`.  Its
raiseIfNaN predicate ``_bad`` is not ported either: only ``solve`` calls it,
and the batch solver inlines it per problem, as the JAX batch solver does.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration; defaults mirror the JAX package.  The
    JAX fields that select paths the port does not have (parallel Riccati,
    the ms_chunk forward pass, fused scans, callbacks) are left out;
    ``box``, ``parallel_linesearch`` and ``record_trace`` stay so that
    ``solve_batch`` can refuse them."""

    maxiter: int = 100
    feasibility_driven: bool = True
    th_acceptstep: float = 0.1
    th_stop: float = 1e-9
    th_grad: float = 1e-12
    th_stepdec: float = 0.5
    th_stepinc: float = 0.01
    th_acceptnegstep: float = 2.0
    th_blowup: float = 1e6
    regfactor: float = 10.0
    regmin: float = 1e-9
    regmax: float = 1e9
    n_alphas: int = 10
    parallel_linesearch: bool = True
    record_trace: bool = True
    box: bool = False

    @property
    def alphas(self):
        return [1.0 / (2.0 ** n) for n in range(self.n_alphas)]


@dataclasses.dataclass
class Solution:
    """Solver output; leaves carry a leading problem axis B."""

    xs: torch.Tensor          # (B, T+1, nx)
    us: torch.Tensor          # (B, T, nu)
    K: torch.Tensor           # (B, T, nu, ndx)
    k: torch.Tensor           # (B, T, nu)
    Vx: torch.Tensor          # (B, T+1, ndx)
    Vxx: torch.Tensor         # (B, T+1, ndx, ndx)
    Qu: torch.Tensor          # (B, T, nu)
    fs: torch.Tensor          # (B, T+1, ndx)
    cost: torch.Tensor
    stop: torch.Tensor
    xreg: torch.Tensor
    ureg: torch.Tensor
    steplength: torch.Tensor
    d0: torch.Tensor
    d1: torch.Tensor
    iter: torch.Tensor
    is_feasible: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor
