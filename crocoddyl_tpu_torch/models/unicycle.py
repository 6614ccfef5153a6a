"""Unicycle action model (port of crocoddyl_tpu/models/unicycle.py).

Reference: include/crocoddyl/core/actions/unicycle.hxx:20-73 — state (x, y, θ),
controls (v, ω), dynamics xnext = x + [cosθ·v·dt, sinθ·v·dt, ω·dt], residual
r = [w0·x, w1·u] and cost ½‖r‖², with default dt=0.1, w=(10, 1).  The
reference's closed-form calcDiff is reproduced exactly (Gauss-Newton: the cost
Hessian keeps only wᵢ² diagonals and Fx keeps only the dynamics terms).
"""

from __future__ import annotations

import torch

from ..core.action import ActionModel, NodeDerivs
from ..core.manifolds import StateVector
from ..utils.struct import field


def _f64(*v):
    return lambda: torch.tensor(v if len(v) > 1 else v[0],
                                dtype=torch.float64)


class UnicycleModel(ActionModel):
    dt: torch.Tensor = field(default_factory=_f64(0.1))
    cost_weights: torch.Tensor = field(default_factory=_f64(10.0, 1.0))

    @property
    def state(self) -> StateVector:
        return StateVector(nx_=3)

    @property
    def nu(self) -> int:
        return 2

    def calc(self, x, u):
        c, s = torch.cos(x[2]), torch.sin(x[2])
        xnext = torch.stack([
            x[0] + c * u[0] * self.dt,
            x[1] + s * u[0] * self.dt,
            x[2] + u[1] * self.dt,
        ])
        w0, w1 = self.cost_weights[0], self.cost_weights[1]
        r = torch.cat([w0 * x, w1 * u])
        return xnext, 0.5 * torch.dot(r, r)

    def calc_terminal(self, x):
        r = self.cost_weights[0] * x
        return 0.5 * torch.dot(r, r)

    def calc_diff(self, x, u) -> NodeDerivs:
        dt_ = x.dtype
        w_x = (self.cost_weights[0] ** 2).to(dt_)
        w_u = (self.cost_weights[1] ** 2).to(dt_)
        c, s = torch.cos(x[2]), torch.sin(x[2])
        zero = torch.zeros_like(c)
        one = torch.ones_like(c)
        dt = self.dt.to(dt_)
        Fx = torch.stack([
            torch.stack([one, zero, -s * u[0] * dt]),
            torch.stack([zero, one, c * u[0] * dt]),
            torch.stack([zero, zero, one])])
        Fu = torch.stack([
            torch.stack([c * dt, zero]),
            torch.stack([s * dt, zero]),
            torch.stack([zero, dt])])
        eye3 = torch.eye(3, dtype=dt_, device=x.device)
        return NodeDerivs(
            Fx=Fx, Fu=Fu, Lx=w_x * x, Lu=w_u * u, Lxx=w_x * eye3,
            Lxu=torch.zeros((3, 2), dtype=dt_, device=x.device),
            Luu=w_u * torch.eye(2, dtype=dt_, device=x.device))

    def calc_diff_terminal(self, x) -> NodeDerivs:
        dt_ = x.dtype
        w_x = (self.cost_weights[0] ** 2).to(dt_)
        z = dict(dtype=dt_, device=x.device)
        return NodeDerivs(
            Fx=torch.eye(3, **z), Fu=torch.zeros((3, 2), **z), Lx=w_x * x,
            Lu=torch.zeros((2,), **z), Lxx=w_x * torch.eye(3, **z),
            Lxu=torch.zeros((3, 2), **z), Luu=torch.zeros((2, 2), **z))
