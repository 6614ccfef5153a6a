"""Discrete and continuous-time LQR action models (port of
crocoddyl_tpu/models/lqr.py).

Reference: include/crocoddyl/core/actions/lqr.hxx — dynamics
xnext = Fx·x + Fu·u (+ f0 unless drift-free), cost
½xᵀLxx x + ½uᵀLuu u + xᵀLxu u + lxᵀx + luᵀu; defaults are identity/ones.
"""

from __future__ import annotations

import torch

from ..core.action import ActionModel, NodeDerivs
from ..core.manifolds import StateVector
from ..utils.struct import tree_map


def _eye(n, m, dtype):
    return torch.eye(n, m, dtype=dtype)


class LQRModel(ActionModel):
    Fx: torch.Tensor
    Fu: torch.Tensor
    f0: torch.Tensor
    Lxx: torch.Tensor
    Lxu: torch.Tensor
    Luu: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor

    @property
    def state(self) -> StateVector:
        return StateVector(nx_=self.Fx.shape[-1])

    @property
    def nu(self) -> int:
        return self.Fu.shape[-1]

    def calc(self, x, u):
        xnext = self.Fx @ x + self.Fu @ u + self.f0
        cost = (0.5 * x @ (self.Lxx @ x) + 0.5 * u @ (self.Luu @ u)
                + x @ (self.Lxu @ u) + self.lx @ x + self.lu @ u)
        return xnext, cost

    def calc_diff(self, x, u) -> NodeDerivs:
        return NodeDerivs(
            Fx=self.Fx, Fu=self.Fu,
            Lx=self.lx + self.Lxx @ x + self.Lxu @ u,
            Lu=self.lu + self.Lxu.T @ x + self.Luu @ u,
            Lxx=self.Lxx, Lxu=self.Lxu, Luu=self.Luu)


def lqr_model(nx: int, nu: int, drift_free: bool = False,
              dtype=torch.float64) -> LQRModel:
    """Defaults mirror the reference constructor (lqr.hxx:14-26)."""
    f0 = torch.zeros if drift_free else torch.ones
    return LQRModel(
        Fx=_eye(nx, nx, dtype), Fu=_eye(nx, nu, dtype),
        f0=f0((nx,), dtype=dtype), Lxx=_eye(nx, nx, dtype),
        Lxu=_eye(nx, nu, dtype), Luu=_eye(nu, nu, dtype),
        lx=torch.ones((nx,), dtype=dtype), lu=torch.ones((nu,), dtype=dtype))


class DiffLQRModel(ActionModel):
    """Continuous-time LQR fused with semi-implicit Euler integration.

    Reference: include/crocoddyl/core/actions/diff-lqr.hxx:46-80 —
    acceleration v̇ = Fq·q + Fv·v + Fu·u (+ f0 unless drift-free) with the
    quadratic cost RATE ½xᵀLxx x + ½uᵀLuu u + xᵀLxu u + lxᵀx + luᵀu,
    discretized per IntegratedActionModelEuler (euler.hxx:41-131):
    dx = [v·dt + a·dt²; a·dt], cost·dt, dt=0 ⇒ terminal node.
    """

    Fq: torch.Tensor
    Fv: torch.Tensor
    Fu_: torch.Tensor
    f0: torch.Tensor
    Lxx: torch.Tensor
    Lxu: torch.Tensor
    Luu: torch.Tensor
    lx: torch.Tensor
    lu: torch.Tensor
    dt: torch.Tensor = None

    @property
    def nq(self) -> int:
        return self.Fq.shape[-1]

    @property
    def state(self) -> StateVector:
        return StateVector(nx_=2 * self.Fq.shape[-1])

    @property
    def nu(self) -> int:
        return self.Fu_.shape[-1]

    def _xout(self, x, u):
        nq = self.nq
        return self.Fq @ x[:nq] + self.Fv @ x[nq:] + self.Fu_ @ u + self.f0

    def _cost_rate(self, x, u):
        return (0.5 * x @ (self.Lxx @ x) + 0.5 * u @ (self.Luu @ u)
                + x @ (self.Lxu @ u) + self.lx @ x + self.lu @ u)

    def calc(self, x, u):
        nq = self.nq
        a = self._xout(x, u)
        dt = self.dt
        dx = torch.cat([x[nq:] * dt + a * dt * dt, a * dt])
        is_term = dt == 0.0
        rate = self._cost_rate(x, u)
        return (torch.where(is_term, x, x + dx),
                torch.where(is_term, rate, dt * rate))

    def calc_diff(self, x, u) -> NodeDerivs:
        nq = self.nq
        z = dict(dtype=x.dtype, device=x.device)
        dt = self.dt
        # da/dx = [Fq Fv]; Euler chain rule (euler.hxx:103-121, Euclidean)
        da_dx = torch.cat([self.Fq, self.Fv], 1)
        dv_dx = torch.cat([torch.zeros((nq, nq), **z),
                           torch.eye(nq, **z)], 1)
        Fx_i = torch.eye(2 * nq, **z) + torch.cat(
            [dt * dv_dx + dt * dt * da_dx, dt * da_dx], 0)
        Fu_i = torch.cat([dt * dt * self.Fu_, dt * self.Fu_], 0)
        is_term = dt == 0.0
        scale = torch.where(is_term, torch.ones_like(dt), dt)
        Lx = self.lx + self.Lxx @ x + self.Lxu @ u
        Lu = self.lu + self.Lxu.T @ x + self.Luu @ u
        return NodeDerivs(
            Fx=torch.where(is_term, torch.eye(2 * nq, **z), Fx_i),
            Fu=torch.where(is_term, torch.zeros_like(Fu_i), Fu_i),
            Lx=scale * Lx, Lu=scale * Lu, Lxx=scale * self.Lxx,
            Lxu=scale * self.Lxu, Luu=scale * self.Luu)


def diff_lqr_model(nq: int, nu: int, dt: float = 0.1,
                   drift_free: bool = False,
                   dtype=torch.float64) -> DiffLQRModel:
    """Defaults mirror the reference constructor (diff-lqr.hxx:15-28)."""
    f0 = torch.zeros if drift_free else torch.ones
    return DiffLQRModel(
        Fq=_eye(nq, nq, dtype), Fv=_eye(nq, nq, dtype),
        Fu_=_eye(nq, nu, dtype), f0=f0((nq,), dtype=dtype),
        Lxx=_eye(2 * nq, 2 * nq, dtype), Lxu=_eye(2 * nq, nu, dtype),
        Luu=_eye(nu, nu, dtype), lx=torch.ones((2 * nq,), dtype=dtype),
        lu=torch.ones((nu,), dtype=dtype), dt=torch.tensor(dt, dtype=dtype))


def random_lqr_model(rng, nx: int, nu: int,
                     dtype=torch.float64) -> LQRModel:
    """A random well-conditioned LQR instance for tests (lqr.py:177-190),
    drawn from ``rng``: a ``torch.Generator`` or a ``numpy.random.Generator``
    (standard normals either way)."""
    if isinstance(rng, torch.Generator):
        def normal(*shape):
            return torch.randn(shape, generator=rng, dtype=torch.float64)
    else:
        def normal(*shape):
            return torch.from_numpy(rng.standard_normal(shape))
    Fx = 0.9 * torch.eye(nx, dtype=torch.float64) + 0.1 * normal(nx, nx)
    Fu = normal(nx, nu)
    H = normal(nx + nu, nx + nu)
    H = H @ H.T + (nx + nu) * torch.eye(nx + nu, dtype=torch.float64)
    f0 = 0.1 * normal(nx)
    lx, lu = normal(nx), normal(nu)
    m = LQRModel(Fx=Fx, Fu=Fu, f0=f0, Lxx=H[:nx, :nx], Lxu=H[:nx, nx:],
                 Luu=H[nx:, nx:], lx=lx, lu=lu)
    return tree_map(lambda l: l.to(dtype).contiguous(), m)
