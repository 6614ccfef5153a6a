"""Multibody state manifold x = (q, v) (port of
crocoddyl_tpu/dynamics/states.py).

At most one free flyer, and it is joint 0, so q = [p(3), quat(4), θ...] and
the manifold is SE(3) × Rᵏ.  The jdiff / jintegrate Jacobians are identity
but for the 6×6 free-flyer block, which takes the closed-form SE(3) right
Jacobian, its inverse and the adjoint (lie.py).
"""

from __future__ import annotations

import torch

from ..core.manifolds import StateBase
from . import lie
from .model import JointType, RobotModel
from .spatial import Transform


class StateMultibody(StateBase):
    model: RobotModel

    @property
    def nq(self) -> int:
        return self.model.nq

    @property
    def nv(self) -> int:
        return self.model.nv

    @property
    def nx(self) -> int:
        return self.model.nq + self.model.nv

    @property
    def ndx(self) -> int:
        return 2 * self.model.nv

    def zero(self) -> torch.Tensor:
        m = self.model
        return torch.cat([m.neutral(), torch.zeros(
            self.nv, dtype=m.jp_p.dtype, device=m.jp_p.device)])

    def rand(self, generator: torch.Generator) -> torch.Tensor:
        """A random configuration (``RobotModel.random_q``) and velocities
        uniform in [-1, 1), drawn from ``generator``."""
        q = self.model.random_q(generator)
        v = 2.0 * torch.rand(self.nv, generator=generator,
                             dtype=q.dtype) - 1.0
        return torch.cat([q, v.to(q.device)])

    @property
    def has_ff(self) -> bool:
        return JointType(self.model.joint_types[0]) == JointType.FREE_FLYER

    def _ff_transform(self, q) -> Transform:
        return Transform(lie.quat_to_rot(q[..., 3:7]), q[..., :3])

    def _q_diff(self, q0, q1):
        if not self.has_ff:
            return q1 - q0
        M01 = self._ff_transform(q0).inverse().compose(self._ff_transform(q1))
        return torch.cat([lie.log6(M01.R, M01.p), q1[..., 7:] - q0[..., 7:]],
                         dim=-1)

    def _q_integrate(self, q, dq):
        if not self.has_ff:
            return q + dq
        dR, dp = lie.exp6(dq[..., :6])
        Mn = self._ff_transform(q).compose(Transform(dR, dp))
        qn = lie.quat_normalize(lie.rot_to_quat(Mn.R))
        return torch.cat([Mn.p, qn, q[..., 7:] + dq[..., 6:]], dim=-1)

    def diff(self, x0, x1):
        nq = self.nq
        dq = self._q_diff(x0[..., :nq], x1[..., :nq])
        return torch.cat([dq, x1[..., nq:] - x0[..., nq:]], dim=-1)

    def integrate(self, x, dx):
        nq, nv = self.nq, self.nv
        qn = self._q_integrate(x[..., :nq], dx[..., :nv])
        return torch.cat([qn, x[..., nq:] + dx[..., nv:]], dim=-1)

    # -- closed-form Jacobians (states.py:96-138) ---------------------------
    def _embed_ff(self, block6, diag_val: float):
        """(ndx, ndx) diag(diag_val) with the top-left 6×6 block replaced
        (the free-flyer tangent block)."""
        J = diag_val * torch.eye(self.ndx, dtype=block6.dtype,
                                 device=block6.device)
        return torch.cat([torch.cat([block6, J[:6, 6:]], 1), J[6:]], 0)

    def jdiff(self, x0, x1):
        """(∂(x1 ⊖ x0)/∂x0, ∂(x1 ⊖ x0)/∂x1) in tangent coordinates."""
        dt = torch.promote_types(x0.dtype, x1.dtype)
        if not self.has_ff:
            eye = torch.eye(self.ndx, dtype=dt, device=x1.device)
            return -eye, eye
        nq = self.nq
        D = self._ff_transform(x0[:nq]).inverse().compose(
            self._ff_transform(x1[:nq]))
        Jri = lie.jac_se3_right_inv(lie.log6(D.R, D.p))
        Dinv = D.inverse()
        J0 = self._embed_ff(-Jri @ lie.se3_adjoint(Dinv.R, Dinv.p), -1.0)
        return J0, self._embed_ff(Jri, 1.0)

    def jintegrate(self, x, dx):
        """(∂(x ⊕ dx)/∂x, ∂(x ⊕ dx)/∂dx) in tangent coordinates."""
        dt = torch.promote_types(x.dtype, dx.dtype)
        if not self.has_ff:
            eye = torch.eye(self.ndx, dtype=dt, device=x.device)
            return eye, eye
        xi = dx[:6]
        eR, ep = lie.exp6(-xi)
        return (self._embed_ff(lie.se3_adjoint(eR, ep), 1.0),
                self._embed_ff(lie.jac_se3_right(xi), 1.0))

    def jintegrate_transport(self, x, dx, jac, firstsecond: str = "first"):
        """The Jintegrate block times ``jac``: only the 6 free-flyer rows
        change."""
        if not self.has_ff:
            return jac
        xi = dx[:6]
        if firstsecond == "first":
            eR, ep = lie.exp6(-xi)
            blk = lie.se3_adjoint(eR, ep)
        else:
            blk = lie.jac_se3_right(xi)
        return torch.cat([blk @ jac[:6], jac[6:]], 0)
