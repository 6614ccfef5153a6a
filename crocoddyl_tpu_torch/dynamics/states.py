"""Multibody state manifold x = (q, v) (port of
crocoddyl_tpu/dynamics/states.py: diff and integrate).

At most one free flyer, and it is joint 0, so q = [p(3), quat(4), θ...] and
the manifold is SE(3) × Rᵏ.
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
