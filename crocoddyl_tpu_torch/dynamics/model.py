"""Kinematic-tree robot model (port of crocoddyl_tpu/dynamics/model.py).

The tree structure (joint types, parents, frame attachments, names) is
static pytree metadata; the numbers are tensor leaves.  Configuration
layout follows Pinocchio: a free flyer contributes (x y z | qx qy qz qw) to
q and a body-frame [lin; ang] velocity to v; revolute/prismatic joints one
dof each.
"""

from __future__ import annotations

import enum
from typing import Tuple

import torch

from ..utils.struct import PyTreeNode, field


class JointType(enum.IntEnum):
    FREE_FLYER = 0
    REVOLUTE = 1
    PRISMATIC = 2


_NQ = {JointType.FREE_FLYER: 7, JointType.REVOLUTE: 1, JointType.PRISMATIC: 1}
_NV = {JointType.FREE_FLYER: 6, JointType.REVOLUTE: 1, JointType.PRISMATIC: 1}


class RobotModel(PyTreeNode):
    joint_types: Tuple[int, ...] = field(static=True)
    parents: Tuple[int, ...] = field(static=True)          # -1 = world
    joint_names: Tuple[str, ...] = field(static=True)
    frame_names: Tuple[str, ...] = field(static=True)
    frame_parents: Tuple[int, ...] = field(static=True)    # joint index

    jp_R: torch.Tensor      # (nj, 3, 3) joint placement in the parent frame
    jp_p: torch.Tensor      # (nj, 3)
    axis: torch.Tensor      # (nj, 3)
    mass: torch.Tensor      # (nj,)
    com: torch.Tensor       # (nj, 3) body com in the joint frame
    inertia: torch.Tensor   # (nj, 3, 3) rotational inertia about the com
    fp_R: torch.Tensor      # (nf, 3, 3) frame placement in its joint frame
    fp_p: torch.Tensor      # (nf, 3)
    gravity: torch.Tensor   # (3,)
    q_lb: torch.Tensor      # (nq,)
    q_ub: torch.Tensor      # (nq,)
    v_limit: torch.Tensor   # (nv,)
    effort_limit: torch.Tensor  # (nv,)

    @property
    def njoints(self) -> int:
        return len(self.joint_types)

    @property
    def nq(self) -> int:
        return sum(_NQ[JointType(t)] for t in self.joint_types)

    @property
    def nv(self) -> int:
        return sum(_NV[JointType(t)] for t in self.joint_types)

    @property
    def nframes(self) -> int:
        return len(self.frame_names)

    def q_slices(self):
        out, i = [], 0
        for t in self.joint_types:
            n = _NQ[JointType(t)]
            out.append((i, n))
            i += n
        return tuple(out)

    def v_slices(self):
        out, i = [], 0
        for t in self.joint_types:
            n = _NV[JointType(t)]
            out.append((i, n))
            i += n
        return tuple(out)

    def frame_id(self, name: str) -> int:
        return self.frame_names.index(name)

    def neutral(self, dtype=None) -> torch.Tensor:
        dtype = dtype or self.jp_p.dtype
        parts = []
        for t in self.joint_types:
            if JointType(t) == JointType.FREE_FLYER:
                parts.append(torch.tensor([0, 0, 0, 0, 0, 0, 1.0], dtype=dtype))
            else:
                parts.append(torch.zeros(1, dtype=dtype))
        return torch.cat(parts).to(self.jp_p.device)
