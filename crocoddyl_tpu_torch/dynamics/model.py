"""Kinematic-tree robot model and its builder (port of
crocoddyl_tpu/dynamics/model.py).

The tree structure (joint types, parents, frame attachments, names) is
static pytree metadata; the numbers are tensor leaves.  Configuration
layout follows Pinocchio: a free flyer contributes (x y z | qx qy qz qw) to
q and a body-frame [lin; ang] velocity to v; revolute/prismatic joints one
dof each.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

import numpy as np
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

    def random_q(self, generator: torch.Generator, dtype=None) -> torch.Tensor:
        """A random configuration (model.py:110-123) drawn from
        ``generator`` in place of the JAX key: a free flyer's position
        uniform in [-1, 1)³ and a normalized Gaussian quaternion, every
        other joint uniform in [-π, π)."""
        dtype = dtype or self.jp_p.dtype
        parts = []
        for t in self.joint_types:
            if JointType(t) == JointType.FREE_FLYER:
                p = 2.0 * torch.rand(3, generator=generator, dtype=dtype) - 1.0
                quat = torch.randn(4, generator=generator, dtype=dtype)
                parts += [p, quat / torch.linalg.norm(quat)]
            else:
                parts.append((2.0 * torch.rand(1, generator=generator,
                                               dtype=dtype) - 1.0) * np.pi)
        return torch.cat(parts).to(self.jp_p.device)


class ModelBuilder:
    """Imperative numpy builder that freezes into a RobotModel of CPU
    tensors (model.py:126-211)."""

    def __init__(self, gravity=(0.0, 0.0, -9.81), dtype=torch.float64):
        self.dtype = dtype
        self.np_dtype = np.float32 if dtype == torch.float32 else np.float64
        self.joint_types, self.parents, self.joint_names = [], [], []
        self.jp_R, self.jp_p, self.axis = [], [], []
        self.mass, self.com, self.inertia = [], [], []
        self.frame_names, self.frame_parents = [], []
        self.fp_R, self.fp_p = [], []
        self.q_lb, self.q_ub, self.v_limit, self.effort_limit = [], [], [], []
        self.gravity = np.asarray(gravity, self.np_dtype)

    def add_joint(self, jtype: JointType, parent: int, name: str,
                  placement_R=None, placement_p=None, axis=(0.0, 0.0, 1.0),
                  mass=1.0, com=(0.0, 0.0, 0.0), inertia=None,
                  q_lim: Optional[Tuple[float, float]] = None,
                  v_lim: float = np.inf, effort_lim: float = np.inf) -> int:
        """Add a joint and its attached body; returns the joint index."""
        dt = self.np_dtype
        self.joint_types.append(int(jtype))
        self.parents.append(parent)
        self.joint_names.append(name)
        self.jp_R.append(np.eye(3, dtype=dt) if placement_R is None
                         else np.asarray(placement_R))
        self.jp_p.append(np.zeros(3, dtype=dt) if placement_p is None
                         else np.asarray(placement_p))
        a = np.asarray(axis, dt)
        self.axis.append(a / np.linalg.norm(a))
        self.mass.append(mass)
        self.com.append(np.asarray(com, dt))
        inertia = np.asarray(0.1 * np.eye(3) if inertia is None else inertia,
                             dt)
        self.inertia.append(np.diag(inertia) if inertia.ndim == 1
                            else inertia)
        if jtype == JointType.FREE_FLYER:
            # free-flyer position limits are ±∞ (multibody.hxx:25-35)
            lo, hi = -np.inf, np.inf
        else:
            lo, hi = q_lim if q_lim is not None else (-np.inf, np.inf)
        self.q_lb += [lo] * _NQ[jtype]
        self.q_ub += [hi] * _NQ[jtype]
        self.v_limit += [v_lim] * _NV[jtype]
        self.effort_limit += [effort_lim] * _NV[jtype]
        return len(self.joint_types) - 1

    def add_frame(self, name: str, parent_joint: int, placement_R=None,
                  placement_p=None) -> int:
        dt = self.np_dtype
        self.frame_names.append(name)
        self.frame_parents.append(parent_joint)
        self.fp_R.append(np.eye(3, dtype=dt) if placement_R is None
                         else np.asarray(placement_R))
        self.fp_p.append(np.zeros(3, dtype=dt) if placement_p is None
                         else np.asarray(placement_p))
        return len(self.frame_names) - 1

    def build(self) -> RobotModel:
        dt = self.np_dtype

        def t(a):
            return torch.as_tensor(np.asarray(a, dt))
        return RobotModel(
            joint_types=tuple(self.joint_types),
            parents=tuple(self.parents),
            joint_names=tuple(self.joint_names),
            frame_names=tuple(self.frame_names) or ("__world__",),
            frame_parents=tuple(self.frame_parents) or (0,),
            jp_R=t(np.stack(self.jp_R)), jp_p=t(np.stack(self.jp_p)),
            axis=t(np.stack(self.axis)), mass=t(self.mass),
            com=t(np.stack(self.com)), inertia=t(np.stack(self.inertia)),
            fp_R=t(np.stack(self.fp_R or [np.eye(3)])),
            fp_p=t(np.stack(self.fp_p or [np.zeros(3)])),
            gravity=t(self.gravity), q_lb=t(self.q_lb), q_ub=t(self.q_ub),
            v_limit=t(self.v_limit), effort_limit=t(self.effort_limit))
