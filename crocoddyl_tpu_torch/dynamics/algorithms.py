"""Rigid-body algorithms used to build and warm-start the walk (port of part
of crocoddyl_tpu/dynamics/algorithms.py).

The JAX module sweeps tree levels in stacked arrays; here the sweep is a
loop over joints in tree order (a parent always precedes its children),
which computes the same quantities.  Functions take a single (q, v).  The
closed-form node tangents are not here: on the main path they are computed
inside the node linearization (ops/fused_node.py).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import numpy as np
import torch

from . import lie
from .model import JointType, RobotModel
from .spatial import Inertia, Transform, cross_force, cross_motion


@lru_cache(maxsize=64)
def _tree_meta(parents: Tuple[int, ...], joint_types: Tuple[int, ...],
               frame_parents: Tuple[int, ...]):
    """(levels, v_off, nv, amask, dof_joint, perm, inv_perm, par_pos) —
    the same static tuple as the JAX package."""
    nj = len(parents)
    depth = [0] * nj
    for i in range(nj):
        depth[i] = 0 if parents[i] == -1 else depth[parents[i]] + 1
    maxd = max(depth)
    levels = tuple(tuple(i for i in range(nj) if depth[i] == d)
                   for d in range(maxd + 1))
    v_off, off = [], 0
    for t in joint_types:
        v_off.append(off)
        off += 6 if JointType(t) == JointType.FREE_FLYER else 1
    nv = off
    amask = np.zeros((nj, nv))
    for i in range(nj):
        j = i
        while j != -1:
            n = 6 if JointType(joint_types[j]) == JointType.FREE_FLYER else 1
            amask[i, v_off[j]:v_off[j] + n] = 1.0
            j = parents[j]
    dof_joint = np.zeros((nv,), dtype=np.int64)
    for j in range(nj):
        n = 6 if JointType(joint_types[j]) == JointType.FREE_FLYER else 1
        dof_joint[v_off[j]:v_off[j] + n] = j
    perm = [i for lvl in levels for i in lvl]
    inv_perm = np.argsort(np.asarray(perm))
    par_pos = []
    for d in range(1, len(levels)):
        prev = {j: k for k, j in enumerate(levels[d - 1])}
        par_pos.append(tuple(prev[parents[i]] for i in levels[d]))
    return (levels, tuple(v_off), nv, amask, dof_joint,
            tuple(perm), inv_perm, tuple(par_pos))


def _meta(model: RobotModel):
    return _tree_meta(model.parents, model.joint_types, model.frame_parents)


def _joint_setup(model: RobotModel, q, v):
    """Per-joint (parent←joint placement, local subspace S6, local vJ)."""
    dt, dev = q.dtype, q.device
    _, v_off, _, _, _, _, _, _ = _meta(model)
    types = [JointType(t) for t in model.joint_types]
    has_ff = types[0] == JointType.FREE_FLYER
    Xpl, S6, vJ = [], [], []
    for j, t in enumerate(types):
        jR, jp = model.jp_R[j], model.jp_p[j]
        if t == JointType.FREE_FLYER:
            Xpl.append(Transform(lie.mm(jR, lie.quat_to_rot(q[3:7])),
                                 jp + lie.mv(jR, q[:3])))
            S6.append(torch.zeros(6, dtype=dt, device=dev))
            vJ.append(v[:6])
            continue
        qj = q[v_off[j] + (1 if has_ff else 0)]
        ax = model.axis[j]
        z3 = torch.zeros(3, dtype=dt, device=dev)
        if t == JointType.REVOLUTE:
            Xpl.append(Transform(lie.mm(jR, lie.exp3(ax * qj)), jp))
            S6.append(torch.cat([z3, ax]))
        else:
            Xpl.append(Transform(jR, jp + lie.mv(jR, ax * qj)))
            S6.append(torch.cat([ax, z3]))
        vJ.append(S6[-1] * v[v_off[j]])
    return Xpl, S6, vJ


class KinData:
    """Second-order kinematics + world Jacobian columns at one (q, v)."""

    def __init__(self, model: RobotModel, q, v):
        self.model = model
        self.q, self.v = q, v
        dt = q.dtype
        _, v_off, nv, amask_np, dof_joint, _, _, _ = _meta(model)
        self.amask = torch.as_tensor(amask_np, dtype=dt, device=q.device)
        Xpl, S6, vJ = _joint_setup(model, q, v)
        oR, op, vel, bias = [], [], [], []
        for j, p in enumerate(model.parents):
            Xup = Xpl[j].inverse()
            if p == -1:
                oR.append(Xpl[j].R)
                op.append(Xpl[j].p)
                vel.append(vJ[j])
                bias.append(cross_motion(vJ[j], vJ[j]))
            else:
                oR.append(lie.mm(oR[p], Xpl[j].R))
                op.append(op[p] + lie.mv(oR[p], Xpl[j].p))
                v_l = Xup.act_motion(vel[p]) + vJ[j]
                vel.append(v_l)
                bias.append(Xup.act_motion(bias[p]) + cross_motion(v_l, vJ[j]))
        self.oMi = Transform(torch.stack(oR), torch.stack(op))
        self.vels = torch.stack(vel)                 # (nj, 6) joint-local
        self.biasacc = torch.stack(bias)             # (nj, 6)
        cols_j = self.oMi.act_motion(torch.stack(S6))
        if JointType(model.joint_types[0]) == JointType.FREE_FLYER:
            X0 = Transform(self.oMi.R[0], self.oMi.p[0])
            ff_cols = X0.act_motion(torch.eye(6, dtype=dt, device=q.device))
            cols = torch.cat([ff_cols,
                              cols_j[torch.as_tensor(dof_joint[6:])]])
        else:
            cols = cols_j[torch.as_tensor(dof_joint)]
        self.Jcols = cols                            # (nv, 6)
        self.I_w = Inertia(
            m=model.mass, c=self.oMi.act_point(model.com),
            I_c=lie.mm(lie.mm(self.oMi.R, model.inertia),
                       self.oMi.R.transpose(-1, -2)))

    def _fX(self, fid: int) -> Transform:
        return Transform(self.model.fp_R[fid], self.model.fp_p[fid])

    def frame_placement(self, fid: int) -> Transform:
        j = self.model.frame_parents[fid]
        return Transform(self.oMi.R[j], self.oMi.p[j]).compose(self._fX(fid))

    def frame_velocity(self, fid: int):
        j = self.model.frame_parents[fid]
        return self._fX(fid).act_motion_inv(self.vels[j])

    def frame_bias_acc(self, fid: int):
        j = self.model.frame_parents[fid]
        return self._fX(fid).act_motion_inv(self.biasacc[j])

    def frame_jacobian_local(self, fid: int):
        cols = self.Jcols * self.amask[self.model.frame_parents[fid]][:, None]
        return self.frame_placement(fid).inverse().act_motion(cols).T

    def com(self):
        m = self.model.mass
        return (m[:, None] * self.I_w.c).sum(0) / m.sum()


KinCache = KinData


def forward_kinematics(model: RobotModel, q, v=None):
    """(stacked oMi Transform, stacked joint-local velocities (nj, 6))."""
    if v is None:
        v = torch.zeros(model.nv, dtype=q.dtype, device=q.device)
    kd = KinData(model, q, v)
    return kd.oMi, kd.vels


def frame_placement(model: RobotModel, oMi: Transform, fid: int) -> Transform:
    j = model.frame_parents[fid]
    return Transform(oMi.R[j], oMi.p[j]).compose(
        Transform(model.fp_R[fid], model.fp_p[fid]))


def center_of_mass(model: RobotModel, q) -> torch.Tensor:
    return KinData(model, q, torch.zeros(model.nv, dtype=q.dtype,
                                         device=q.device)).com()


def rnea(model: RobotModel, q, v, a, fext: Optional[torch.Tensor] = None):
    """Inverse dynamics τ = M(q)a + b(q, v) − τ_ext (recursive Newton-Euler);
    fext: optional (njoints, 6) forces in each joint-local frame."""
    dt, dev = q.dtype, q.device
    _, v_off, nv, _, _, _, _, _ = _meta(model)
    types = [JointType(t) for t in model.joint_types]
    Xpl, S6, vJ = _joint_setup(model, q, v)
    g6 = torch.cat([-model.gravity.to(dt), torch.zeros(3, dtype=dt,
                                                       device=dev)])
    I = Inertia(m=model.mass, c=model.com, I_c=model.inertia)
    vel, acc, f = [], [], []
    for j, p in enumerate(model.parents):
        Xup = Xpl[j].inverse()
        Sa = a[:6] if types[j] == JointType.FREE_FLYER else S6[j] * a[v_off[j]]
        if p == -1:
            vel.append(vJ[j])
            acc.append(Xup.act_motion(g6) + Sa + cross_motion(vJ[j], vJ[j]))
        else:
            v_l = Xup.act_motion(vel[p]) + vJ[j]
            vel.append(v_l)
            acc.append(Xup.act_motion(acc[p]) + Sa + cross_motion(v_l, vJ[j]))
    for j in range(model.njoints):
        Ij = Inertia(I.m[j], I.c[j], I.I_c[j])
        fj = Ij.mul_motion(acc[j]) + cross_force(vel[j], Ij.mul_motion(vel[j]))
        f.append(fj - fext[j] if fext is not None else fj)
    tau = [None] * nv
    for j in reversed(range(model.njoints)):
        if types[j] == JointType.FREE_FLYER:
            for k in range(6):
                tau[v_off[j] + k] = f[j][k]
        else:
            tau[v_off[j]] = (S6[j] * f[j]).sum()
        p = model.parents[j]
        if p != -1:
            f[p] = f[p] + Xpl[j].act_force(f[j])
    return torch.stack(tau)
