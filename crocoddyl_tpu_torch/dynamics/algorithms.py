"""Rigid-body algorithms (port of crocoddyl_tpu/dynamics/algorithms.py).

The JAX module sweeps tree levels in stacked arrays.  Here the joint
placements are composed in a loop over the joints in tree order (a parent
always precedes its children), and the velocities and bias accelerations
are contractions over the world Jacobian columns, the identities behind
the JAX module's closed-form tangents: the same quantities in fewer
operations.  Functions take a single (q, v); batch with
``torch.func.vmap``.  Joint-space dynamics come in Jacobian form
(M = Σ JᵢᵀIᵢJᵢ, b = Σ Jᵢᵀfᵢ), and the node derivatives of the generic
``RigidBodyNode`` in closed form: ``gforce_derivatives`` for the dynamics,
``frame_tangents`` for contacts and frame costs, ``kin_tangent_basis`` for
a cost without a closed form.  For a node the node kernel admits, the same
tangents are computed in lane layout in ops/fused_node.py.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import lie
from .model import JointType, RobotModel
from .lie import cross, skew
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


_CONSTS = {}


def _const(model: RobotModel, name: str, dtype, device, make):
    """A static table of ``model``'s tree as a tensor on (dtype, device),
    built once: a table made anew each call would be a host-to-device
    copy, and a stream sync, on every node evaluation on the card."""
    key = (model.parents, model.joint_types, model.frame_parents, name,
           dtype, str(device))
    t = _CONSTS.get(key)
    if t is None:
        t = _CONSTS[key] = torch.as_tensor(make(), dtype=dtype,
                                           device=device)
    return t


def _joint_setup(model: RobotModel, q, v):
    """Stacked per-joint (parent←joint placement Transform (nj,), local
    subspace S6 (nj, 6), local joint velocity vJ (nj, 6)), the 1-dof
    joints batched (algorithms.py:93-163).  At most one free flyer, joint
    0; every other joint has one dof, so their q and v are contiguous."""
    dt, dev = q.dtype, q.device
    types = [JointType(t) for t in model.joint_types]
    has_ff = types[0] == JointType.FREE_FLYER
    s = 1 if has_ff else 0
    R, p, S6, vJ = [], [], [], []
    if has_ff:
        jR = model.jp_R[0]
        R.append((jR @ lie.quat_to_rot(q[3:7]))[None])
        p.append((model.jp_p[0] + lie.mv(jR, q[:3]))[None])
        S6.append(torch.zeros((1, 6), dtype=dt, device=dev))
        vJ.append(v[None, :6])
    if len(types) > s:
        qj, vj = q[7 if has_ff else 0:], v[6 if has_ff else 0:]
        axis, jR, jp = model.axis[s:], model.jp_R[s:], model.jp_p[s:]
        aq = axis * qj[:, None]
        z = torch.zeros_like(axis)
        rev = [t == JointType.REVOLUTE for t in types[s:]]
        if all(rev):
            R.append(jR @ lie.exp3(aq))
            p.append(jp)
            S6.append(torch.cat([z, axis], -1))
        else:
            is_rev = _const(model, "revolute", torch.bool, dev,
                            lambda: rev)
            R_J = torch.where(is_rev[:, None, None], lie.exp3(aq),
                              torch.eye(3, dtype=dt, device=dev))
            R.append(jR @ R_J)
            p.append(jp + lie.mv(jR, torch.where(is_rev[:, None], z, aq)))
            S6.append(torch.where(is_rev[:, None], torch.cat([z, axis], -1),
                                  torch.cat([axis, z], -1)))
        vJ.append(S6[-1] * vj[:, None])
    if len(R) == 1:
        return Transform(R[0], p[0]), S6[0], vJ[0]
    return (Transform(torch.cat(R), torch.cat(p)), torch.cat(S6),
            torch.cat(vJ))


class KinArrays(NamedTuple):
    """The array outputs of one KinData sweep: the linearization seam of
    the node derivatives' fallback for a cost without a closed form
    (algorithms.py:165-182)."""

    oR: torch.Tensor       # (nj, 3, 3) world joint rotations
    op: torch.Tensor       # (nj, 3) world joint origins
    vels: torch.Tensor     # (nj, 6) joint-local spatial velocities
    biasacc: torch.Tensor  # (nj, 6) joint-local bias accelerations
    Jcols: torch.Tensor    # (nv, 6) world Jacobian columns
    vel_w: torch.Tensor    # (nj, 6) world spatial velocities
    Iw_c: torch.Tensor     # (nj, 3) world com positions
    Iw_Ic: torch.Tensor    # (nj, 3, 3) world rotational inertias


class KinData:
    """Second-order kinematics + world Jacobian columns at one (q, v)."""

    @classmethod
    def from_arrays(cls, model: RobotModel, q, v, arrays: KinArrays):
        """A KinData view of precomputed sweep outputs (no sweep)."""
        self = cls.__new__(cls)
        self.model = model
        self.q, self.v = q, v
        self.amask = _const(model, "amask", q.dtype, q.device,
                            lambda: _meta(model)[3])
        self.oMi = Transform(arrays.oR, arrays.op)
        self.vels = arrays.vels
        self.biasacc = arrays.biasacc
        self.Jcols = arrays.Jcols
        self.vel_w = arrays.vel_w
        self.I_w = Inertia(m=model.mass, c=arrays.Iw_c, I_c=arrays.Iw_Ic)
        return self

    def arrays(self) -> KinArrays:
        return KinArrays(oR=self.oMi.R, op=self.oMi.p, vels=self.vels,
                         biasacc=self.biasacc, Jcols=self.Jcols,
                         vel_w=self.vel_w, Iw_c=self.I_w.c,
                         Iw_Ic=self.I_w.I_c)

    def __init__(self, model: RobotModel, q, v):
        self.model = model
        self.q, self.v = q, v
        dt, dev = q.dtype, q.device
        _, _, nv, amask_np, dof_joint, _, _, _ = _meta(model)
        self.amask = _const(model, "amask", dt, dev, lambda: amask_np)
        Xpl, S6, _ = _joint_setup(model, q, v)
        # the placements walk the tree; everything else is one contraction
        # over the world Jacobian columns (world velocities v_i = Σ_{e⪯i}
        # S_e q̇_e, world bias accelerations b_i = Σ_{k⪯i} v_k × (v_k −
        # v_parent(k)))
        oR, op = [], []
        for j, par in enumerate(model.parents):
            if par == -1:
                oR.append(Xpl.R[j])
                op.append(Xpl.p[j])
            else:
                oR.append(oR[par] @ Xpl.R[j])
                op.append(op[par] + lie.mv(oR[par], Xpl.p[j]))
        self.oMi = Transform(torch.stack(oR), torch.stack(op))
        cols_j = self.oMi.act_motion(S6)             # (nj, 6)
        ff = JointType(model.joint_types[0]) == JointType.FREE_FLYER
        nd = 6 if ff else 0
        if not np.array_equal(dof_joint[nd:], np.arange(nv - nd) + int(ff)):
            raise ValueError("every joint but a root free flyer has one dof")
        if ff:
            X0 = Transform(self.oMi.R[0], self.oMi.p[0])
            cols = torch.cat([X0.act_motion(torch.eye(6, dtype=dt,
                                                      device=dev)),
                              cols_j[1:]])
        else:
            cols = cols_j
        self.Jcols = cols                            # (nv, 6)
        self.vel_w = self.amask @ (cols * v[:, None])  # (nj, 6) world
        self.vels = self.oMi.act_motion_inv(self.vel_w)  # joint-local
        _, Jm, par_idx, not_root, _ = _dof_tables(self)
        vJ_w = self.vel_w - self.vel_w[par_idx] * not_root[:, None]
        self.biasacc = self.oMi.act_motion_inv(     # joint-local, q̈ = 0
            Jm @ cross_motion(self.vel_w, vJ_w))
        self.I_w = Inertia(
            m=model.mass, c=self.oMi.act_point(model.com),
            I_c=self.oMi.R @ model.inertia @ self.oMi.R.transpose(-1, -2))

    # -- joint-space dynamics quantities (algorithms.py:287-340) -----------
    def joint_jacobians_world(self):
        """(nj, 6, nv): world body Jacobian of every joint."""
        return self.Jcols.T[None, :, :] * self.amask[:, None, :]

    def mass_matrix(self, armature=None):
        """M = Σ_i J_iᵀ I_i J_i (the kinetic-energy identity), plus the
        armature on the diagonal."""
        Jw = self.joint_jacobians_world()             # (nj, 6, nv)
        nv = Jw.shape[-1]
        M = Jw.reshape(-1, nv).T @ (self.I_w.to_matrix() @ Jw).reshape(-1, nv)
        if armature is not None:
            M = M + torch.diag_embed(armature)
        return M

    def mass_matrix_vec(self, a):
        """M(q)·a without building M: Σ_i J_iᵀ I_i (J_i a)."""
        Ja = self.amask @ (self.Jcols * a[:, None])          # (nj, 6)
        f = self.I_w.mul_motion(Ja)                          # (nj, 6)
        return ((self.amask.T @ f) * self.Jcols).sum(-1)     # (nv,)

    def bias_forces(self, fext_local=None):
        """b(q, v) = Σ_i J_iᵀ (I_i(a_bias_i − g) + v_i ×* I_i v_i), less
        the joint-local external wrenches ``fext_local`` (nj, 6)."""
        dt, dev = self.q.dtype, self.q.device
        g6 = torch.cat([-self.model.gravity.to(dt),
                        torch.zeros(3, dtype=dt, device=dev)])
        a_w = self.oMi.act_motion(self.biasacc) + g6
        f_w = (self.I_w.mul_motion(a_w)
               + cross_force(self.vel_w, self.I_w.mul_motion(self.vel_w)))
        if fext_local is not None:
            f_w = f_w - self.oMi.act_force(fext_local)
        return ((self.amask.T @ f_w) * self.Jcols).sum(-1)

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

    def frame_jacobian_world(self, fid: int):
        """(6, nv) world-frame Jacobian."""
        j = self.model.frame_parents[fid]
        return (self.Jcols * self.amask[j][:, None]).T

    def frame_jacobian_local(self, fid: int):
        cols = self.Jcols * self.amask[self.model.frame_parents[fid]][:, None]
        return self.frame_placement(fid).inverse().act_motion(cols).T

    def com(self):
        m = self.model.mass
        return (m[:, None] * self.I_w.c).sum(0) / m.sum()

    def com_velocity(self, vdof):
        """Jcom·vdof: the com's velocity under joint velocity ``vdof``."""
        u_b = self.amask @ (self.Jcols * vdof[:, None])        # (nj, 6)
        cdot = u_b[:, :3] + cross(u_b[:, 3:], self.I_w.c)
        m = self.model.mass
        return (m[:, None] * cdot).sum(0) / m.sum()

    def centroidal_momentum(self):
        """h = A(q)·v about the com, world-aligned, [lin; ang]."""
        m = self.model
        h = self.oMi.act_force(Inertia(m=m.mass, c=m.com, I_c=m.inertia)
                               .mul_motion(self.vels)).sum(0)
        lin, ang = h[:3], h[3:]
        return torch.cat([lin, ang - cross(self.com(), lin)])


KinCache = KinData


def _dof_tables(kin: KinData):
    """Static ancestry tables of the closed-form tangents, as tensors:
    (Am2 [d⪯e] (nv, nv), Jm [k⪯i] (nj, nj), parent index (nj,), not-root
    (nj,), dof→joint (nv,))."""
    model = kin.model
    _, v_off, _, amask_np, dof_joint, _, _, _ = _meta(model)
    dt, dev = kin.q.dtype, kin.q.device
    parents = np.asarray(model.parents)
    dofj = np.asarray(dof_joint)

    def t(name, make, dtype=dt):
        return _const(model, name, dtype, dev, make)
    return (t("Am2", lambda: amask_np[dofj].T),
            t("Jm", lambda: amask_np[:, np.asarray(v_off)]),
            t("par_idx", lambda: np.where(parents == -1, 0, parents),
              torch.long),
            t("not_root", lambda: (parents != -1).astype(np.float64)),
            t("dof_joint", lambda: dofj, torch.long))


def kin_tangent_basis(kin: KinData) -> KinArrays:
    """Directional derivatives of every KinArrays field along all ndx
    tangent directions [dq (nv); dv (nv)], leading axis (ndx,), in closed
    form (algorithms.py:395-510): a world quantity on body i moves along
    dof d ⪯ i as the action of the world Jacobian column S_d."""
    model = kin.model
    nj, nv = model.njoints, kin.Jcols.shape[0]
    dt, dev = kin.q.dtype, kin.q.device
    Am2, Jm, par_idx, not_root, dj = _dof_tables(kin)
    Mq = kin.amask.T                                    # (nv_dir, nj)

    S = kin.Jcols                                       # (nv, 6)
    oR, op = kin.oMi.R, kin.oMi.p
    vw = kin.vel_w
    vp_w = vw[par_idx] * not_root[:, None]
    vJ_w = vw - vp_w
    wv = vp_w[dj]                                       # (nv, 6)
    bias_w = kin.oMi.act_motion(kin.biasacc)
    X = Transform(oR, op)
    Sv, Sw = S[:, :3], S[:, 3:]
    skew_Sw = skew(Sw)

    doR = Mq[..., None, None] * (skew_Sw[:, None] @ oR[None])
    dop = Mq[..., None] * (Sv[:, None] + cross(Sw[:, None], op[None]))
    cm_S_vw = cross_motion(S[:, None], vw[None])        # (nv, nj, 6)
    cm_S_wv = cross_motion(S, wv)                       # (nv, 6)
    dvel_w_q = Mq[..., None] * (cm_S_vw - cm_S_wv[:, None])
    dvels_q = -Mq[..., None] * X.act_motion_inv(
        cm_S_wv[:, None].expand(nv, nj, 6))
    dbeta_q = (cross_motion(dvel_w_q, vJ_w[None])
               + Mq[..., None] * cross_motion(
                   vw[None], cross_motion(S[:, None], vJ_w[None])))
    dbias_w_q = torch.einsum("ik,dkx->dix", Jm, dbeta_q)
    dbias_q = X.act_motion_inv(
        dbias_w_q - Mq[..., None] * cross_motion(S[:, None], bias_w[None]))
    dJcols_q = Am2[..., None] * cross_motion(S[:, None], S[None])
    c_w, Ic_w = kin.I_w.c, kin.I_w.I_c
    dc_q = Mq[..., None] * (Sv[:, None] + cross(Sw[:, None], c_w[None]))
    dIc_q = Mq[..., None, None] * (skew_Sw[:, None] @ Ic_w[None]
                                   - Ic_w[None] @ skew_Sw[:, None])

    dvel_w_v = Mq[..., None] * S[:, None].expand(nv, nj, 6)
    dvels_v = Mq[..., None] * X.act_motion_inv(S[:, None].expand(nv, nj, 6))
    onehot = _const(model, "onehot", dt, dev,
                    lambda: np.eye(nj)[np.asarray(_meta(model)[4])])
    dbeta_v = (Mq[..., None] * cross_motion(S[:, None], vJ_w[None])
               + onehot[..., None] * cross_motion(vw[None], S[:, None]))
    dbias_v = X.act_motion_inv(torch.einsum("ik,dkx->dix", Jm, dbeta_v))

    def z(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)
    return KinArrays(
        oR=torch.cat([doR, z(nv, nj, 3, 3)]),
        op=torch.cat([dop, z(nv, nj, 3)]),
        vels=torch.cat([dvels_q, dvels_v]),
        biasacc=torch.cat([dbias_q, dbias_v]),
        Jcols=torch.cat([dJcols_q, z(nv, nv, 6)]),
        vel_w=torch.cat([dvel_w_q, dvel_w_v]),
        Iw_c=torch.cat([dc_q, z(nv, nj, 3)]),
        Iw_Ic=torch.cat([dIc_q, z(nv, nj, 3, 3)]))


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


def frame_velocity(model: RobotModel, vels, fid: int) -> torch.Tensor:
    """Frame spatial velocity in the LOCAL frame."""
    j = model.frame_parents[fid]
    return Transform(model.fp_R[fid], model.fp_p[fid]).act_motion_inv(vels[j])


def _at_rest(model, q):
    return KinData(model, q, torch.zeros(model.nv, dtype=q.dtype,
                                         device=q.device))


def frame_jacobian(model: RobotModel, q, fid: int,
                   reference_frame: str = "local") -> torch.Tensor:
    """(6, nv) frame Jacobian; 'local', 'world', or 'local_world_aligned'."""
    kd = _at_rest(model, q)
    if reference_frame == "world":
        return kd.frame_jacobian_world(fid)
    Jl = kd.frame_jacobian_local(fid)
    if reference_frame == "local":
        return Jl
    R = kd.frame_placement(fid).R
    return Transform(R, torch.zeros(3, dtype=q.dtype, device=q.device)
                     ).act_motion(Jl.T).T


def crba(model: RobotModel, q) -> torch.Tensor:
    """Joint-space inertia matrix M(q) (Jacobian form)."""
    return _at_rest(model, q).mass_matrix()


def nonlinear_effects(model: RobotModel, q, v):
    """b(q, v): Coriolis, centrifugal and gravity terms."""
    return KinData(model, q, v).bias_forces()


def gravity_torque(model: RobotModel, q):
    return _at_rest(model, q).bias_forces()


def aba(model: RobotModel, q, v, tau, fext: Optional[torch.Tensor] = None,
        armature: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Forward dynamics a = M⁻¹(τ − b) by a Cholesky solve; ``armature``
    adds rotor inertia to the diagonal of M."""
    kd = KinData(model, q, v)
    L = torch.linalg.cholesky(kd.mass_matrix(armature))
    return torch.cholesky_solve((tau - kd.bias_forces(fext))[:, None],
                                L)[:, 0]


def center_of_mass(model: RobotModel, q) -> torch.Tensor:
    return _at_rest(model, q).com()


def centroidal_momentum(model: RobotModel, q, v):
    """h = A(q)·v: spatial momentum [lin; ang] about the com,
    world-aligned."""
    return KinData(model, q, v).centroidal_momentum()


def total_mass(model: RobotModel) -> torch.Tensor:
    return model.mass.sum()


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
    Xs = [Transform(Xpl.R[j], Xpl.p[j]) for j in range(model.njoints)]
    vel, acc, f = [], [], []
    for j, p in enumerate(model.parents):
        Xup = Xs[j].inverse()
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
            f[p] = f[p] + Xs[j].act_force(f[j])
    return torch.stack(tau)


# ---------------------------------------------------------------------------
# Closed-form generalized-force and frame derivatives (algorithms.py:653-888)
# ---------------------------------------------------------------------------

def _blocks(a, b, c, d):
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def _CM(m):
    """Matrix of s ↦ cross_motion(s, m) (m fixed), (..., 6, 6)."""
    sl, sa = skew(m[..., :3]), skew(m[..., 3:])
    return _blocks(-sa, -sl, torch.zeros_like(sl), -sa)


def _CF(h):
    """Matrix of s ↦ cross_force(s, h) (h fixed), (..., 6, 6)."""
    sl, sn = skew(h[..., :3]), skew(h[..., 3:])
    return _blocks(torch.zeros_like(sl), -sl, -sl, -sn)


def _AD(v):
    """Matrix of z ↦ cross_motion(v, z) (v fixed), (..., 6, 6)."""
    swl, sww = skew(v[..., :3]), skew(v[..., 3:])
    return _blocks(sww, swl, torch.zeros_like(swl), sww)


def _ADs(v):
    """Matrix of z ↦ cross_force(v, z) (v fixed), (..., 6, 6)."""
    swl, sww = skew(v[..., :3]), skew(v[..., 3:])
    return _blocks(sww, torch.zeros_like(swl), swl, sww)


def _bias_ctx(kin: KinData, a):
    """The per-dof quantities gforce_derivatives and frame_tangents share:
    (S, vw, wv, vjd, bias_w, uw, PS, PS_pd, cw, cu, CMv)."""
    _, Jm, par_idx, not_root, dj = _dof_tables(kin)
    S = kin.Jcols                                        # (nv, 6)
    vw = kin.vel_w                                       # (nj, 6)
    vp_w = vw[par_idx] * not_root[:, None]               # parent velocity
    vJ_w = vw - vp_w
    wv = vp_w[dj]                                        # (nv, 6) w_d
    vjd = vw[dj]                                         # (nv, 6) v_joint(d)
    bias_w = kin.oMi.act_motion(kin.biasacc)             # (nj, 6)
    u = kin.amask @ (S * a[:, None])                     # (nj, 6) (J a)_i
    uw = (u[par_idx] * not_root[:, None])[dj]            # (nv, 6) u_p(d)
    CMv, CMvJ = _CM(vw), _CM(vJ_w)
    K = CMvJ @ CMv + _AD(vw) @ CMvJ                      # (nj, 6, 6)
    PS = (Jm @ K.flatten(1)).unflatten(1, (6, 6))        # ancestry sums
    PS_pd = (PS[par_idx] * not_root[:, None, None])[dj]  # (nv, 6, 6)
    return dict(S=S, vw=vw, wv=wv, vjd=vjd, bias_w=bias_w, u=u, PS=PS,
                PS_pd=PS_pd, cw=cross_motion(S, wv),
                cu=cross_motion(S, uw), CMv=CMv)


def gforce_derivatives(kin: KinData, a, ext_w=None):
    """Closed-form (dG_dq, dG_dv), each (nv, nv), of the generalized force
    G(q, v) = M(q)·a + b(q, v) − Σ_c J_cᵀ(q)·ext_c at fixed joint
    acceleration ``a`` and fixed world-frame wrenches ``ext_w`` (nj, 6)
    attached per body (algorithms.py:693-800: the reference's
    computeRNEADerivatives role, every term a per-body 6×6 kernel
    contracted through the masked world Jacobian)."""
    model = kin.model
    nv = kin.Jcols.shape[0]
    dt, dev = kin.q.dtype, kin.q.device
    Am2 = _dof_tables(kin)[0]
    c = _bias_ctx(kin, a)
    S, vw, wv, PS, PS_pd = c["S"], c["vw"], c["wv"], c["PS"], c["PS_pd"]
    cw, cu, CMv = c["cw"], c["cu"], c["CMv"]
    amask = kin.amask
    g6 = torch.cat([-model.gravity.to(dt), torch.zeros(3, dtype=dt,
                                                        device=dev)])
    Iw = kin.I_w.to_matrix()                             # (nj, 6, 6)
    biasg = c["bias_w"] + g6
    h = kin.I_w.mul_motion(biasg + c["u"])               # I·a_w
    h2 = kin.I_w.mul_motion(vw)                          # I·v
    f = h + cross_force(vw, h2)
    if ext_w is not None:
        f = f - ext_w

    CFh2, ADsv = _CF(h2), _ADs(vw)
    G_q = (_CF(h) - Iw @ _CM(biasg) + Iw @ PS + CFh2 @ CMv + ADsv @ CFh2)
    if ext_w is not None:
        G_q = G_q - _CF(ext_w)
    Gv = CFh2 + ADsv @ Iw + Iw @ CMv                     # (nj, 6, 6)
    z2 = cross_motion(cw, wv)
    zeta_q = -cu - (PS_pd @ S[:, :, None])[..., 0] + z2
    zeta_v = -cw + cross_motion(c["vjd"], S)

    def pair_multi(kerns, rights):
        """Σ_k Σ_i [e⪯i][d⪯i] S_eᵀ kerns[k]_i rights[k]_d → (nv, nv), one
        (nv, k·nj·6) @ (k·nj·6, nv) product."""
        Kk = torch.stack(kerns)                          # (k, nj, 6, 6)
        Rk = torch.stack(rights)                         # (k, nv, 6)
        t = S @ Kk                                       # (k, nj, nv, 6)
        A = (t * amask[None, :, :, None]).permute(2, 0, 1, 3).reshape(nv, -1)
        Bm = (amask[None, :, None, :]
              * Rk.transpose(1, 2)[:, None]).reshape(-1, nv)
        return A @ Bm

    F = amask.T @ f                                      # (nv, 6) subtree
    T1 = (cross_force(S, F) @ S.T) * Am2.T
    dG_dq = T1 + pair_multi([G_q, Iw, -Gv], [S, zeta_q, cw])
    dG_dv = pair_multi([Gv, Iw], [S, zeta_v])
    return dG_dq, dG_dv


class FrameTangents(NamedTuple):
    """Closed-form x-tangents of the frame-local quantities at one frame,
    leading axis ndx = [dq (nv); dv (nv)] (algorithms.py:805-816)."""

    dxi: torch.Tensor   # (ndx, 6) local twist of the frame placement
    dp: torch.Tensor    # (ndx, 3) world frame-origin translation
    dv: torch.Tensor    # (ndx, 6) frame-local spatial velocity
    dab: torch.Tensor   # (ndx, 6) frame-local bias acceleration
    dJa: torch.Tensor   # (ndx, 6) J_frame_local·a at fixed a


def frame_tangents(kin: KinData, a, fid: int) -> FrameTangents:
    """Closed-form tangents of the frame quantities contacts and costs read
    (algorithms.py:818-888)."""
    nv = kin.Jcols.shape[0]
    dt, dev = kin.q.dtype, kin.q.device
    j = kin.model.frame_parents[fid]
    c = _bias_ctx(kin, a)
    S, wv, cw, PS = c["S"], c["wv"], c["cw"], c["PS"]
    mask = kin.amask[j][:, None]                         # (nv, 1)
    Y = kin.frame_placement(fid)
    Yinv = Y.inverse()
    zq = torch.zeros((nv, 3), dtype=dt, device=dev)
    z6 = torch.zeros((nv, 6), dtype=dt, device=dev)

    dxi_q = mask * Yinv.act_motion(S)
    dp_q = mask * (S[:, :3] + cross(S[:, 3:], Y.p[None]))
    dv_q = -mask * Yinv.act_motion(cw)
    dv_v = mask * Yinv.act_motion(S)
    dJa_q = -mask * Yinv.act_motion(c["cu"])
    wdiff = c["vw"][j][None] - wv                        # v_j − w_d
    dbias_w_q = (S @ PS[j].T - (c["PS_pd"] @ S[:, :, None])[..., 0]
                 - cross_motion(cw, wdiff))
    dab_q = mask * Yinv.act_motion(
        dbias_w_q - cross_motion(S, c["bias_w"][j][None]))
    dab_v = mask * Yinv.act_motion(cross_motion(S, wdiff)
                                   + cross_motion(c["vjd"], S))
    return FrameTangents(
        dxi=torch.cat([dxi_q, z6]), dp=torch.cat([dp_q, zq]),
        dv=torch.cat([dv_q, dv_v]), dab=torch.cat([dab_q, dab_v]),
        dJa=torch.cat([dJa_q, z6]))
