"""Residual-based costs (port of crocoddyl_tpu/models/multibody/costs.py:
the seven costs of the node kernel, FramePlacement, FrameRotation, the CoP
support cost and the centroidal momentum).

Each cost holds its references, an activation, a weight and a 0/1 active
flag.  ``residual(st, cache, x, u)`` reads the node's kinematic sweep and
contact forces (``nodes.NodeCache``); ``residual_jac_x`` is the closed-form
kinematic part of its x-Jacobian (nr, ndx), or None for a cost without one
(the node then linearizes the sweep); the node adds the force chain
(∂r/∂λ)·dλ and assembles the Gauss-Newton terms.  For a node the node
kernel admits, ops/fused_node.py computes all of it in lane layout.
"""

from __future__ import annotations

import torch

from ...dynamics import lie
from ...dynamics.lie import cross
from ...dynamics.spatial import Inertia, Transform, cross_motion
from ...utils.struct import PyTreeNode, field
from .activations import Activation
from .frames import CoPSupport, FrictionCone


class Cost(PyTreeNode):
    activation: Activation
    weight: torch.Tensor
    active: torch.Tensor  # 0/1

    @property
    def nr(self):
        """Residual size; None for a state cost, whose size is the state's
        ndx (``cost_nr`` resolves it)."""
        return None if isinstance(self, CostState) else cost_nr(self, None)

    def residual(self, st, cache, x, u):
        raise NotImplementedError

    def residual_jac_x(self, st, cache, x, u, ft_of):
        """Closed-form x-Jacobian of the residual (nr, ndx), or None for
        the generic sweep linearization; ``ft_of(fid)`` gives the frame's
        ``algorithms.FrameTangents``."""
        return None


class CostState(Cost):
    """r = x ⊖ xref."""
    xref: torch.Tensor = None

    def residual(self, st, cache, x, u):
        return st.diff(self.xref, x)

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return st.jdiff(self.xref, x)[1]


class CostControl(Cost):
    """r = u − uref."""
    uref: torch.Tensor = None

    def residual(self, st, cache, x, u):
        return u - self.uref

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return x.new_zeros((self.uref.shape[-1], st.ndx))


class CostCoM(Cost):
    """r = com(q) − cref."""
    cref: torch.Tensor = None

    def residual(self, st, cache, x, u):
        return cache.kin.com() - self.cref

    def residual_jac_x(self, st, cache, x, u, ft_of):
        # dcom/dq_d = (m_sub·Sv + Sw × c_sub)/M with the subtree mass and
        # first moment of each dof (costs.py:81-95)
        kin = cache.kin
        m, S = kin.model.mass, kin.Jcols
        msub = kin.amask.T @ m
        csub = kin.amask.T @ (m[:, None] * kin.I_w.c)
        dcom_q = (msub[:, None] * S[:, :3] + cross(S[:, 3:], csub)) / m.sum()
        return torch.cat([dcom_q.T, x.new_zeros((3, st.ndx - S.shape[0]))],
                         dim=1)


class CostFramePlacement(Cost):
    """r = log6(Mref⁻¹ · oMf)."""
    fid: int = field(static=True, default=0)
    ref_R: torch.Tensor = None
    ref_p: torch.Tensor = None

    def _log(self, cache):
        oMf = cache.frame_placement(self.fid)
        rel = Transform(self.ref_R, self.ref_p).inverse().compose(oMf)
        return lie.log6(rel.R, rel.p)

    def residual(self, st, cache, x, u):
        return self._log(cache)

    def residual_jac_x(self, st, cache, x, u, ft_of):
        Jri = lie.jac_se3_right_inv(self._log(cache))
        return Jri @ ft_of(self.fid).dxi.T


class CostFrameTranslation(Cost):
    """r = p_frame − pref."""
    fid: int = field(static=True, default=0)
    pref: torch.Tensor = None

    def residual(self, st, cache, x, u):
        return cache.frame_placement(self.fid).p - self.pref

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return ft_of(self.fid).dp.T


class CostFrameRotation(Cost):
    """r = log3(Rrefᵀ · R_frame)."""
    fid: int = field(static=True, default=0)
    ref_R: torch.Tensor = None

    def _log(self, cache):
        R = cache.frame_placement(self.fid).R
        return lie.log3(lie.mm(self.ref_R.transpose(-1, -2), R))

    def residual(self, st, cache, x, u):
        return self._log(cache)

    def residual_jac_x(self, st, cache, x, u, ft_of):
        Jri = lie.jac_so3_right_inv(self._log(cache))
        return Jri @ ft_of(self.fid).dxi[:, 3:].T


class CostFrameVelocity(Cost):
    """r = v_frame (local) − vref."""
    fid: int = field(static=True, default=0)
    vref: torch.Tensor = None

    def residual(self, st, cache, x, u):
        return cache.frame_velocity(self.fid) - self.vref

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return ft_of(self.fid).dv.T


class CostContactForce(Cost):
    """r = λ_contact − fref (the kinematic part of its Jacobian is zero;
    the node adds the force chain)."""
    contact_idx: int = field(static=True, default=0)
    fref: torch.Tensor = None

    def residual(self, st, cache, x, u):
        f = cache.contact_force(self.contact_idx)
        return f[:self.fref.shape[-1]] - self.fref

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return x.new_zeros((self.fref.shape[-1], st.ndx))


class CostContactFrictionCone(Cost):
    """r = A_cone · f_lin (barrier activation)."""
    contact_idx: int = field(static=True, default=0)
    cone: FrictionCone = None

    def residual(self, st, cache, x, u):
        return lie.mv(self.cone.A, cache.contact_force(self.contact_idx)[:3])

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return x.new_zeros((self.cone.A.shape[-2], st.ndx))


class CostContactCoP(Cost):
    """r = A_cop · f6 with a [0, ∞) barrier: the centre of pressure of a
    contact wrench inside its sole's support rectangle (costs.py:210-224).
    The kinematic part of its Jacobian is zero; the node adds the force
    chain."""
    contact_idx: int = field(static=True, default=0)
    support: CoPSupport = None

    def residual(self, st, cache, x, u):
        f = cache.contact_force(self.contact_idx)
        if f.shape[-1] != 6:
            f = torch.cat([f, f.new_zeros((3,))])
        return lie.mv(self.support.A, f)

    def residual_jac_x(self, st, cache, x, u, ft_of):
        return x.new_zeros((4, st.ndx))


class CostCentroidalMomentum(Cost):
    """r = A(q)·v − href (costs.py:227-289)."""
    href: torch.Tensor = None

    def residual(self, st, cache, x, u):
        return cache.kin.centroidal_momentum() - self.href

    def residual_jac_x(self, st, cache, x, u, ft_of):
        # dh_w/dq_d = Σ_i[d⪯i](CF(I_i v_i)S_d − I_i cw_d) and dh_w/dv_d =
        # (Σ_i[d⪯i] I_i)S_d, then the centroidal correction ang −= com × lin
        # chained through dcom/dq (costs.py:238-289)
        from ...dynamics import algorithms as algo
        kin = cache.kin
        model = kin.model
        S, amask, vw = kin.Jcols, kin.amask, kin.vel_w
        _, _, par_idx, not_root, dj = algo._dof_tables(kin)
        cw = cross_motion(S, (vw[par_idx] * not_root[:, None])[dj])
        A1 = torch.einsum("id,iab->dab", amask,
                          algo._CF(kin.I_w.mul_motion(vw)))   # (nv, 6, 6)
        AI = torch.einsum("id,iab->dab", amask, kin.I_w.to_matrix())
        dh_q = ((A1 @ S[:, :, None]) - (AI @ cw[:, :, None]))[..., 0]
        dh_v = (AI @ S[:, :, None])[..., 0]
        lin = kin.oMi.act_force(
            Inertia(m=model.mass, c=model.com, I_c=model.inertia)
            .mul_motion(kin.vels)).sum(0)[:3]
        com = kin.com()
        m = model.mass
        msub = amask.T @ m
        csub = amask.T @ (m[:, None] * kin.I_w.c)
        dcom_q = (msub[:, None] * S[:, :3] + cross(S[:, 3:], csub)) / m.sum()

        def correct(dh, dcom):
            dlin = dh[:, :3]
            dang = dh[:, 3:] - cross(com[None], dlin)
            if dcom is not None:
                dang = dang - cross(dcom, lin[None])
            return torch.cat([dlin, dang], dim=1)

        return torch.cat([correct(dh_q, dcom_q), correct(dh_v, None)]).T


def cost_nr(cost: Cost, st) -> int:
    """Static residual size of a cost item on the state ``st``
    (costs.py:311-329)."""
    if isinstance(cost, CostState):
        return st.ndx
    if isinstance(cost, CostControl):
        return cost.uref.shape[-1]
    if isinstance(cost, (CostCoM, CostFrameTranslation, CostFrameRotation)):
        return 3
    if isinstance(cost, (CostFramePlacement, CostFrameVelocity,
                         CostCentroidalMomentum)):
        return 6
    if isinstance(cost, CostContactForce):
        return cost.fref.shape[-1]
    if isinstance(cost, CostContactFrictionCone):
        return cost.cone.A.shape[-2]
    if isinstance(cost, CostContactCoP):
        return 4
    raise NotImplementedError(type(cost))
