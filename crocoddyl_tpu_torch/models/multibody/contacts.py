"""Point and placement contacts with fixed-shape activity masks, the
contact KKT solve and the impulse KKT solve (port of ``Contact3D``,
``Contact6D``, ``ContactSet``, ``_contact_kkt_raw``, ``solve_contact_kkt``
and ``pd_solve`` of crocoddyl_tpu/models/multibody/contacts.py, and of the
impulse solve of ``ImpulseNode._compute``, nodes.py:513-537).

The contact stack has a static maximal set of contacts; per-node 0/1
``active`` masks zero an inactive contact's Jacobian rows, and the KKT
solve gives it a unit diagonal so its multiplier is exactly zero.  The two
solves differentiate implicitly: each is a ``torch.autograd.Function``
whose ``jvp`` reuses the primal factorizations, as the JAX ``custom_jvp``
rules do, and ``torch.func.jacfwd``/``vmap`` go through it.  The impulse
solve follows the same pattern: JAX differentiates its unrolled
factorization in forward mode, which ``torch.linalg.cholesky_ex`` with the
NaN fill of ``smallchol.chol`` does not compose with under ``vmap``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...dynamics import lie
from ...dynamics.lie import cross
from ...dynamics.spatial import Transform
from ...ops import smallchol as _sc
from ...utils.struct import PyTreeNode, field


class Contact3D(PyTreeNode):
    """Point contact: a0 = a_lin + ω×v_lin + Kp·(p−pref) + Kv·v_lin."""

    fid: int = field(static=True)
    pref: torch.Tensor = None     # (3,) world reference translation
    gains: torch.Tensor = None    # (2,) Baumgarte (Kp, Kv)
    active: torch.Tensor = None   # 0/1

    @property
    def nc(self) -> int:
        return 3

    def calc(self, cache):
        J = cache.frame_jacobian_local(self.fid)[:3]
        vf = cache.frame_velocity(self.fid)
        vv, vw = vf[:3], vf[3:]
        ab = cache.frame_bias_acc(self.fid)
        a0 = ab[:3] + cross(vw, vv)
        a0 = a0 + self.gains[0] * (cache.frame_placement(self.fid).p
                                   - self.pref)
        a0 = a0 + self.gains[1] * vv
        return J, a0

    def calc_impulse(self, cache):
        """The impulse Jacobian (3, nv) (contacts.py:59-61)."""
        return cache.frame_jacobian_local(self.fid)[:3]

    def calc_tangent(self, cache, ft):
        """Closed-form d(−(Jc·a + a0))/dx (ndx, 3) from the frame tangents
        ``ft`` (algorithms.frame_tangents; contacts.py:63-73)."""
        vf = cache.frame_velocity(self.fid)
        vv, vw = vf[:3], vf[3:]
        dvv, dvw = ft.dv[:, :3], ft.dv[:, 3:]
        da0 = (ft.dab[:, :3] + cross(dvw, vv[None]) + cross(vw[None], dvv)
               + self.gains[0] * ft.dp + self.gains[1] * dvv)
        return -(ft.dJa[:, :3] + da0)


class Contact6D(PyTreeNode):
    """Placement contact: a0 = a_spatial + Kp·log6(Mref⁻¹·oMf) + Kv·v
    (contacts.py:76-113)."""

    fid: int = field(static=True)
    ref_R: torch.Tensor = None    # (3, 3) world reference placement
    ref_p: torch.Tensor = None    # (3,)
    gains: torch.Tensor = None    # (2,) Baumgarte (Kp, Kv)
    active: torch.Tensor = None   # 0/1

    @property
    def nc(self) -> int:
        return 6

    def _log(self, cache):
        oMf = cache.frame_placement(self.fid)
        rMf = Transform(self.ref_R, self.ref_p).inverse().compose(oMf)
        return lie.log6(rMf.R, rMf.p)

    def calc(self, cache):
        J = cache.frame_jacobian_local(self.fid)
        a0 = (cache.frame_bias_acc(self.fid)
              + self.gains[0] * self._log(cache)
              + self.gains[1] * cache.frame_velocity(self.fid))
        return J, a0

    def calc_impulse(self, cache):
        """The impulse Jacobian (6, nv) (contacts.py:99-100)."""
        return cache.frame_jacobian_local(self.fid)

    def calc_tangent(self, cache, ft):
        """Closed-form d(−(Jc·a + a0))/dx (ndx, 6): the log6 term chains
        through Jlog6 applied to the placement's local twist tangent
        (contacts.py:103-113)."""
        dlog = ft.dxi @ lie.jac_se3_right_inv(self._log(cache)).T
        da0 = ft.dab + self.gains[0] * dlog + self.gains[1] * ft.dv
        return -(ft.dJa + da0)


class ContactSet(PyTreeNode):
    """Static tuple of contacts; stacks masked (Jc, a0)."""

    contacts: Tuple = field(default_factory=tuple)

    @property
    def nc(self) -> int:
        return sum(c.nc for c in self.contacts)

    def slices(self):
        out, i = [], 0
        for c in self.contacts:
            out.append((i, c.nc))
            i += c.nc
        return out

    def calc(self, cache):
        """Masked stacked (Jc (nc, nv), a0 (nc,), active_rows (nc,))."""
        Js, a0s, masks = [], [], []
        for c in self.contacts:
            J, a0 = c.calc(cache)
            Js.append(J * c.active)
            a0s.append(a0 * c.active)
            masks.append(c.active.expand(c.nc))
        return torch.cat(Js), torch.cat(a0s), torch.cat(masks)

    def calc_impulse(self, cache):
        """Masked stacked (Jc (nc, nv), active_rows (nc,))
        (contacts.py:144-150)."""
        Js = [c.calc_impulse(cache) * c.active for c in self.contacts]
        masks = [c.active.expand(c.nc) for c in self.contacts]
        return torch.cat(Js), torch.cat(masks)

    def calc_tangents(self, kin, cache, a):
        """Closed-form d(r2)/dx (ndx, nc) of the stacked masked contact
        vector r2 = −(Jc·a + a0) (contacts.py:153-162)."""
        from ...dynamics import algorithms as algo
        return torch.cat([
            c.calc_tangent(cache, algo.frame_tangents(kin, a, c.fid))
            * c.active for c in self.contacts], dim=1)


def _contact_kkt_raw(M, Jc, a0, tau_minus_b, mask, damping):
    """Schur-complement solve of [M Jᵀ; J −damping·I][a; −λ] = [τ−b; −a0]
    (contacts.py:165-182): (a, λ, chol(M), chol(S), M⁻¹Jᵀ); an inactive
    row gets a unit diagonal in S, so its λ is exactly 0."""
    nc = Jc.shape[0]
    eye = torch.eye(nc, dtype=M.dtype, device=M.device)
    Lm = _sc.chol(M)
    X = _sc.cho_solve(Lm, torch.cat([Jc.T, tau_minus_b[:, None]], dim=1))
    MinvJT, a_free = X[:, :nc], X[:, nc]
    S = Jc @ MinvJT + damping * eye
    S = S * (mask[:, None] * mask[None, :]) + torch.diag_embed(1.0 - mask)
    Ls = _sc.chol(S)
    lam = _sc.cho_solve(Ls, -(Jc @ a_free + a0) * mask)
    return a_free + MinvJT @ lam, lam, Lm, Ls, MinvJT


def _or_zeros(t, like):
    return torch.zeros_like(like) if t is None else t


class _ContactKKT(torch.autograd.Function):
    """``_contact_kkt_raw`` with the implicit JVP of
    contacts.py:215-236: at fixed (a, λ), M·da − Jᵀ·dλ = r1 := dτ−db −
    dM·a + dJᵀλ and J·da + damping·dλ = r2 := −da0 − dJ·a, so
    S·dλ = r2 − J·M⁻¹·r1 through the primal factors."""

    generate_vmap_rule = True

    @staticmethod
    def forward(M, Jc, a0, tau_minus_b, mask, damping):
        return _contact_kkt_raw(M, Jc, a0, tau_minus_b, mask, damping)

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, Jc, a0, taumb, mask, _ = inputs
        a, lam, Lm, Ls, MinvJT = output
        ctx.save_for_forward(M, Jc, a0, taumb, mask, a, lam, Lm, Ls, MinvJT)

    @staticmethod
    def jvp(ctx, dM, dJc, da0, dtaumb, _dmask, _ddamping):
        M, Jc, a0, taumb, mask, a, lam, Lm, Ls, MinvJT = ctx.saved_tensors
        dM, dJc = _or_zeros(dM, M), _or_zeros(dJc, Jc)
        da0, dtaumb = _or_zeros(da0, a0), _or_zeros(dtaumb, taumb)
        r1 = dtaumb - dM @ a + dJc.T @ lam
        r2 = -(da0 + dJc @ a)
        Minv_r1 = _sc.cho_solve(Lm, r1)
        dlam = _sc.cho_solve(Ls, (r2 - Jc @ Minv_r1) * mask)
        return (Minv_r1 + MinvJT @ dlam, dlam, torch.zeros_like(Lm),
                torch.zeros_like(Ls), torch.zeros_like(MinvJT))


def solve_contact_kkt(M, Jc, a0, tau_minus_b, mask, damping=0.0):
    """(a, λ (nc,), chol(M)) of the contact KKT (contacts.py:187-212),
    differentiated implicitly through the primal factorizations."""
    return _ContactKKT.apply(M, Jc, a0, tau_minus_b, mask, damping)[:3]


class _PDSolve(torch.autograd.Function):
    """a = M⁻¹·rhs for positive-definite M with the implicit JVP
    da = M⁻¹(drhs − dM·a) through the primal factor (contacts.py:239-252)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(M, rhs):
        L = _sc.chol(M)
        return _sc.cho_solve(L, rhs), L

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, rhs = inputs
        a, L = output
        ctx.save_for_forward(M, rhs, a, L)

    @staticmethod
    def jvp(ctx, dM, drhs):
        M, rhs, a, L = ctx.saved_tensors
        da = _sc.cho_solve(L, _or_zeros(drhs, rhs) - _or_zeros(dM, M) @ a)
        return da, torch.zeros_like(L)


def pd_solve(M, rhs):
    """M⁻¹·rhs for positive-definite M, differentiated implicitly."""
    return _PDSolve.apply(M, rhs)[0]


def _impulse_kkt_raw(M, Jc, v, e, mask, damping):
    """Schur-complement solve of the impulse KKT [M Jᵀ; J −damping·I]
    [v⁺; −Λ] = [M·v; e·J·v] (nodes.py:525-535): S·Λ = −(1+e)·J·v with
    S = J·M⁻¹·Jᵀ + damping·I (an inactive row a unit diagonal, so its Λ is
    exactly 0), then v⁺ = v + M⁻¹·Jᵀ·Λ.  Returns (v⁺, Λ, chol(M),
    chol(S), M⁻¹Jᵀ)."""
    nc = Jc.shape[0]
    eye = torch.eye(nc, dtype=M.dtype, device=M.device)
    Lm = _sc.chol(M)
    MinvJT = _sc.cho_solve(Lm, Jc.T)
    S = Jc @ MinvJT + damping * eye
    S = S * (mask[:, None] * mask[None, :]) + torch.diag_embed(1.0 - mask)
    Ls = _sc.chol(S)
    lam = _sc.cho_solve(Ls, -(1.0 + e) * (Jc @ v) * mask)
    return v + MinvJT @ lam, lam, Lm, Ls, MinvJT


class _ImpulseKKT(torch.autograd.Function):
    """``_impulse_kkt_raw`` with its implicit JVP: at fixed (v⁺, Λ),
    M·dv⁺ − Jᵀ·dΛ = r1 := M·dv + dM·(v − v⁺) + dJᵀ·Λ and
    J·dv⁺ + damping·dΛ = r2 := −dJ·v⁺ − de·J·v − e·(dJ·v + J·dv), so
    S·dΛ = r2 − J·M⁻¹·r1 through the primal factors (as ``_ContactKKT``)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(M, Jc, v, e, mask, damping):
        return _impulse_kkt_raw(M, Jc, v, e, mask, damping)

    @staticmethod
    def setup_context(ctx, inputs, output):
        M, Jc, v, e, mask, _ = inputs
        vn, lam, Lm, Ls, MinvJT = output
        ctx.save_for_forward(M, Jc, v, e, mask, vn, lam, Lm, Ls, MinvJT)

    @staticmethod
    def jvp(ctx, dM, dJc, dv, de, _dmask, _ddamping):
        M, Jc, v, e, mask, vn, lam, Lm, Ls, MinvJT = ctx.saved_tensors
        dM, dJc = _or_zeros(dM, M), _or_zeros(dJc, Jc)
        dv, de = _or_zeros(dv, v), _or_zeros(de, e)
        r1 = M @ dv + dM @ (v - vn) + dJc.T @ lam
        r2 = -(dJc @ vn) - de * (Jc @ v) - e * (dJc @ v + Jc @ dv)
        Minv_r1 = _sc.cho_solve(Lm, r1)
        dlam = _sc.cho_solve(Ls, (r2 - Jc @ Minv_r1) * mask)
        return (Minv_r1 + MinvJT @ dlam, dlam, torch.zeros_like(Lm),
                torch.zeros_like(Ls), torch.zeros_like(MinvJT))


def solve_impulse_kkt(M, Jc, v, e, mask, damping=0.0):
    """(v⁺, Λ (nc,)) of the impulse KKT, differentiated implicitly through
    the primal factorizations."""
    return _ImpulseKKT.apply(M, Jc, v, e, mask, damping)[:2]
