"""Rigid-body OCP nodes (port of crocoddyl_tpu/models/multibody/nodes.py:
``NodeCache``, ``CostStack``, ``RigidBodyNode`` and ``ImpulseNode``):
{free | contact} forward dynamics + cost sum + semi-implicit Euler (or RK4)
integration, with the dt=0 terminal / pseudo-impulse semantics, and the
discrete impact knot of the true-impulse gaits.

``RigidBodyNode`` is an ``ActionModel``: its ``calc``, ``calc_both``,
``calc_diff_terminal`` and ``calc_terminal`` compute what the JAX node's
do, for every structure, in plain PyTorch that runs under
``torch.func.vmap`` over the knots (no host sync, no branch on a value).
Its derivatives are the JAX node's closed-form chain
(``_tangent_outputs``): the sweep's tangents from
``algorithms.gforce_derivatives`` and ``frame_tangents``, every tangent
direction back-substituted through the primal KKT factors, Gauss-Newton
cost terms and the Euler chain rule through the manifold retraction.

Which path a problem takes is decided per stack by the problem
(core/problem.py), not by the node: a stack the node kernel admits
(``ops/fused_node.supports``) goes through the lane functions and the
kernel, every other stack through these methods.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.func import jacfwd, jvp, vmap

from ...core.action import ActionModel, NodeDerivs
from ...dynamics import algorithms as algo
from ...dynamics.states import StateMultibody
from ...ops import smallchol as _sc
from ...utils.struct import PyTreeNode, field
from .actuations import Actuation
from .contacts import (ContactSet, _contact_kkt_raw, _impulse_kkt_raw,
                       pd_solve, solve_contact_kkt, solve_impulse_kkt)
from .costs import cost_nr


class NodeCache:
    """Per-node computed data handed to cost residuals (nodes.py:40-68)."""

    def __init__(self, kin: algo.KinCache, forces=None, vnext=None, tau=None,
                 a=None):
        self.kin = kin
        self.model = kin.model
        self.q, self.v = kin.q, kin.v
        self.oMi, self.vels = kin.oMi, kin.vels
        self.forces = forces or []
        self.vnext = vnext
        self.tau = tau
        self.a = a

    def frame_placement(self, fid):
        return self.kin.frame_placement(fid)

    def frame_velocity(self, fid):
        return self.kin.frame_velocity(fid)

    def frame_bias_acc(self, fid):
        return self.kin.frame_bias_acc(fid)

    def frame_jacobian_local(self, fid):
        return self.kin.frame_jacobian_local(fid)

    def contact_force(self, idx):
        return self.forces[idx]


class CostStack(PyTreeNode):
    """Weighted sum of residual costs (nodes.py:71-117)."""

    items: Tuple = field(default_factory=tuple)

    def residuals(self, st, cache, x, u):
        if not self.items:
            return x.new_zeros((0,))
        return torch.cat([c.residual(st, cache, x, u) for c in self.items])

    def slices(self, st):
        out, i = [], 0
        for c in self.items:
            n = cost_nr(c, st)
            out.append((i, n))
            i += n
        return out

    def value(self, st, R):
        """Total cost from the stacked residual vector."""
        total = R.new_zeros(())
        for c, (i, n) in zip(self.items, self.slices(st)):
            a, _, _ = c.activation.calc(R[i:i + n])
            total = total + c.active * c.weight * a
        return total

    def gauss_newton(self, st, R, Rx, Ru):
        """(Lx, Lu, Lxx, Lxu, Luu) in Gauss-Newton form: residual Jacobians
        contracted with the activations' (Ar, Arr)."""
        ndx, nu = Rx.shape[-1], Ru.shape[-1]
        Lx, Lu = R.new_zeros((ndx,)), R.new_zeros((nu,))
        Lxx, Lxu = R.new_zeros((ndx, ndx)), R.new_zeros((ndx, nu))
        Luu = R.new_zeros((nu, nu))
        for c, (i, n) in zip(self.items, self.slices(st)):
            _, Ar, Arr = c.activation.calc(R[i:i + n])
            w = c.active * c.weight
            rx, ru = Rx[i:i + n], Ru[i:i + n]
            Lx = Lx + w * (rx.T @ Ar)
            Lu = Lu + w * (ru.T @ Ar)
            Lxx = Lxx + w * (rx.T @ (rx * Arr[:, None]))
            Lxu = Lxu + w * (rx.T @ (ru * Arr[:, None]))
            Luu = Luu + w * (ru.T @ (ru * Arr[:, None]))
        return Lx, Lu, Lxx, Lxu, Luu


class RigidBodyNode(ActionModel):
    """Fused {free|contact} dynamics + costs + Euler/RK4 node."""

    state_: StateMultibody
    actuation: Actuation
    costs: CostStack
    contacts: Optional[ContactSet] = None
    dt: torch.Tensor = None
    armature: Optional[torch.Tensor] = None
    kkt_damping: float = field(static=True, default=0.0)
    integrator: str = field(static=True, default="euler")

    @property
    def state(self) -> StateMultibody:
        return self.state_

    @property
    def nu(self) -> int:
        return self.actuation.nu

    @property
    def _has_contacts(self) -> bool:
        return self.contacts is not None and bool(self.contacts.contacts)

    def _forces(self, lam):
        return [lam[i:i + c.nc] for (i, _), c in
                zip(self.contacts.slices(), self.contacts.contacts)]

    # ------------------------------------------------------------------
    def _dynamics(self, x, u, implicit=False):
        """Continuous dynamics: (a (nv,), cache) (nodes.py:141-164).  With
        ``implicit`` the KKT and mass-matrix solves carry their implicit
        JVP rules (for a caller under ``jacfwd``); the primal path solves
        directly, which under ``vmap`` skips the rules' dispatch."""
        st = self.state_
        m = st.model
        tau = self.actuation.calc(x, u)
        kin = algo.KinCache(m, x[:st.nq], x[st.nq:])
        M = kin.mass_matrix(self.armature)
        b = kin.bias_forces()
        if self._has_contacts:
            cache = NodeCache(kin, tau=tau)
            Jc, a0, mask = self.contacts.calc(cache)
            kkt = solve_contact_kkt if implicit else _contact_kkt_raw
            a, lam = kkt(M, Jc, a0, tau - b, mask, self.kkt_damping)[:2]
            cache.forces = self._forces(lam)
            cache.a = a
            return a, cache
        a = (pd_solve if implicit else _sc.pd_solve)(M, tau - b)
        return a, NodeCache(kin, tau=tau, a=a)

    def _compute(self, x, u, implicit=False):
        """(xnext, cost, R): one evaluation of the discrete node; a dt=0
        node is a terminal / pseudo-impulse node (xnext = x, undiscounted
        cost) (nodes.py:166-195)."""
        st = self.state_
        a, cache = self._dynamics(x, u, implicit)
        R = self.costs.residuals(st, cache, x, u)
        cost_rate = self.costs.value(st, R)
        dt = self.dt
        if self.integrator == "euler":
            v = x[st.nq:]
            xnext_int = st.integrate(x, torch.cat([v * dt + a * dt * dt,
                                                   a * dt]))
        else:  # rk4 on (q, v) with frozen u
            def f(xs):
                return torch.cat([xs[st.nq:],
                                  self._dynamics(xs, u, implicit)[0]])
            k1 = f(x)
            k2 = f(st.integrate(x, 0.5 * dt * k1))
            k3 = f(st.integrate(x, 0.5 * dt * k2))
            k4 = f(st.integrate(x, dt * k3))
            xnext_int = st.integrate(x, dt / 6.0 * (k1 + 2 * k2 + 2 * k3
                                                    + k4))
        is_terminal = dt == 0.0
        return (torch.where(is_terminal, x, xnext_int),
                torch.where(is_terminal, cost_rate, dt * cost_rate), R)

    def calc(self, x, u):
        xnext, cost, _ = self._compute(x, u)
        return xnext, cost

    def calc_terminal(self, x):
        """The cost rate at u = 0, undiscounted (nodes.py:201-205)."""
        u = x.new_zeros((self.nu,))
        _, cache = self._dynamics(x, u)
        return self.costs.value(self.state_, self.costs.residuals(
            self.state_, cache, x, u))

    # ------------------------------------------------------------------
    def _tangent_outputs(self, x, u):
        """(Fx, Fu, R, Rx, Ru, xnext, cost): the closed-form linearization
        of nodes.py:208-416.  The sweep's tangents are closed form
        (gforce_derivatives for the dynamics, frame_tangents for contacts
        and frame costs); all ndx+nu directions are back-substituted
        through the primal Cholesky factors of the KKT in one multi-RHS
        solve; the residual Jacobians add the force chain (∂R/∂λ)·dλ; the
        Euler step chains through the closed-form Jintegrate blocks.  An
        RK4 node takes one ``jacfwd`` of the whole node."""
        st = self.state_
        nv, ndx, nu = st.nv, st.ndx, self.nu
        z_dx, z_du = x.new_zeros((ndx,)), x.new_zeros((nu,))

        if self.integrator != "euler":
            xnext0, cost0, _ = self._compute(x, u)

            def g(dx, du):
                xn, _, R = self._compute(st.integrate(x, dx), u + du,
                                         implicit=True)
                return (st.diff(xnext0, xn), R), R

            ((Fx, Fu), (Rx, Ru)), R0 = jacfwd(
                g, argnums=(0, 1), has_aux=True)(z_dx, z_du)
            return Fx, Fu, R0, Rx, Ru, xnext0, cost0

        m = st.model
        xi0 = st.integrate(x, z_dx)
        kin0 = algo.KinData(m, xi0[:st.nq], xi0[st.nq:])

        # -- primal dynamics at the linearization point --------------------
        tau0 = self.actuation.calc(xi0, u)
        M = kin0.mass_matrix(self.armature)
        b = kin0.bias_forces()
        cache0 = NodeCache(kin0, tau=tau0)
        if self._has_contacts:
            Jc, a0v, mask = self.contacts.calc(cache0)
            a, lam, Lm, Ls, MinvJT = _contact_kkt_raw(
                M, Jc, a0v, tau0 - b, mask, self.kkt_damping)
            forces0 = self._forces(lam)
            cache0.forces = forces0
            nc = Jc.shape[0]
        else:
            Lm = _sc.chol(M)
            a = _sc.cho_solve(Lm, tau0 - b)
            forces0, nc = [], 0
        cache0.a = a

        # -- x-tangents of r1 = τ − M·a − b + Jcᵀλ: the contact forces enter
        # as fixed world wrenches on the contact bodies
        ext_w = None
        if nc:
            per_joint = {}
            for lam_c, c in zip(forces0, self.contacts.contacts):
                wrench = torch.cat([lam_c, lam_c.new_zeros((3,))]) \
                    if c.nc == 3 else lam_c
                w_w = cache0.frame_placement(c.fid).act_force(wrench)
                j = m.frame_parents[c.fid]
                per_joint[j] = per_joint[j] + w_w if j in per_joint else w_w
            zero6 = x.new_zeros((6,))
            ext_w = torch.stack([per_joint.get(j, zero6)
                                 for j in range(m.njoints)])
        dG_dq, dG_dv = algo.gforce_derivatives(kin0, a, ext_w)
        dtau_dx = jacfwd(
            lambda dx: self.actuation.calc(st.integrate(x, dx), u))(z_dx)
        dr1_dx = dtau_dx - torch.cat([dG_dq, dG_dv], dim=1)

        # -- x-tangents of r2 = −(Jc·a + a0), closed form per frame ---------
        r2x = (self.contacts.calc_tangents(kin0, cache0, a) if nc
               else x.new_zeros((ndx, 0)))

        # -- residual tangents: closed form per cost, or the generic sweep
        # linearization of the whole stack if one cost has none
        fts = {}

        def ft_of(fid):
            if fid not in fts:
                fts[fid] = algo.frame_tangents(kin0, a, fid)
            return fts[fid]

        R = self.costs.residuals(st, cache0, xi0, u)
        nr = R.shape[0]
        jac_rows = [c.residual_jac_x(st, cache0, xi0, u, ft_of)
                    for c in self.costs.items]
        if all(j is not None for j in jac_rows):
            Rx = (torch.cat(jac_rows, dim=0) if jac_rows
                  else x.new_zeros((0, ndx)))
        else:
            ka0 = kin0.arrays()
            dka_all = algo.kin_tangent_basis(kin0)    # leading (ndx,) axis
            dxi_all = jacfwd(lambda dx: st.integrate(x, dx))(z_dx).T

            def h_x(ka, xi):
                kin = algo.KinData.from_arrays(m, xi[:st.nq], xi[st.nq:], ka)
                cache = NodeCache(kin, forces=forces0, a=a)
                return self.costs.residuals(st, cache, xi, u)

            Rx = vmap(lambda dka, dxi: jvp(h_x, (ka0, xi0), (dka, dxi))[1]
                      )(dka_all, dxi_all).T

        # -- u-tangents: no kinematic dependence -----------------------------
        def h_u(du):
            ui = u + du
            cache = NodeCache(kin0, forces=forces0, a=a)
            return (self.actuation.calc(xi0, ui),
                    self.costs.residuals(st, cache, xi0, ui))

        dtau_du, Ru = jacfwd(h_u)(z_du)       # (nv, nu), (nr, nu)

        # -- back-substitute all ndx+nu directions at once --------------------
        r1_all = torch.cat([dr1_dx, dtau_du], dim=1)     # (nv, ndx+nu)
        if nc:
            r2_all = torch.cat([r2x.T, x.new_zeros((nc, nu))], dim=1)
            Minv_r1 = _sc.cho_solve(Lm, r1_all)
            dlam = _sc.cho_solve(Ls, (r2_all - Jc @ Minv_r1) * mask[:, None])
            dacc = Minv_r1 + MinvJT @ dlam
        else:
            dacc = _sc.cho_solve(Lm, r1_all)
        da_dx, da_du = dacc[:, :ndx], dacc[:, ndx:]

        # -- residual force dependence: dR += (∂R/∂λ)·dλ ---------------------
        if nc and nr:
            def h_f(lam_v):
                cache = NodeCache(kin0, forces=self._forces(lam_v), a=a)
                return self.costs.residuals(st, cache, xi0, u)

            Rf = jacfwd(h_f)(lam)                 # (nr, nc)
            Rx = Rx + Rf @ dlam[:, :ndx]
            Ru = Ru + Rf @ dlam[:, ndx:]

        # -- Euler step through the retraction: xnext = x ⊕ dstep -----------
        v = x[st.nq:]
        dt = self.dt
        dstep = torch.cat([v * dt + a * dt * dt, a * dt])
        Jx, Jdx = st.jintegrate(x, dstep)
        dv_ddx = torch.cat([x.new_zeros((nv, nv)),
                            torch.eye(nv, dtype=x.dtype, device=x.device)], 1)
        dstep_dx = torch.cat([dt * dv_ddx + dt * dt * da_dx, dt * da_dx], 0)
        dstep_du = torch.cat([dt * dt * da_du, dt * da_du], 0)
        is_term = dt == 0.0
        Fx = torch.where(is_term, torch.eye(ndx, dtype=x.dtype,
                                            device=x.device),
                         Jx + Jdx @ dstep_dx)
        Fu = torch.where(is_term, x.new_zeros((ndx, nu)), Jdx @ dstep_du)
        xnext = torch.where(is_term, x, st.integrate(x, dstep))
        cost_rate = self.costs.value(st, R)
        cost = torch.where(is_term, cost_rate, dt * cost_rate)
        return Fx, Fu, R, Rx, Ru, xnext, cost

    def calc_diff(self, x, u) -> NodeDerivs:
        return self.calc_both(x, u)[0]

    def calc_both(self, x, u):
        """(NodeDerivs, xnext, cost) in one evaluation (nodes.py:421-431)."""
        Fx, Fu, R, Rx, Ru, xnext, cost = self._tangent_outputs(x, u)
        Lx, Lu, Lxx, Lxu, Luu = self.costs.gauss_newton(self.state_, R, Rx,
                                                        Ru)
        s = torch.where(self.dt == 0.0, torch.ones_like(self.dt), self.dt)
        return (NodeDerivs(Fx=Fx, Fu=Fu, Lx=s * Lx, Lu=s * Lu, Lxx=s * Lxx,
                           Lxu=s * Lxu, Luu=s * Luu), xnext, cost)

    def calc_diff_terminal(self, x) -> NodeDerivs:
        """Terminal derivatives: Gauss-Newton terms of the residuals at
        u = 0 by ``jacfwd`` through the dynamics, Fx = I, Fu = 0, Ru = 0
        (nodes.py:433-450)."""
        st = self.state_
        u = x.new_zeros((self.nu,))

        def r_of(dx):
            xi = st.integrate(x, dx)
            _, cache = self._dynamics(xi, u, implicit=True)
            return self.costs.residuals(st, cache, xi, u)

        z = x.new_zeros((st.ndx,))
        Rx = jacfwd(r_of)(z)
        R = r_of(z)
        Ru = x.new_zeros((R.shape[0], self.nu))
        Lx, Lu, Lxx, Lxu, Luu = self.costs.gauss_newton(st, R, Rx, Ru)
        return NodeDerivs(Fx=torch.eye(st.ndx, dtype=x.dtype,
                                       device=x.device),
                          Fu=x.new_zeros((st.ndx, self.nu)),
                          Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu)

    def quasi_static(self, x):
        """Torques balancing gravity and contacts at rest: least-squares
        τ(u) = b(q, 0) (nodes.py:452-490), with dτ/du by ``jacfwd`` of the
        actuation at u = 0."""
        st = self.state_
        m = st.model
        q = x[:st.nq]
        v0 = x.new_zeros((st.nv,))
        b = algo.rnea(m, q, v0, v0)
        dtau_du = jacfwd(lambda uu: self.actuation.calc(x, uu))(
            x.new_zeros((self.nu,)))

        def ls_solve(A, rhs):
            # Cholesky'd normal equations; a wide system (inactive contact
            # columns are zero) takes the min-norm dual form
            eps = 1e-9 if A.dtype == torch.float64 else 1e-5
            wide = A.shape[0] < A.shape[1]
            G = A @ A.T if wide else A.T @ A
            lam = eps * (torch.trace(G) / G.shape[0] + 1.0)
            L = torch.linalg.cholesky(
                G + lam * torch.eye(G.shape[0], dtype=A.dtype,
                                    device=A.device))
            if wide:
                return A.T @ torch.cholesky_solve(rhs[:, None], L)[:, 0]
            return torch.cholesky_solve((A.T @ rhs)[:, None], L)[:, 0]

        if self._has_contacts:
            Jc, _, _ = self.contacts.calc(NodeCache(algo.KinCache(m, q, v0)))
            return ls_solve(torch.cat([dtau_du, Jc.T], dim=1), b)[:self.nu]
        return ls_solve(dtau_du, b)


class ImpulseNode(ActionModel):
    """Discrete impact knot (nodes.py:492-573; impulse-fwddyn.hxx:57-137):
    solves [M Jᵀ; J 0][v⁺; −Λ] = [M·v⁻; −e·J·v⁻] and gives xnext = (q, v⁺);
    its nu controls are ignored (Fu = 0: the reference's nu = 0 in a
    problem of uniform nu).  The impulse multipliers Λ are the node's
    forces, read by the impulse costs as the contact costs read a contact
    node's.  Its derivatives are ``jacfwd`` through the whole knot, as
    JAX's are."""

    state_: StateMultibody
    impulses: ContactSet
    costs: CostStack
    nu_: int = field(static=True, default=0)
    r_coeff: Optional[torch.Tensor] = None     # restitution (default 0)
    kkt_damping: float = field(static=True, default=0.0)

    @property
    def state(self) -> StateMultibody:
        return self.state_

    @property
    def nu(self) -> int:
        return self.nu_

    def _compute(self, x, implicit=False):
        """(xnext, cost, R) of the impact (nodes.py:513-543).  With
        ``implicit`` the impulse solve carries its JVP rule (for a caller
        under ``jacfwd``)."""
        st = self.state_
        q, v = x[:st.nq], x[st.nq:]
        kin = algo.KinCache(st.model, q, v)
        cache = NodeCache(kin)
        Jc, mask = self.impulses.calc_impulse(cache)
        M = kin.mass_matrix()
        e = (self.r_coeff if self.r_coeff is not None
             else x.new_zeros(()))
        solve = solve_impulse_kkt if implicit else _impulse_kkt_raw
        vnext, lam = solve(M, Jc, v, e, mask, self.kkt_damping)[:2]
        cache.forces = [lam[i:i + c.nc] for (i, _), c in
                        zip(self.impulses.slices(), self.impulses.contacts)]
        cache.vnext = vnext
        R = self.costs.residuals(st, cache, x, x.new_zeros((self.nu_,)))
        return torch.cat([q, vnext]), self.costs.value(st, R), R

    def calc(self, x, u):
        xnext, cost, _ = self._compute(x)
        return xnext, cost

    def calc_terminal(self, x):
        return self._compute(x)[1]

    def calc_diff(self, x, u) -> NodeDerivs:
        return self.calc_both(x, u)[0]

    def calc_both(self, x, u):
        """(NodeDerivs, xnext, cost): Fx and the residual Jacobian Rx by
        ``jacfwd`` through x ⊕ dx and xnext ⊖ xnext0, Gauss-Newton cost
        terms, Fu = 0 and Ru = 0 (nodes.py:555-570)."""
        st = self.state_
        xnext0, cost0, _ = self._compute(x)

        def g(dx):
            xn, _, R = self._compute(st.integrate(x, dx), implicit=True)
            return (st.diff(xnext0, xn), R), R

        (Fx, Rx), R0 = jacfwd(g, has_aux=True)(x.new_zeros((st.ndx,)))
        Ru = x.new_zeros((R0.shape[0], self.nu_))
        Lx, Lu, Lxx, Lxu, Luu = self.costs.gauss_newton(st, R0, Rx, Ru)
        return (NodeDerivs(Fx=Fx, Fu=x.new_zeros((st.ndx, self.nu_)),
                           Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu),
                xnext0, cost0)

    def calc_diff_terminal(self, x) -> NodeDerivs:
        return self.calc_diff(x, x.new_zeros((self.nu_,)))
