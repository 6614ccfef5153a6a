"""Finite-difference derivative checkers (port of
crocoddyl_tpu/utils/numdiff.py; reference: core/numdiff/{action,state,
actuation,activation}.hpp and multibody/numdiff/contact.hpp).

Given a model, these compute its derivatives in tangent coordinates by
forward differences, column by column along ``integrate(x, h·e_i)``
(core/numdiff/action.hxx:60-97), for comparison with the model's own.  The
default disturbance is √(2ε) (action.hxx:18).  The columns are evaluated
under ``torch.func.vmap``.  Oracles only: nothing on the solver's path
calls them.
"""

from __future__ import annotations

import math

import torch
from torch.func import vmap

from ..core.action import NodeDerivs

DISTURBANCE = math.sqrt(2.0 * torch.finfo(torch.float64).eps)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _fd_first(model, x, u, h):
    """(Fx, Fu, Lx, Lu) by forward differences (numdiff.py:41-60)."""
    st = model.state
    xn0, c0 = model.calc(x, u)

    def colx(e):
        xn, c = model.calc(st.integrate(x, h * e), u)
        return st.diff(xn0, xn) / h, (c - c0) / h

    def colu(e):
        xn, c = model.calc(x, u + h * e)
        return st.diff(xn0, xn) / h, (c - c0) / h

    Fx_T, Lx = vmap(colx)(_eye(st.ndx, x))
    Fu_T, Lu = vmap(colu)(_eye(model.nu, x))
    return Fx_T.T, Fu_T.T, Lx, Lu


def _fd_second(model, x, u, h):
    """(Lxx, Lxu, Luu) by forward differences of the forward-difference
    cost gradient (numdiff.py:63-83)."""
    st = model.state
    ex, eu = _eye(st.ndx, x), _eye(model.nu, x)

    def grad(xq, uq):
        c = model.calc(xq, uq)[1]
        gx = vmap(lambda e: (model.calc(st.integrate(xq, h * e), uq)[1]
                             - c) / h)(ex)
        gu = vmap(lambda e: (model.calc(xq, uq + h * e)[1] - c) / h)(eu)
        return gx, gu

    gx0, gu0 = grad(x, u)
    gxi, gui = vmap(lambda e: grad(st.integrate(x, h * e), u))(ex)
    _, guu = vmap(lambda e: grad(x, u + h * e))(eu)
    return (gxi - gx0).T / h, (gui - gu0) / h, (guu - gu0).T / h


def numdiff_action(model, x, u, h: float = None) -> NodeDerivs:
    """Forward-difference Fx, Fu, Lx, Lu and the Hessians by differences of
    the difference gradient (core/numdiff/action.hxx semantics)."""
    h = DISTURBANCE if h is None else h
    Fx, Fu, Lx, Lu = _fd_first(model, x, u, h)
    Lxx, Lxu, Luu = _fd_second(model, x, u, h)
    return NodeDerivs(Fx=Fx, Fu=Fu, Lx=Lx, Lu=Lu, Lxx=Lxx, Lxu=Lxu, Luu=Luu)


def numdiff_fxlx(model, x, u, h: float = 1e-6):
    """First-order forward differences (Fx, Fu, Lx, Lu) only: the cheap
    oracle of the node tests (numdiff.py:98-104)."""
    return _fd_first(model, x, u, h)


def numdiff_state(state, x0, x1, h: float = None):
    """Forward-difference (Jdiff first, Jdiff second, Jintegrate x,
    Jintegrate dx) at (x0, x1) and at (x0, dx = diff(x0, x1))
    (core/numdiff/state.hpp; numdiff.py:107-131)."""
    h = DISTURBANCE if h is None else h
    e = _eye(state.ndx, x0)
    d0 = state.diff(x0, x1)
    J1 = vmap(lambda ei: (state.diff(state.integrate(x0, h * ei), x1)
                          - d0) / h)(e)
    J2 = vmap(lambda ei: (state.diff(x0, state.integrate(x1, h * ei))
                          - d0) / h)(e)
    y0 = state.integrate(x0, d0)
    Jx = vmap(lambda ei: state.diff(
        y0, state.integrate(state.integrate(x0, h * ei), d0)) / h)(e)
    Jdx = vmap(lambda ei: state.diff(
        y0, state.integrate(x0, d0 + h * ei)) / h)(e)
    return J1.T, J2.T, Jx.T, Jdx.T


def numdiff_actuation(actuation, x, u, h: float = None):
    """Forward-difference dτ/du of an actuation (core/numdiff/actuation.hpp;
    numdiff.py:134-142)."""
    h = DISTURBANCE if h is None else h
    tau0 = actuation.calc(x, u)
    return vmap(lambda e: (actuation.calc(x, u + h * e) - tau0) / h)(
        _eye(u.shape[0], u)).T


def numdiff_activation(activation, r, h: float = None):
    """Forward-difference (Ar, diag Arr) of an activation
    (core/numdiff/activation.hpp; numdiff.py:145-156)."""
    h = DISTURBANCE if h is None else h
    a0, Ar0, _ = activation.calc(r)
    e = _eye(r.shape[0], r)
    Ar = vmap(lambda ei: (activation.calc(r + h * ei)[0] - a0) / h)(e)
    Arr = vmap(lambda ei: (activation.calc(r + h * ei)[1] - Ar0) / h)(e)
    return Ar, torch.diagonal(Arr.T)


def numdiff_contact(contact, state, x, a=None, h: float = None):
    """Forward differences of one contact (multibody/numdiff/contact.hpp;
    numdiff.py:159-189): (J, a0, da0/dx (nc, ndx), d(J·a)/dx (nc, ndx)) for
    a fixed joint acceleration ``a`` (default zero)."""
    from ..dynamics import algorithms as algo
    from ..models.multibody.nodes import NodeCache
    h = DISTURBANCE if h is None else h
    nq = state.nq
    if a is None:
        a = x.new_zeros((state.nv,))

    def eval_at(xi):
        return contact.calc(NodeCache(algo.KinData(state.model, xi[:nq],
                                                   xi[nq:])))

    J0, a00 = eval_at(x)

    def col(ei):
        Ji, a0i = eval_at(state.integrate(x, h * ei))
        return (a0i - a00) / h, (Ji - J0) @ a / h

    da0, dJa = vmap(col)(_eye(state.ndx, x))
    return J0, a00, da0.T, dJa.T
