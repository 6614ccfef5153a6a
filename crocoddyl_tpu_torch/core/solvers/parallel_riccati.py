"""Horizon-parallel Riccati backward pass by an associative scan (port of
crocoddyl_tpu/core/solvers/parallel_riccati.py).

The sequential backward pass is a chain of T dependent small-matrix steps.
This pass computes the same value functions with an associative scan over
affine-quadratic value-function maps (Särkkä & García-Fernández, IEEE TAC
2021, §V applied to LQT): log₂T levels of batched element combines.

Element E_[k,l) maps the value function at knot l to the one at knot k:

    S_k = J + Aᵀ S_l (I + C S_l)⁻¹ A
    s_k = η + Aᵀ (I + S_l C)⁻¹ (s_l + S_l b)

with the control of each knot eliminated through its own Luu (+ ureg·I):

    A = Fx − Fu Luu⁻¹ Lxuᵀ        b = f_{k+1} − Fu Luu⁻¹ Lu
    C = Fu Luu⁻¹ Fuᵀ              η = Lx − Lxu Luu⁻¹ Lu
    J = Lxx − Lxu Luu⁻¹ Lxuᵀ

f_{k+1} is the FDDP gap (the sequential pass's Vx += Vxx·f), and xreg·I is
folded into every knot's Lxx.  After the suffix scan, the gains K, k and Qu
come from one batched pass with the sequential pass's formulas.

The scan combines elements in the order of JAX's ``lax.associative_scan``
(pairs, recursion on the odd elements, then the even ones), so the two
packages round alike.  The ``(I + C·J)`` solves are ``torch.linalg.solve``
(LU); the factorizations of Luu and Quu are the Jacobi-equilibrated
Cholesky of ``ops/smallchol``, NaN where they fail.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ...ops.smallchol import cho_solve, chol


class _Elem(NamedTuple):
    A: torch.Tensor    # (..., n, n)
    b: torch.Tensor    # (..., n)
    C: torch.Tensor    # (..., n, n)
    eta: torch.Tensor  # (..., n)
    J: torch.Tensor    # (..., n, n)


def _mT(a):
    return a.transpose(-1, -2)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


def _combine(e_later: _Elem, e_earlier: _Elem) -> _Elem:
    """E_[i,l) = E_[i,j) ∘ E_[j,l) for e_earlier = E_[i,j), e_later =
    E_[j,l) (parallel_riccati.py:58-90): the scan runs over the reversed
    elements, so its left operand is the block nearer the terminal."""
    A1, b1, C1, eta1, J1 = e_earlier
    A2, b2, C2, eta2, J2 = e_later
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device)
    M = eye + C1 @ J2
    A = A2 @ torch.linalg.solve(M, A1)
    b = _mv(A2, torch.linalg.solve(M, (b1 - _mv(C1, eta2))[..., None])[..., 0]
            ) + b2
    C = A2 @ torch.linalg.solve(M, C1) @ _mT(A2) + C2
    C = 0.5 * (C + _mT(C))
    N = eye + J2 @ C1
    A1T = _mT(A1)
    rhs = eta2 + _mv(J2, b1)
    eta = _mv(A1T, torch.linalg.solve(N, rhs[..., None])[..., 0]) + eta1
    J = A1T @ torch.linalg.solve(N, J2 @ A1) + J1
    J = 0.5 * (J + _mT(J))
    return _Elem(A, b, C, eta, J)


def _interleave(a, b):
    """a[0], b[0], a[1], b[1], ... along the leading axis (len(a) is len(b)
    or len(b) + 1)."""
    out = a.new_empty((a.shape[0] + b.shape[0],) + a.shape[1:])
    out[0::2] = a
    out[1::2] = b
    return out


def associative_scan(fn, elems: _Elem) -> _Elem:
    """Inclusive scan of ``fn`` along the leading axis, combining in the
    order of ``jax.lax.associative_scan``."""
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(_Elem(*(e[0:-1:2] for e in elems)),
                 _Elem(*(e[1::2] for e in elems)))
    odd = associative_scan(fn, reduced)
    if n % 2 == 0:
        even = fn(_Elem(*(e[:-1] for e in odd)),
                  _Elem(*(e[2::2] for e in elems)))
    else:
        even = fn(odd, _Elem(*(e[2::2] for e in elems)))
    even = _Elem(*(torch.cat([e[:1], r]) for e, r in zip(elems, even)))
    return _Elem(*(_interleave(e, o) for e, o in zip(even, odd)))


def _eq_chol(Q):
    """(factor, scale) of the Jacobi-equilibrated Cholesky of (..., n, n)
    matrices; the factor is NaN where it fails."""
    d = torch.sqrt(torch.clamp(torch.diagonal(Q, dim1=-2, dim2=-1),
                               min=1e-30))
    return chol(Q / d[..., :, None] / d[..., None, :]), d


def _eq_solve(L, d, B):
    """Q⁻¹ B for (..., n, m) B from ``_eq_chol``'s (factor, scale)."""
    return cho_solve(L, B / d[..., :, None]) / d[..., :, None]


def _node_elements(derivs, fs_next, ureg):
    """The knots' elements (parallel_riccati.py:93-123) and whether a Luu
    factorization failed."""
    nu = derivs.Luu.shape[-1]
    Luu = derivs.Luu + ureg * torch.eye(nu, dtype=derivs.Luu.dtype,
                                        device=derivs.Luu.device)
    L, d = _eq_chol(Luu)
    failed = torch.isnan(L).any()
    LuuinvLxuT = _eq_solve(L, d, _mT(derivs.Lxu))
    LuuinvLu = _eq_solve(L, d, derivs.Lu[..., None])
    LuuinvFuT = _eq_solve(L, d, _mT(derivs.Fu))
    A = derivs.Fx - derivs.Fu @ LuuinvLxuT
    b = fs_next - (derivs.Fu @ LuuinvLu)[..., 0]
    C = derivs.Fu @ LuuinvFuT
    C = 0.5 * (C + _mT(C))
    eta = derivs.Lx - (derivs.Lxu @ LuuinvLu)[..., 0]
    J = derivs.Lxx - derivs.Lxu @ LuuinvLxuT
    J = 0.5 * (J + _mT(J))
    return _Elem(A, b, C, eta, J), failed


def backward_pass_parallel(derivs, dterm, fs, xreg, ureg):
    """The generic backward pass's drop-in for the non-box path
    (parallel_riccati.py:126-183): (Vx, Vxx, Qu, k, K, Quuk, failed) with
    the same meaning as ``fddp._backward_pass``'s."""
    dt, dev = fs.dtype, fs.device
    ndx = fs.shape[-1]
    xreg = torch.as_tensor(xreg, dtype=dt, device=dev)
    ureg = torch.as_tensor(ureg, dtype=dt, device=dev)
    eye = torch.eye(ndx, dtype=dt, device=dev)
    elems, failed0 = _node_elements(
        derivs.replace(Lxx=derivs.Lxx + xreg * eye), fs[1:], ureg)
    # the terminal element carries no gap of its own: each knot's gap enters
    # its predecessor's element as the drift b
    Vxx_T = dterm.Lxx + xreg * eye
    zero = fs.new_zeros((1, ndx, ndx))
    term = _Elem(A=zero, b=fs.new_zeros((1, ndx)), C=zero,
                 eta=dterm.Lx[None], J=Vxx_T[None])
    elems = _Elem(*(torch.cat([a, t]) for a, t in zip(elems, term)))
    # suffix products: reverse, inclusive scan, reverse
    suffix = associative_scan(_combine, _Elem(*(e.flip(0) for e in elems)))
    suffix = _Elem(*(e.flip(0) for e in suffix))
    Vxx = suffix.J                                     # (T+1, ndx, ndx)
    Vx = suffix.eta + _mv(Vxx, fs)                     # gap-inclusive
    S_next, s_next = Vxx[1:], Vx[1:]
    FuT = _mT(derivs.Fu)
    nu = derivs.Luu.shape[-1]
    Qu = derivs.Lu + _mv(FuT, s_next)
    Quu = (derivs.Luu + FuT @ S_next @ derivs.Fu
           + ureg * torch.eye(nu, dtype=dt, device=dev))
    Qxu = derivs.Lxu + _mT(derivs.Fx) @ S_next @ derivs.Fu
    L, d = _eq_chol(Quu)
    # raiseIfNaN (solver-base.cpp:175-178): NaN, inf or >= 1e30 fails
    failed = (failed0 | torch.isnan(L).any() | ~(Vx.abs().max() < 1e30)
              | ~(Vxx.abs().max() < 1e30))
    K = _eq_solve(L, d, _mT(Qxu))
    kvec = _eq_solve(L, d, Qu[..., None])[..., 0]
    Quuk = _mv(Quu, kvec)
    # row-major, as the sequential pass returns them (kernel 5 reads them)
    out = (Vx, Vxx, Qu, kvec, K, Quuk)
    return (*(a.contiguous() for a in out), failed)
