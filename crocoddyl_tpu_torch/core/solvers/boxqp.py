"""Projected-Newton box-constrained QP: min ½xᵀHx + qᵀx  s.t. lb ≤ x ≤ ub
(port of crocoddyl_tpu/core/solvers/boxqp.py; reference
src/core/solvers/box-qp.cpp:51-182).

The loop body mirrors the JAX one line by line, because its decisions follow
from that order: the free set from the gradient's sign at the bounds, the
Newton step on the free subspace through the full-size masked system
(F·H·F + diag(clamped))·dz = F·rhs, ten projected Armijo trials, and the
exit test.  The loop is JAX's ``while_loop`` on ``it < maxiter & ~done``
(boxqp.py:92) on the device (``control.while_loop``), with one shortcut
that gives the same x, sets, flags and count: an iteration that leaves x
unchanged jumps the count to maxiter.  A Cholesky failure is the same flag as in JAX: NaN in the factor
(``ops/smallchol.chol`` rebuilds it from ``torch.linalg.cholesky_ex``'s
``info``).
"""

from __future__ import annotations

import torch

from ...ops.smallchol import cho_solve, chol
from . import control
from ...utils.struct import PyTreeNode

class BoxQPSolution(PyTreeNode):
    """x, the free set, Hff⁻¹ scattered into the full (n, n) matrix with
    zeros on clamped rows and columns (the Quu_inv layout of
    box-ddp.cpp:60-66), the Cholesky failure flag and the iteration count
    (boxqp.py:22-36)."""

    x: torch.Tensor
    free: torch.Tensor
    Hff_inv: torch.Tensor
    failed: torch.Tensor
    iterations: torch.Tensor


def _masked_system(H, free, reg):
    Fo = free[:, None] & free[None, :]
    A = torch.where(Fo, H, torch.zeros_like(H))
    one = torch.ones_like(free, dtype=H.dtype)
    return A + torch.diag(torch.where(free, reg * one, one))


def _quad(H, q, x):
    return 0.5 * x @ (H @ x) + q @ x


def solve(H: torch.Tensor, q: torch.Tensor, lb: torch.Tensor,
          ub: torch.Tensor, xinit: torch.Tensor, maxiter: int = 100,
          th_acceptstep: float = 0.1, th_grad: float = 1e-9,
          reg: float = 0.0, n_alphas: int = 10) -> BoxQPSolution:
    """BoxQP solve (defaults per box-qp.hpp:92; boxqp.py:44-104)."""
    dt, dev = H.dtype, H.device
    n = H.shape[-1]
    alphas = torch.tensor([2.0 ** (-k) for k in range(n_alphas)], dtype=dt,
                          device=dev)
    x = torch.clamp(xinit, lb, ub)

    def sets(x):
        g = q + H @ x
        clamped = ((x == lb) & (g > 0)) | ((x == ub) & (g < 0))
        return g, ~clamped

    def body(c):
        x, it, done, failed = c
        g, free = sets(x)
        conv = (g.abs().max() <= th_grad) | ~free.any()
        L = chol(_masked_system(H, free, reg))
        failed = failed | torch.isnan(L).any()
        rhs = torch.where(free, -(q + H @ torch.where(free,
                                                      torch.zeros_like(x), x)),
                          torch.zeros_like(x))
        dz = cho_solve(L, rhs)
        dx = torch.where(free, dz - x, torch.zeros_like(x))
        fold = _quad(H, q, x)
        # the ten trials as rows
        xnews = torch.clamp(x + alphas[:, None] * dx, lb, ub)
        fnew = 0.5 * ((xnews @ H.T) * xnews).sum(-1) + xnews @ q
        ok = fold - fnew > th_acceptstep * ((x - xnews) @ g)
        first = control.pick(xnews, torch.argmax(ok.to(torch.int32)))
        xnew = torch.where(conv, x, torch.where(ok.any(), first, x))
        done = conv | failed
        # the body is a function of x alone while the loop runs: an
        # iteration that leaves x as it was repeats itself up to maxiter (no
        # exit test passes: one clamped and one free coordinate keep max|g|
        # above th_grad), so the count jumps there and the loop ends
        fixed = ~done & (xnew == x).all()
        it = torch.where(fixed, torch.full_like(it, maxiter), it + 1)
        return xnew, it, done, failed

    zero = torch.zeros((), dtype=torch.bool, device=dev)
    x, it, _, failed = control.while_loop(
        lambda c: (c[1] < maxiter) & ~c[2], body,
        (x, torch.zeros((), dtype=torch.int32, device=dev), zero,
         zero.clone()))

    # final sets and the free-block inverse for the caller (BoxDDP gains)
    _, free = sets(x)
    L = chol(_masked_system(H, free, reg))
    failed = failed | torch.isnan(L).any()
    Ainv = cho_solve(L, torch.eye(n, dtype=dt, device=dev))
    Hff_inv = torch.where(free[:, None] & free[None, :], Ainv,
                          torch.zeros_like(Ainv))
    return BoxQPSolution(x=x, free=free, Hff_inv=Hff_inv, failed=failed,
                         iterations=it)
