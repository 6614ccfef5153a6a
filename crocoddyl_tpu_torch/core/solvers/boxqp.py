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
    Fo = free[..., :, None] & free[..., None, :]
    A = torch.where(Fo, H, torch.zeros_like(H))
    one = torch.ones_like(free, dtype=H.dtype)
    return A + torch.diag_embed(torch.where(free, reg * one, one))


def _dot(a, b):
    return a @ b if a.dim() == 1 else (a[..., None, :] @ b[..., :, None])[
        ..., 0, 0]


def _quad(H, q, x):
    return 0.5 * _dot(x, control.mv(H, x)) + _dot(q, x)


def solve(H: torch.Tensor, q: torch.Tensor, lb: torch.Tensor,
          ub: torch.Tensor, xinit: torch.Tensor, maxiter: int = 100,
          th_acceptstep: float = 0.1, th_grad: float = 1e-9,
          reg: float = 0.0, n_alphas: int = 10,
          active=None) -> BoxQPSolution:
    """BoxQP solve (defaults per box-qp.hpp:92; boxqp.py:44-104).  With a
    leading batch axis on every input (H (B, n, n), the others (B, n)), B
    QPs at once: one loop whose QPs stop at their own iterations
    (``control.while_loop``'s batched rule); ``active`` (B,) marks the QPs
    to solve, the others start done and their outputs are not to be
    read."""
    dt, dev = H.dtype, H.device
    n, nb = H.shape[-1], H.dim() - 2
    alphas = torch.tensor([2.0 ** (-k) for k in range(n_alphas)], dtype=dt,
                          device=dev)
    x = torch.clamp(xinit, lb, ub)

    def sets(x):
        g = q + control.mv(H, x)
        clamped = ((x == lb) & (g > 0)) | ((x == ub) & (g < 0))
        return g, ~clamped

    def body(c):
        x, it, done, failed = c
        g, free = sets(x)
        conv = ((control.per_problem(g.abs(), nb, "max") <= th_grad)
                | ~free.any(-1))
        L = chol(_masked_system(H, free, reg))
        failed = failed | control.per_problem(torch.isnan(L), nb, "any")
        rhs = torch.where(free, -(q + control.mv(H, torch.where(
            free, torch.zeros_like(x), x))), torch.zeros_like(x))
        dz = cho_solve(L, rhs)
        dx = torch.where(free, dz - x, torch.zeros_like(x))
        fold = _quad(H, q, x)
        # the ten trials as rows
        xnews = torch.clamp(x[..., None, :] + alphas[:, None]
                            * dx[..., None, :], lb[..., None, :],
                            ub[..., None, :])
        fnew = 0.5 * ((xnews @ H.mT) * xnews).sum(-1) + control.mv(xnews, q)
        ok = fold[..., None] - fnew > th_acceptstep * control.mv(
            x[..., None, :] - xnews, g)
        first = control.pick(xnews, torch.argmax(ok.to(torch.int32), -1))
        step = control.lanes(ok.any(-1), x)
        xnew = torch.where(control.lanes(conv, x), x,
                           torch.where(step, first, x))
        done = conv | failed
        # the body is a function of x alone while the loop runs: an
        # iteration that leaves x as it was repeats itself up to maxiter (no
        # exit test passes: one clamped and one free coordinate keep max|g|
        # above th_grad), so the count jumps there and the loop ends
        fixed = ~done & (xnew == x).all(-1)
        it = torch.where(fixed, torch.full_like(it, maxiter), it + 1)
        return xnew, it, done, failed

    bs = H.shape[:nb]
    zero = torch.zeros(bs, dtype=torch.bool, device=dev)
    x, it, _, failed = control.while_loop(
        lambda c: (c[1] < maxiter) & ~c[2], body,
        (x, torch.zeros(bs, dtype=torch.int32, device=dev),
         zero if active is None else ~active, zero.clone()))

    # final sets and the free-block inverse for the caller (BoxDDP gains)
    _, free = sets(x)
    L = chol(_masked_system(H, free, reg))
    failed = failed | control.per_problem(torch.isnan(L), nb, "any")
    Ainv = cho_solve(L, torch.eye(n, dtype=dt, device=dev).expand(L.shape))
    Hff_inv = torch.where(free[..., :, None] & free[..., None, :], Ainv,
                          torch.zeros_like(Ainv))
    return BoxQPSolution(x=x, free=free, Hff_inv=Hff_inv, failed=failed,
                         iterations=it)
