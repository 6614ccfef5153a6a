"""Cholesky factor and solve of small matrices with NaN-on-failure
semantics (port of the part of crocoddyl_tpu/ops/smallchol.py that the
generic backward pass and the generic node use: ``chol``, ``cho_solve``
and ``pd_solve``).

The JAX version unrolls the factorization so that a pivot that is not
positive turns into NaN through the square root, and the solvers read a
failure as "a NaN in the factor".  ``torch.linalg.cholesky_ex`` reports the
same failure (a pivot that is not positive, or NaN) through ``info``
instead and leaves a partial factor behind, so :func:`chol` rebuilds the
JAX signal from ``info``: a failed factor is all NaN, and every solve with
it gives NaN.
"""

from __future__ import annotations

import torch


def chol(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (..., n, n) matrices; all NaN where the
    matrix is not positive definite (smallchol.py:30-49)."""
    L, info = torch.linalg.cholesky_ex(M)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")), L)


def cho_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A⁻¹ b from the lower Cholesky factor L of A, for b (..., n) or
    (..., n, m) (smallchol.py:93-95)."""
    if b.dim() == L.dim() - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def pd_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """M⁻¹ b for positive-definite M (smallchol.py:97-99)."""
    return cho_solve(chol(M), b)
