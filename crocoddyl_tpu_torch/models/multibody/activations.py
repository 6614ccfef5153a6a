"""Activation models r ↦ (a, Ar, Arr_diag) and the bounds helper (port of
crocoddyl_tpu/models/multibody/activations.py: the four activations the
node kernel admits, ``ActivationSmoothAbs`` and ``make_bounds``).  The
factor ½ multiplies the residual before the sum: a 0-d float32 value
times a Python float gets a float64 tangent under ``torch.func.jvp``
(PyTorch 2.13), and the generic node differentiates through these."""

from __future__ import annotations

import numpy as np
import torch

from ...utils.struct import PyTreeNode


class Activation(PyTreeNode):
    def calc(self, r):
        """Return (a_value, Ar, Arr_diag) for a residual r (..., nr)."""
        raise NotImplementedError


class ActivationQuad(Activation):
    """a = ½‖r‖²."""

    def calc(self, r):
        return (0.5 * r * r).sum(-1), r, torch.ones_like(r)


class ActivationWeightedQuad(Activation):
    """a = ½ rᵀW r, W diagonal."""

    weights: torch.Tensor

    def calc(self, r):
        wr = self.weights * r
        return (0.5 * r * wr).sum(-1), wr, self.weights.expand_as(r)


class ActivationSmoothAbs(Activation):
    """a = Σ √(r²+1)."""

    def calc(self, r):
        s = torch.sqrt(r * r + 1.0)
        return s.sum(-1), r / s, 1.0 / (s * s * s)


def make_bounds(lb, ub, beta: float = 1.0):
    """Barrier bounds pulled toward their centre by ``beta``
    (activations.py:48-59); an infinite bound stays infinite."""
    lb, ub = (b if isinstance(b, torch.Tensor)
              else torch.as_tensor(np.asarray(b, np.float64))
              for b in (lb, ub))
    m, d = 0.5 * (lb + ub), 0.5 * (ub - lb)
    finite = torch.isfinite(lb) & torch.isfinite(ub)
    return (torch.where(finite, m - beta * d, lb),
            torch.where(finite, m + beta * d, ub))


class ActivationQuadraticBarrier(Activation):
    """a = ½‖(r−ub)⁺‖² + ½‖(r−lb)⁻‖²."""

    lb: torch.Tensor
    ub: torch.Tensor

    def calc(self, r):
        rlb = torch.clamp(r - self.lb, max=0.0)
        rub = torch.clamp(r - self.ub, min=0.0)
        a = (0.5 * rlb * rlb).sum(-1) + (0.5 * rub * rub).sum(-1)
        active = ((r - self.lb) <= 0.0) | ((r - self.ub) >= 0.0)
        return a, rlb + rub, active.to(r.dtype)


class ActivationWeightedQuadraticBarrier(Activation):
    """Barrier with per-component weights."""

    lb: torch.Tensor
    ub: torch.Tensor
    weights: torch.Tensor

    def calc(self, r):
        rb = (torch.clamp(r - self.lb, max=0.0)
              + torch.clamp(r - self.ub, min=0.0))
        wrb = self.weights * rb
        active = ((r - self.lb) <= 0.0) | ((r - self.ub) >= 0.0)
        return ((0.5 * rb * wrb).sum(-1), wrb,
                self.weights * active.to(r.dtype))
