"""State manifolds: the base class and the Euclidean state (port of
crocoddyl_tpu/core/manifolds.py).

A state defines ``diff`` (x1 ⊖ x0) and ``integrate`` (x ⊕ dx) in tangent
coordinates.  The JAX base class also derives Jacobians by AD; the port's
solvers take node derivatives in tangent coordinates from the node kernel or
the models and do not need them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.struct import PyTreeNode, field


class StateBase(PyTreeNode):
    @property
    def nx(self) -> int:
        raise NotImplementedError

    @property
    def ndx(self) -> int:
        raise NotImplementedError

    def diff(self, x0, x1):
        """Tangent vector from x0 to x1 (x1 ⊖ x0)."""
        raise NotImplementedError

    def integrate(self, x, dx):
        """Retraction x ⊕ dx."""
        raise NotImplementedError


class StateVector(StateBase):
    """Euclidean state in R^nx (manifolds.py:73-98; reference
    core/states/euclidean.hpp)."""

    nx_: int = field(static=True)
    lb: Optional[torch.Tensor] = None
    ub: Optional[torch.Tensor] = None

    @property
    def nx(self) -> int:
        return self.nx_

    @property
    def ndx(self) -> int:
        return self.nx_

    def zero(self, dtype=torch.float64, device=None) -> torch.Tensor:
        return torch.zeros((self.nx_,), dtype=dtype, device=device)

    def rand(self, generator: torch.Generator,
             dtype=torch.float64) -> torch.Tensor:
        """Uniform in [-1, 1)^nx from ``generator``."""
        return 2.0 * torch.rand((self.nx_,), generator=generator,
                                dtype=dtype) - 1.0

    def diff(self, x0, x1):
        return x1 - x0

    def integrate(self, x, dx):
        return x + dx


def state_vector(nx: int) -> StateVector:
    return StateVector(nx_=nx)
