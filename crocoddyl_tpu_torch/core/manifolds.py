"""State-manifold base class (port of crocoddyl_tpu/core/manifolds.py).

A state defines ``diff`` (x1 ⊖ x0) and ``integrate`` (x ⊕ dx) in tangent
coordinates.  The JAX base class also derives Jacobians by AD; the port's
main path takes its derivatives from the node kernel and does not need them.
"""

from __future__ import annotations

from ..utils.struct import PyTreeNode


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
