"""Actuation models u ↦ τ(x, u) (port of
crocoddyl_tpu/models/multibody/actuations.py: the base, ``FullActuation``
and ``FloatingBaseActuation``).

A model defines ``nu`` and ``calc``; a user subclass needs nothing more:
the generic node takes its Jacobians with ``torch.func.jacfwd``, as the JAX
node takes them with ``jax.jacfwd``.  The two built-in actuations, the
ones the node kernel admits, are constant linear maps and also give that
map, ``dtau_du``, to the kernel's lane code.
"""

from __future__ import annotations

import torch

from ...utils.struct import PyTreeNode, field


class Actuation(PyTreeNode):
    nv: int = field(static=True)

    @property
    def nu(self) -> int:
        raise NotImplementedError

    def calc(self, x, u):
        """Return τ (nv,)."""
        raise NotImplementedError


class FullActuation(Actuation):
    """τ = u."""

    @property
    def nu(self) -> int:
        return self.nv

    def calc(self, x, u):
        return u

    def dtau_du(self, like):
        return torch.eye(self.nv, dtype=like.dtype, device=like.device)


class FloatingBaseActuation(Actuation):
    """τ = [0₆; u] — underactuated free-flyer base."""

    @property
    def nu(self) -> int:
        return self.nv - 6

    def calc(self, x, u):
        return torch.cat([torch.zeros(u.shape[:-1] + (6,), dtype=u.dtype,
                                      device=u.device), u], dim=-1)

    def dtau_du(self, like):
        """The constant [0; I] map."""
        return torch.cat([
            torch.zeros((6, self.nu), dtype=like.dtype, device=like.device),
            torch.eye(self.nu, dtype=like.dtype, device=like.device)])
