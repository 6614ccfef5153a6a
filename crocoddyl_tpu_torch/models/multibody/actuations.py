"""Actuation models u ↦ τ(x, u) (port of
crocoddyl_tpu/models/multibody/actuations.py: the base, ``FullActuation``,
``FloatingBaseActuation``, ``MultiCopterBaseActuation``,
``SmoothSatSquashing`` and ``SquashingActuation``).

A model defines ``nu`` and ``calc``; a user subclass needs nothing more:
the generic node takes its Jacobians with ``torch.func.jacfwd``, as the JAX
node takes them with ``jax.jacfwd``.  The two built-in actuations, the
ones the node kernel admits, are constant linear maps and also give that
map, ``dtau_du``, to the kernel's lane code; the multicopter and squashing
actuations take the generic node's ``jacfwd``.
"""

from __future__ import annotations

import torch

from ...dynamics import lie
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


class MultiCopterBaseActuation(Actuation):
    """τ = [tau_f·u_rotors; u_joints]: the rotors' thrusts mapped to a base
    wrench by the (6, n_rotors) ``tau_f``, the joints driven directly."""

    tau_f: torch.Tensor

    @property
    def n_rotors(self) -> int:
        return self.tau_f.shape[-1]

    @property
    def nu(self) -> int:
        return self.n_rotors + (self.nv - 6)

    def calc(self, x, u):
        n = self.n_rotors
        return torch.cat([lie.mv(self.tau_f, u[..., :n]), u[..., n:]], dim=-1)


class SmoothSatSquashing(PyTreeNode):
    """s(u) = ½(lb + ub + √(a + (u−lb)²) − √(a + (u−ub)²)), a = (smooth·(ub
    − lb))²: a smooth saturation of u into [s_lb, s_ub]."""

    s_lb: torch.Tensor
    s_ub: torch.Tensor
    smooth: torch.Tensor   # the smoothing factor (0.1 by default upstream)

    def calc(self, u):
        d = self.smooth * (self.s_ub - self.s_lb)
        a = d * d
        return 0.5 * (self.s_lb + self.s_ub
                      + torch.sqrt(a + (u - self.s_lb) ** 2)
                      - torch.sqrt(a + (u - self.s_ub) ** 2))


class SquashingActuation(Actuation):
    """τ = actuation(x, squashing(u))."""

    actuation: Actuation
    squashing: SmoothSatSquashing

    @property
    def nu(self) -> int:
        return self.actuation.nu

    def calc(self, x, u):
        return self.actuation.calc(x, self.squashing.calc(u))
