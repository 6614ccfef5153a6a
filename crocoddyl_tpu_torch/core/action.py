"""Action-model protocol, per-node derivative block and knot stacking
(port of crocoddyl_tpu/core/action.py: NodeDerivs, ActionModel,
stack_models, replicate_model).

A length-T problem is one model dataclass whose tensor leaves carry a
leading T axis (per-knot parameters).
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils.struct import PyTreeNode, tree_map


class NodeDerivs(PyTreeNode):
    """Per-node derivatives in tangent coordinates."""

    Fx: torch.Tensor   # (ndx, ndx)
    Fu: torch.Tensor   # (ndx, nu)
    Lx: torch.Tensor   # (ndx,)
    Lu: torch.Tensor   # (nu,)
    Lxx: torch.Tensor  # (ndx, ndx)
    Lxu: torch.Tensor  # (ndx, nu)
    Luu: torch.Tensor  # (nu, nu)


class ActionModel(PyTreeNode):
    """One discrete OCP node: xnext = f(x, u), cost = l(x, u)
    (action.py:45-110).  Subclasses give ``state``, ``nu`` and ``calc``;
    the derivatives default to AD in tangent coordinates."""

    @property
    def state(self):
        raise NotImplementedError

    @property
    def nu(self) -> int:
        raise NotImplementedError

    def calc(self, x: torch.Tensor,
             u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Return (xnext, cost)."""
        raise NotImplementedError

    def calc_terminal(self, x: torch.Tensor) -> torch.Tensor:
        """Terminal cost only (the reference calls calc with u = 0)."""
        return self.calc(x, x.new_zeros(self.nu))[1]

    def calc_diff(self, x: torch.Tensor, u: torch.Tensor) -> NodeDerivs:
        """Derivatives by forward- and reverse-mode AD (``torch.func``) of
        the node in tangent coordinates: f(x ⊕ dx, u + du) ⊖ f(x, u) and
        l(x ⊕ dx, u + du) at dx = du = 0."""
        from torch.func import grad, jacfwd
        st = self.state
        z_dx = x.new_zeros(st.ndx)
        z_du = x.new_zeros(self.nu)
        xnext0, _ = self.calc(x, u)

        def f_tan(dx, du):
            xn, _ = self.calc(st.integrate(x, dx), u + du)
            return st.diff(xnext0, xn)

        def l_tan(dx, du):
            return self.calc(st.integrate(x, dx), u + du)[1]

        return NodeDerivs(
            Fx=jacfwd(f_tan, 0)(z_dx, z_du), Fu=jacfwd(f_tan, 1)(z_dx, z_du),
            Lx=grad(l_tan, 0)(z_dx, z_du), Lu=grad(l_tan, 1)(z_dx, z_du),
            Lxx=jacfwd(grad(l_tan, 0), 0)(z_dx, z_du),
            Lxu=jacfwd(grad(l_tan, 0), 1)(z_dx, z_du),
            Luu=jacfwd(grad(l_tan, 1), 1)(z_dx, z_du))

    def calc_diff_terminal(self, x: torch.Tensor) -> NodeDerivs:
        return self.calc_diff(x, x.new_zeros(self.nu))

    def calc_both(self, x: torch.Tensor, u: torch.Tensor):
        """(NodeDerivs, xnext, cost): calc and calc_diff together."""
        xnext, cost = self.calc(x, u)
        return self.calc_diff(x, u), xnext, cost

    def quasi_static(self, x: torch.Tensor) -> torch.Tensor:
        """Control keeping the state steady; zero unless a model knows
        better."""
        return x.new_zeros(self.nu)


def stack_models(models):
    """Stack same-structure models into one with a leading T axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *models)


def replicate_model(model, T: int):
    """Broadcast one model's parameters to a leading T axis."""
    return tree_map(lambda leaf: leaf.expand((T,) + leaf.shape).clone(),
                    model)
