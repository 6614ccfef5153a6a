"""Rigid-body OCP node (port of the Euler path of
crocoddyl_tpu/models/multibody/nodes.py): {free | contact} forward dynamics
+ cost sum + semi-implicit Euler, with the dt=0 terminal / pseudo-impulse
semantics.

``calc`` and ``calc_both`` evaluate one node through the lane functions of
ops/fused_node.py (N = 1); the solver calls those lane functions directly
over all nodes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...dynamics import algorithms as algo
from ...dynamics.states import StateMultibody
from ...utils.struct import PyTreeNode, field, tree_map
from .actuations import Actuation
from .contacts import ContactSet


class CostStack(PyTreeNode):
    """Weighted sum of residual costs."""

    items: Tuple = field(default_factory=tuple)


class RigidBodyNode(PyTreeNode):
    """Fused {free|contact} dynamics + costs + Euler node."""

    state_: StateMultibody
    actuation: Actuation
    costs: CostStack
    contacts: Optional[ContactSet] = None
    dt: torch.Tensor = None
    armature: Optional[torch.Tensor] = None
    kkt_damping: float = field(static=True, default=0.0)
    integrator: str = field(static=True, default="euler")

    @property
    def state(self) -> StateMultibody:
        return self.state_

    @property
    def nu(self) -> int:
        return self.actuation.nu

    def _lanes(self, x, u):
        from ...ops import fused_node
        one = tree_map(lambda l: l[None], self)
        return fused_node, one, x[:, None], u[:, None]

    def calc(self, x, u):
        """(xnext, cost) of one node."""
        fn, one, xl, ul = self._lanes(x, u)
        xn, c = fn.lane_calc_primal(fn.lane_params(one, 1), xl, ul)
        return xn[:, 0], c[0]

    def calc_terminal(self, x):
        """Terminal cost at x: the cost rate at u = 0, undiscounted
        (nodes.py:201-205).  Evaluated as the lane primal of this node as
        a dt=0 knot, as the solvers evaluate the terminal trial cost."""
        term = self.replace(dt=torch.zeros_like(self.dt))
        fn, one, xl, ul = term._lanes(x, x.new_zeros(self.nu))
        return fn.lane_calc_primal(fn.lane_params(one, 1), xl, ul)[1][0]

    def calc_both(self, x, u):
        """(NodeDerivs, xnext, cost) of one node."""
        fn, one, xl, ul = self._lanes(x, u)
        d, xn, c = fn.calc_both_lanes(one, xl, ul)
        return tree_map(lambda a: a[..., 0], d), xn[:, 0], c[0]

    def quasi_static(self, x):
        """Torques balancing gravity and contacts at rest: least-squares
        τ(u) = b(q, 0) (nodes.py:452-490).  The actuation Jacobian is the
        constant map of the actuation model."""
        st = self.state_
        m = st.model
        q = x[:st.nq]
        v0 = torch.zeros(st.nv, dtype=x.dtype, device=x.device)
        b = algo.rnea(m, q, v0, v0)
        dtau_du = self.actuation.dtau_du(x)

        def ls_solve(A, rhs):
            eps = 1e-9 if A.dtype == torch.float64 else 1e-5
            wide = A.shape[0] < A.shape[1]
            G = A @ A.T if wide else A.T @ A
            lam = eps * (torch.trace(G) / G.shape[0] + 1.0)
            L = torch.linalg.cholesky(
                G + lam * torch.eye(G.shape[0], dtype=A.dtype,
                                    device=A.device))
            if wide:
                return A.T @ torch.cholesky_solve(rhs[:, None], L)[:, 0]
            return torch.cholesky_solve((A.T @ rhs)[:, None], L)[:, 0]

        if self.contacts is not None and self.contacts.contacts:
            kin = algo.KinCache(m, q, v0)
            Jc, _, _ = self.contacts.calc(kin)
            A = torch.cat([dtau_du, Jc.T], dim=1)
            return ls_solve(A, b)[:self.nu]
        return ls_solve(dtau_du, b)
