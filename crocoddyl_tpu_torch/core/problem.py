"""Shooting problem container for one segment (port of
crocoddyl_tpu/core/problem.py).

The running horizon is ONE model dataclass whose tensor leaves carry a
leading T axis; the terminal model is a single node.  A node is either a
``RigidBodyNode`` whose structure the node kernel admits
(``ops/fused_node.supports``), evaluated through the lane functions and
linearized by the node kernel, or an ``ActionModel`` with its own ``calc``
and derivatives, evaluated per knot under ``torch.func.vmap``.  A tuple of
segments (``running`` a tuple) is held, so that ``segments`` shows it and
the solvers can refuse it; the methods below read one segment.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ..utils.struct import PyTreeNode, tree_leaves, tree_map


def _lane_node(model) -> bool:
    """True for a node the lane functions and the node kernel evaluate."""
    from ..ops import fused_node
    return fused_node.supports(model)


def node_calc(seg, xs: torch.Tensor, us: torch.Tensor):
    """(xnext (N, nx), cost (N,)) of N = K·A nodes of the K-knot stack
    ``seg``, node n at knot n // A, at the rows of xs (N, nx), us (N, nu):
    one plain lane primal (``ops/fused_node.lane_calc_primal``) for a lane
    node, the model's own ``calc`` under ``torch.func.vmap`` otherwise (a
    single node by the model directly)."""
    from ..ops import fused_node as fn
    K, N = tree_leaves(seg)[0].shape[0], xs.shape[0]
    if _lane_node(seg):
        xn, c = fn.lane_calc_primal(fn.lane_params(seg, N), xs.T, us.T)
        return xn.T, c
    if K == 1:
        m = tree_map(lambda l: l[0], seg)
        if N == 1:
            xn, c = m.calc(xs[0], us[0])
            return xn[None], c[None]
        return torch.func.vmap(m.calc)(xs, us)
    if K != N:
        idx = torch.arange(N, device=xs.device) // (N // K)
        seg = tree_map(lambda l: l.index_select(0, idx), seg)
    return torch.func.vmap(lambda m, x, u: m.calc(x, u))(seg, xs, us)


def terminal_calc(term, xs: torch.Tensor) -> torch.Tensor:
    """Terminal costs (A,) at the rows of xs (A, nx): a lane node as a dt=0
    knot through the lane primal, otherwise the model's ``calc_terminal``
    (under ``torch.func.vmap`` for several rows)."""
    if _lane_node(term):
        knot = tree_map(lambda l: l[None], term)
        knot = knot.replace(dt=torch.zeros_like(knot.dt))
        return node_calc(knot, xs, xs.new_zeros((xs.shape[0], term.nu)))[1]
    if xs.shape[0] == 1:
        return term.calc_terminal(xs[0])[None]
    return torch.func.vmap(term.calc_terminal)(xs)


class ShootingProblem(PyTreeNode):
    x0: torch.Tensor
    running: Any           # one stacked segment (a tuple: several)
    terminal: Any

    @property
    def segments(self):
        return (self.running if isinstance(self.running, tuple)
                else (self.running,))

    @property
    def T(self) -> int:
        return tree_leaves(self.running)[0].shape[0]

    @property
    def state(self):
        return self.terminal.state

    @property
    def nu(self) -> int:
        return self.segments[0].nu

    @property
    def on_lanes(self) -> bool:
        """True iff every node goes through the lane functions and the node
        kernel; else the nodes are ``ActionModel``s."""
        return _lane_node(self.running) and _lane_node(self.terminal)

    @functools.cached_property
    def knots(self):
        """The T running knots and the terminal node as a dt=0 knot, stacked
        (T+1, ...): the nodes of one node-kernel launch (problem.py:171-184
        convention).  Built once per problem object, so the kernel
        descriptor of ops/cuda_kernels.py is built once too."""
        term = self.terminal.replace(dt=torch.zeros_like(self.terminal.dt))
        return tree_map(lambda r, t: torch.cat([r, t[None]]), self.running,
                        term)

    def calc(self, xs: torch.Tensor, us: torch.Tensor):
        """(xnexts (T, nx), costs (T+1,)) at the trajectory, costs[T] the
        terminal cost (problem.py:121-131)."""
        xn, c = node_calc(self.running, xs[:self.T], us)
        return xn, torch.cat([c, terminal_calc(self.terminal, xs[-1:])])

    def calc_diff(self, xs: torch.Tensor, us: torch.Tensor):
        """(derivs stacked over T, terminal derivs) (problem.py:133-140)."""
        return self.calc_diff_full(xs, us)[:2]

    def calc_diff_full(self, xs: torch.Tensor, us: torch.Tensor):
        """(derivs (T, ...), dterm, xnexts (T, nx), costs (T+1,)) at the
        trajectory xs (T+1, nx), us (T, nu), by node structure
        (problem.py:142-188).  Lane nodes: the T running knots and the dt=0
        terminal knot in ONE node linearization of T+1 nodes
        (``ops/fused_node.calc_both_lanes``: the node kernel on CUDA
        tensors), the terminal's Lu, Lxu and Luu zeroed
        (problem.py:181-183).  Other nodes: each model's ``calc_both`` over
        the stacked knots under ``torch.func.vmap``, and the terminal's
        ``calc_diff_terminal`` and ``calc_terminal``.  Leaves are
        contiguous."""
        T = self.T
        if not self.on_lanes:
            derivs, xnexts, costs = torch.func.vmap(
                lambda m, x, u: m.calc_both(x, u))(self.running, xs[:T], us)
            term = self.terminal
            cterm = term.calc_terminal(xs[-1])
            return (tree_map(torch.Tensor.contiguous, derivs),
                    term.calc_diff_terminal(xs[-1]), xnexts,
                    torch.cat([costs, cterm[None]]))
        from ..ops.fused_node import calc_both_lanes
        u_all = torch.cat([us, us.new_zeros((1, us.shape[1]))])
        derivs_n, xnext_n, cost_n = calc_both_lanes(
            self.knots, xs.T.contiguous(), u_all.T.contiguous())
        d = tree_map(lambda a: a.movedim(-1, 0).contiguous(), derivs_n)
        derivs = tree_map(lambda a: a[:T], d)
        dterm = tree_map(lambda a: a[T], d)
        dterm = dterm.replace(Lu=torch.zeros_like(dterm.Lu),
                              Lxu=torch.zeros_like(dterm.Lxu),
                              Luu=torch.zeros_like(dterm.Luu))
        return derivs, dterm, xnext_n.T[:T], cost_n

    def rollout(self, us: torch.Tensor) -> torch.Tensor:
        """Sequential open-loop rollout from x0 (problem.py:190-201):
        (T+1, nx)."""
        xs = [self.x0]
        for t in range(self.T):
            knot = tree_map(lambda l: l[t:t + 1], self.running)
            xs.append(node_calc(knot, xs[-1][None], us[t:t + 1])[0][0])
        return torch.stack(xs)

    def quasi_static(self, xs: torch.Tensor) -> torch.Tensor:
        """Quasi-static controls at each running knot (problem.py:205-209),
        one knot at a time."""
        return torch.stack([
            tree_map(lambda l: l[t], self.running).quasi_static(xs[t])
            for t in range(self.T)])
