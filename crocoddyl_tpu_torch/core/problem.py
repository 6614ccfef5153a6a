"""Shooting problem container for one segment (port of
crocoddyl_tpu/core/problem.py).

The running horizon is ONE model dataclass whose tensor leaves carry a
leading T axis; the terminal model is a single node.  Each of the two
stacks is dispatched by its structure, as the JAX ``calc_diff_full`` does
(problem.py:143-188): a ``RigidBodyNode`` stack whose structure the node
kernel admits (``ops/fused_node.supports``) is evaluated through the lane
functions and linearized by the node kernel; any other stack (a generic
``RigidBodyNode`` or another ``ActionModel``) by its own ``calc`` and
derivatives, per knot under ``torch.func.vmap``.  A tuple of segments
(``running`` a tuple) is held, so that ``segments`` shows it and the
solvers can refuse it; the methods below read one segment.
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
    """(xnext (N, nx), cost (N,)) of the K-knot stack ``seg`` at the rows
    of xs (N, nx), us (N, nu): for a lane node one plain lane primal
    (``ops/fused_node.lane_calc_primal``) of N = K·A nodes, node n at knot
    n // A; otherwise (N = K) each knot's own ``calc`` under
    ``torch.func.vmap``."""
    from ..ops import fused_node as fn
    if _lane_node(seg):
        xn, c = fn.lane_calc_primal(fn.lane_params(seg, xs.shape[0]), xs.T,
                                    us.T)
        return xn.T, c
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
        """True iff both stacks go through the lane functions and the node
        kernel."""
        return _lane_node(self.running) and _lane_node(self.terminal)

    @functools.cached_property
    def knots(self):
        """The T running knots and the terminal node as a dt=0 knot, stacked
        (T+1, ...): the nodes of one node-kernel launch (problem.py:171-184
        convention).  Built once per problem object, so the kernel
        descriptor of ops/cuda_kernels.py is built once too."""
        return tree_map(lambda r, t: torch.cat([r, t]), self.running,
                        self.terminal_knot)

    @functools.cached_property
    def terminal_knot(self):
        """The terminal node as one dt=0 knot (leaves (1, ...))."""
        knot = tree_map(lambda l: l[None], self.terminal)
        return knot.replace(dt=torch.zeros_like(knot.dt))

    @functools.cached_property
    def _knot_list(self):
        """The T running knots for the sequential rollouts, sliced once: a
        one-knot stack each (leaves (1, ...)) for a lane stack, a single
        model each otherwise."""
        if _lane_node(self.running):
            return True, [tree_map(lambda l: l[t:t + 1], self.running)
                          for t in range(self.T)]
        return False, [tree_map(lambda l: l[t], self.running)
                       for t in range(self.T)]

    def knot_calc(self, t: int, xs: torch.Tensor, us: torch.Tensor):
        """(xnext (N, nx), cost (N,)) of running knot t at the rows of xs
        (N, nx), us (N, nu) (``node_calc`` of that knot)."""
        lanes, knots = self._knot_list
        if lanes:
            return node_calc(knots[t], xs, us)
        if xs.shape[0] == 1:
            xn, c = knots[t].calc(xs[0], us[0])
            return xn[None], c[None]
        return torch.func.vmap(knots[t].calc)(xs, us)

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
        trajectory xs (T+1, nx), us (T, nu), each stack by its structure
        (problem.py:142-188).  Both stacks lane nodes: the T running knots
        and the dt=0 terminal knot in ONE node linearization of T+1 nodes
        (``ops/fused_node.calc_both_lanes``: the node kernel on CUDA
        tensors).  Otherwise a lane running stack is one linearization of
        its T knots, any other one each knot's ``calc_both`` under
        ``torch.func.vmap``; a lane terminal is one dt=0 knot, any other
        one the model's ``calc_diff_terminal`` and ``calc_terminal``.  A
        lane terminal's Lu, Lxu and Luu are zeroed (problem.py:181-183).
        Leaves are contiguous."""
        T = self.T
        if self.on_lanes:
            u_all = torch.cat([us, us.new_zeros((1, us.shape[1]))])
            d, xnext_n, costs = self._lanes(self.knots, xs, u_all)
            derivs = tree_map(lambda a: a[:T], d)
            return (derivs, self._lane_terminal(tree_map(lambda a: a[T], d)),
                    xnext_n[:T], costs)
        if _lane_node(self.running):
            derivs, xnexts, costs = self._lanes(self.running, xs[:T], us)
        else:
            derivs, xnexts, costs = torch.func.vmap(
                lambda m, x, u: m.calc_both(x, u))(self.running, xs[:T], us)
            derivs = tree_map(torch.Tensor.contiguous, derivs)
        term = self.terminal
        if _lane_node(term):
            d1, _, cterm = self._lanes(self.terminal_knot, xs[-1:],
                                       xs.new_zeros((1, self.nu)))
            dterm = self._lane_terminal(tree_map(lambda a: a[0], d1))
        else:
            dterm = term.calc_diff_terminal(xs[-1])
            cterm = term.calc_terminal(xs[-1])[None]
        return derivs, dterm, xnexts, torch.cat([costs, cterm])

    @staticmethod
    def _lanes(seg, xs, us):
        """One node linearization of the knots of ``seg`` at the rows of
        xs, us: (derivs with a leading knot axis, xnext rows, costs)."""
        from ..ops.fused_node import calc_both_lanes
        derivs_n, xnext_n, cost_n = calc_both_lanes(
            seg, xs.T.contiguous(), us.T.contiguous())
        return (tree_map(lambda a: a.movedim(-1, 0).contiguous(), derivs_n),
                xnext_n.T, cost_n)

    @staticmethod
    def _lane_terminal(d):
        """The terminal's derivatives from its dt=0 knot: Lu, Lxu and Luu
        zeroed, as ``calc_diff_terminal`` gives them."""
        return d.replace(Lu=torch.zeros_like(d.Lu),
                         Lxu=torch.zeros_like(d.Lxu),
                         Luu=torch.zeros_like(d.Luu))

    def rollout(self, us: torch.Tensor) -> torch.Tensor:
        """Sequential open-loop rollout from x0 (problem.py:190-201):
        (T+1, nx)."""
        xs = [self.x0]
        for t in range(self.T):
            xs.append(self.knot_calc(t, xs[-1][None], us[t:t + 1])[0][0])
        return torch.stack(xs)

    def quasi_static(self, xs: torch.Tensor) -> torch.Tensor:
        """Quasi-static controls at each running knot (problem.py:205-209),
        one knot at a time."""
        return torch.stack([
            tree_map(lambda l: l[t], self.running).quasi_static(xs[t])
            for t in range(self.T)])
