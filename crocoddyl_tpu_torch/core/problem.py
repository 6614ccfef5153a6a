"""Shooting problem container (port of crocoddyl_tpu/core/problem.py).

The running horizon is one model dataclass whose tensor leaves carry a
leading knot axis, or a tuple of such segments: heterogeneous node types
(the rigid-body knots and the true impulse switch knots of a gait) are
consecutive segments, which share the state and nu.  Segments of one
structure (type, static fields and leaf structure, as JAX's
``jax.tree.structure`` key) form a group, and a group is evaluated as ONE
block over its concatenated knots (problem.py:65-119).

Each block and the terminal model are dispatched by their structure, as
the JAX ``calc_diff_full`` does (problem.py:142-188): a ``RigidBodyNode``
block whose structure the node kernel admits (``ops/fused_node.supports``)
is evaluated through the lane functions and linearized by the node kernel
(one launch per block); any other block (a generic ``RigidBodyNode``, an
``ImpulseNode``, another ``ActionModel``) by its own ``calc`` and
derivatives, per knot under ``torch.func.vmap``.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ..utils.struct import PyTreeNode, tree_flatten, tree_leaves, tree_map


def _lane_node(model) -> bool:
    """True for a node the lane functions and the node kernel evaluate."""
    from ..ops import fused_node
    return fused_node.supports(model)


def _seg_len(model) -> int:
    return tree_leaves(model)[0].shape[0]


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
    running: Any           # one stacked segment, or a tuple of segments
    terminal: Any

    @property
    def segments(self):
        return (self.running if isinstance(self.running, tuple)
                else (self.running,))

    @property
    def seg_lengths(self):
        return tuple(_seg_len(s) for s in self.segments)

    @property
    def T(self) -> int:
        return sum(self.seg_lengths)

    @property
    def state(self):
        return self.terminal.state

    @property
    def nu(self) -> int:
        return self.segments[0].nu

    @property
    def on_lanes(self) -> bool:
        """True iff the problem is one segment and both stacks go through
        the lane functions and the node kernel."""
        return (len(self.segments) == 1 and _lane_node(self.segments[0])
                and _lane_node(self.terminal))

    def _seg_slices(self):
        """[(first knot, end knot)] of each segment."""
        out, i = [], 0
        for n in self.seg_lengths:
            out.append((i, i + n))
            i += n
        return out

    @functools.cached_property
    def _seg_groups(self):
        """Segment indices grouped by structure (type, static fields and
        leaf structure), in order of first appearance (problem.py:65-78)."""
        keys, groups = [], []
        for si, seg in enumerate(self.segments):
            key = (type(seg), tree_flatten(seg)[1])
            for k, g in zip(keys, groups):
                if k == key:
                    g.append(si)
                    break
            else:
                keys.append(key)
                groups.append([si])
        return groups

    @functools.cached_property
    def _blocks(self):
        """[(block model, knot indices (K,) or None)] per group: a group of
        several segments is one model over its concatenated knots (built
        once per problem object, so the node kernel's descriptor is built
        once too), with the knots' indices in the horizon; a problem of
        one group takes its knots in order (None)."""
        segs, slices = self.segments, self._seg_slices()
        groups = self._seg_groups
        out = []
        for idxs in groups:
            block = (segs[idxs[0]] if len(idxs) == 1 else tree_map(
                lambda *ls: torch.cat(ls), *[segs[si] for si in idxs]))
            rows = None
            if len(groups) > 1:
                rows = torch.cat([torch.arange(*slices[si])
                                  for si in idxs]).to(self.x0.device)
            out.append((block, rows))
        return out

    @functools.cached_property
    def _time_order(self):
        """The permutation that puts the concatenated block outputs back in
        time order (None for one group)."""
        if len(self._blocks) == 1:
            return None
        return torch.argsort(torch.cat([r for _, r in self._blocks]))

    def _grouped_apply(self, block_fn, xs, us):
        """``block_fn(block, xs_rows, us_rows)`` on every group's block at
        its knots' rows of xs (T, nx) and us (T, nu), outputs (pytrees with
        a leading knot axis) put back in time order (problem.py:80-119)."""
        outs = []
        for block, rows in self._blocks:
            if rows is None:
                outs.append(block_fn(block, xs, us))
            else:
                outs.append(block_fn(block, xs.index_select(0, rows),
                                     us.index_select(0, rows)))
        if self._time_order is None:
            return outs[0]
        order = self._time_order
        return tree_map(lambda *ls: torch.cat(ls).index_select(0, order),
                        *outs)

    @functools.cached_property
    def knots(self):
        """The T running knots and the terminal node as a dt=0 knot, stacked
        (T+1, ...), for a one-segment problem: the nodes of one node-kernel
        launch (problem.py:171-184 convention).  Built once per problem
        object, so the kernel descriptor of ops/cuda_kernels.py is built
        once too."""
        return tree_map(lambda r, t: torch.cat([r, t]), self.segments[0],
                        self.terminal_knot)

    @functools.cached_property
    def terminal_knot(self):
        """The terminal node as one dt=0 knot (leaves (1, ...))."""
        knot = tree_map(lambda l: l[None], self.terminal)
        return knot.replace(dt=torch.zeros_like(knot.dt))

    @functools.cached_property
    def _knot_list(self):
        """The T running knots of every segment in time order for the
        sequential rollouts, sliced once: (True, a one-knot stack (leaves
        (1, ...))) for a lane segment, (False, a single model) otherwise."""
        out = []
        for seg in self.segments:
            lanes = _lane_node(seg)
            for t in range(_seg_len(seg)):
                out.append((lanes, tree_map(lambda l: l[t:t + 1], seg)
                            if lanes else tree_map(lambda l: l[t], seg)))
        return out

    def knot_calc(self, t: int, xs: torch.Tensor, us: torch.Tensor):
        """(xnext (N, nx), cost (N,)) of running knot t at the rows of xs
        (N, nx), us (N, nu) (``node_calc`` of that knot)."""
        lanes, knot = self._knot_list[t]
        if lanes:
            return node_calc(knot, xs, us)
        if xs.shape[0] == 1:
            xn, c = knot.calc(xs[0], us[0])
            return xn[None], c[None]
        return torch.func.vmap(knot.calc)(xs, us)

    def calc(self, xs: torch.Tensor, us: torch.Tensor):
        """(xnexts (T, nx), costs (T+1,)) at the trajectory, costs[T] the
        terminal cost (problem.py:121-131)."""
        xn, c = self._grouped_apply(node_calc, xs[:self.T], us)
        return xn, torch.cat([c, terminal_calc(self.terminal, xs[-1:])])

    def calc_diff(self, xs: torch.Tensor, us: torch.Tensor):
        """(derivs stacked over T, terminal derivs) (problem.py:133-140)."""
        return self.calc_diff_full(xs, us)[:2]

    def calc_diff_full(self, xs: torch.Tensor, us: torch.Tensor):
        """(derivs (T, ...), dterm, xnexts (T, nx), costs (T+1,)) at the
        trajectory xs (T+1, nx), us (T, nu), each block by its structure
        (problem.py:142-188).  A one-segment problem whose stacks are both
        lane nodes: the T running knots and the dt=0 terminal knot in ONE
        node linearization of T+1 nodes (``ops/fused_node.calc_both_lanes``:
        the node kernel on CUDA tensors).  Otherwise a lane block is one
        linearization of its knots, any other one each knot's
        ``calc_both`` under ``torch.func.vmap``; a lane terminal is one dt=0
        knot, any other one the model's ``calc_diff_terminal`` and
        ``calc_terminal``.  A lane terminal's Lu, Lxu and Luu are zeroed
        (problem.py:181-183).  Leaves are contiguous."""
        T = self.T
        if self.on_lanes:
            u_all = torch.cat([us, us.new_zeros((1, us.shape[1]))])
            d, xnext_n, costs = self._lanes(self.knots, xs, u_all)
            derivs = tree_map(lambda a: a[:T], d)
            return (derivs, self._lane_terminal(tree_map(lambda a: a[T], d)),
                    xnext_n[:T], costs)

        def block(seg, x, u):
            if _lane_node(seg):
                return self._lanes(seg, x, u)
            d, xn, c = torch.func.vmap(
                lambda m, xx, uu: m.calc_both(xx, uu))(seg, x, u)
            return tree_map(torch.Tensor.contiguous, d), xn, c
        derivs, xnexts, costs = self._grouped_apply(block, xs[:T], us)
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
        """Sequential open-loop rollout from x0 through every segment
        (problem.py:190-201): (T+1, nx)."""
        xs = [self.x0]
        for t in range(self.T):
            xs.append(self.knot_calc(t, xs[-1][None], us[t:t + 1])[0][0])
        return torch.stack(xs)

    def quasi_static(self, xs: torch.Tensor) -> torch.Tensor:
        """Quasi-static controls at each running knot (problem.py:205-209),
        one knot at a time (an impulse knot's are zero)."""
        out = []
        for seg in self.segments:
            for t in range(_seg_len(seg)):
                out.append(tree_map(lambda l: l[t], seg)
                           .quasi_static(xs[len(out)]))
        return torch.stack(out)
