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

A batch of B problems of one structure (the problems ``jax.vmap`` sees) is
one ``ShootingProblem`` whose every leaf carries a leading problem axis:
x0 (B, nx), segment leaves (B, T_seg, ...), terminal leaves (B, ...)
(``batch`` is B).  Its blocks are evaluated as the B·K knots of their B
problems in a row: a lane block in one node-kernel launch over all of
them, any other block under one ``torch.func.vmap`` over its B·K rows.  A
lane node reads one robot for every knot, so a batch whose robot leaves
differ across its problems (a mass sweep) takes every block by the
generic path.
"""

from __future__ import annotations

from typing import Any

import torch

from ..utils.struct import (PyTreeNode, flat_spec, tree_flatten, tree_leaves,
                            tree_map, unflat_spec)
from .solvers import control


def _lane_node(model) -> bool:
    """True for a node the lane functions and the node kernel evaluate."""
    from ..ops import fused_node
    return fused_node.supports(model)


def _seg_len(model, lead=0) -> int:
    return tree_leaves(model)[0].shape[lead]


def _flat(tree):
    """A batch's (B, K, ...) leaves as (B·K, ...): the knots of B problems
    in a row."""
    return tree_map(lambda l: l.reshape((-1,) + l.shape[2:]), tree)


def _unflat(tree, B):
    return tree_map(lambda l: l.reshape((B, -1) + l.shape[1:]), tree)


def node_calc(seg, xs: torch.Tensor, us: torch.Tensor, knots=None,
              lanes=None):
    """(xnext (N, nx), cost (N,)) of the K-knot stack ``seg`` at the rows
    of xs (N, nx), us (N, nu), or of its knots lo:hi with ``knots`` =
    (lo, hi): for a lane node (or as ``lanes`` says) one plain lane primal
    (``ops/fused_node.calc_primal``) of N = K·A nodes, node n at knot
    n // A; otherwise (N = K) each knot's own ``calc`` under
    ``torch.func.vmap``."""
    from ..ops import fused_node as fn
    if _lane_node(seg) if lanes is None else lanes:
        xn, c = fn.calc_primal(seg, xs.T, us.T, *(knots or ()))
        return xn.T, c
    if knots is not None:
        seg = tree_map(lambda l: l[knots[0]:knots[1]], seg)
    return _rows(seg, "calc", True, xs, us)


# the methods at one point, by direct calls (no vmap)
_POINT = {"calc_one": "calc", "calc_terminal_one": "calc_terminal"}


def _rows_eager(model, method, batched, *args):
    if method == "calc_diff_terminal":
        def f(m, x):
            return m.calc_diff_terminal(x), m.calc_terminal(x)
        return torch.func.vmap(f)(model, *args) if batched else f(model,
                                                                  *args)
    if method in _POINT:
        return getattr(model, _POINT[method])(*args)

    def f(m, *a):
        return getattr(m, method)(*a)
    if batched:
        return torch.func.vmap(f)(model, *args)
    return torch.func.vmap(lambda *a: f(model, *a))(*args)


def _model_of(leaves, spec, knot):
    """The model of the flat leaves, or its knot ``knot`` if >= 0."""
    m = unflat_spec(leaves, spec)
    return m if knot < 0 else tree_map(lambda l: l[knot], m)


def _rows_op(leaves, spec, method, batched, args, knot):
    return list(tree_leaves(_rows_eager(_model_of(leaves, spec, knot),
                                        method, batched, *args)))


_rows_lib = torch.library.custom_op(
    "crocoddyl_tpu_torch::model_rows", _rows_op, mutates_args=(),
    schema="(Tensor[] leaves, str spec, str method, bool batched, "
           "Tensor[] args, int knot) -> Tensor[]")


@_rows_lib.register_fake
def _(leaves, spec, method, batched, args, knot):
    m = _model_of(leaves, spec, knot)
    x = args[0]
    e = x.new_empty
    if method == "calc_terminal_one":
        return [e(())]
    if method == "calc_one":
        return [e(x.shape), e(())]
    N = x.shape[0]
    if method == "calc_terminal":
        return [e(N)]
    if method == "calc":
        return [e(x.shape), e(N)]
    ndx, nu = m.state.ndx, m.nu
    if method == "calc_diff_terminal":
        return [e(ndx, ndx), e(ndx, nu), e(ndx), e(nu), e(ndx, ndx),
                e(ndx, nu), e(nu, nu), e(())]
    return [e(N, ndx, ndx), e(N, ndx, nu), e(N, ndx), e(N, nu),
            e(N, ndx, ndx), e(N, ndx, nu), e(N, nu, nu), e(x.shape), e(N)]


def _rows(model, method, batched, *args, knot=-1):
    """``model.<method>`` (``calc``, ``calc_terminal`` or ``calc_both``) at
    the rows of ``args`` under ``torch.func.vmap``, the model's leaves
    batched along the rows too with ``batched``; at one point ``args``
    ((nx,), (nu,)) by a direct call: ``calc_one``, ``calc_terminal_one``,
    and ``calc_diff_terminal``, the terminal's (derivatives, cost).  Under
    ``torch.export`` this is the op
    ``torch.ops.crocoddyl_tpu_torch.model_rows``, which runs the same
    calls: the exporter records it as one node (and traces neither
    ``torch.func`` transforms nor ``autograd.Function`` JVP rules inside a
    loop's body); there, with ``knot`` >= 0, of the stack's knot ``knot``,
    the stack's leaves the op's operands, so that a knot's slices are not
    constants of their own."""
    if not control.exporting():
        return _rows_eager(model, method, batched, *args)
    leaves, spec = flat_spec(model)
    out = torch.ops.crocoddyl_tpu_torch.model_rows(leaves, spec, method,
                                                   batched, list(args), knot)
    if method in ("calc_terminal", "calc_terminal_one"):
        return out[0]
    if method in ("calc", "calc_one"):
        return out[0], out[1]
    from .action import NodeDerivs
    if method == "calc_diff_terminal":
        return NodeDerivs(*out[:7]), out[7]
    return NodeDerivs(*out[:7]), out[7], out[8]


def terminal_calc(term, xs: torch.Tensor) -> torch.Tensor:
    """Terminal costs (A,) at the rows of xs (A, nx): a lane node as a dt=0
    knot through the lane primal, otherwise the model's ``calc_terminal``
    (under ``torch.func.vmap`` for several rows)."""
    if _lane_node(term):
        knot = tree_map(lambda l: l[None], term)
        knot = knot.replace(dt=torch.zeros_like(knot.dt))
        return node_calc(knot, xs, xs.new_zeros((xs.shape[0], term.nu)))[1]
    if xs.shape[0] == 1:
        return _rows(term, "calc_terminal_one", False, xs[0])[None]
    return _rows(term, "calc_terminal", False, xs)


class ShootingProblem(PyTreeNode):
    x0: torch.Tensor
    running: Any           # one stacked segment, or a tuple of segments
    terminal: Any

    @property
    def batch(self):
        """B for a batch of problems (x0 (B, nx)), None for one problem."""
        return self.x0.shape[0] if self.x0.dim() == 2 else None

    @property
    def segments(self):
        return (self.running if isinstance(self.running, tuple)
                else (self.running,))

    @property
    def seg_lengths(self):
        lead = 0 if self.batch is None else 1
        return tuple(_seg_len(s, lead) for s in self.segments)

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
        return (len(self.segments) == 1 and self._lane(self.segments[0])
                and self._lane(self.terminal))

    def _lane(self, model) -> bool:
        """True for a node of this problem that goes through the lane
        functions and the node kernel: a lane node, and in a batch one
        whose robot is the same in every problem."""
        return _lane_node(model) and self._robot_shared

    @control.cached_property
    def _robot_shared(self):
        """False for a batch whose lane nodes' robot leaves differ across
        its problems (read once per batch object)."""
        if self.batch is None:
            return True
        same = [(l == l[:1]).all() for m in (*self.segments, self.terminal)
                if _lane_node(m) for l in tree_leaves(m.state_.model)]
        return not same or bool(torch.stack(same).all())

    def _seg_slices(self):
        """[(first knot, end knot)] of each segment."""
        out, i = [], 0
        for n in self.seg_lengths:
            out.append((i, i + n))
            i += n
        return out

    @control.cached_property
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

    @control.cached_property
    def _blocks(self):
        """[(block model, knot indices (K,) or None)] per group: a group of
        several segments is one model over its concatenated knots (built
        once per problem object, so the node kernel's descriptor is built
        once too), with the knots' indices in the horizon; a problem of
        one group takes its knots in order (None).  In a batch the block
        holds the B·K knots of its B problems in a row."""
        segs, slices = self.segments, self._seg_slices()
        groups = self._seg_groups
        out = []
        ax = 0 if self.batch is None else 1
        for idxs in groups:
            block = (segs[idxs[0]] if len(idxs) == 1 else tree_map(
                lambda *ls: torch.cat(ls, ax), *[segs[si] for si in idxs]))
            if self.batch is not None:
                block = _flat(block)
            rows = None
            if len(groups) > 1:
                rows = torch.cat([torch.arange(*slices[si])
                                  for si in idxs]).to(self.x0.device)
            out.append((block, rows))
        return out

    @control.cached_property
    def _time_order(self):
        """The permutation that puts the concatenated block outputs back in
        time order (None for one group)."""
        if len(self._blocks) == 1:
            return None
        return torch.argsort(torch.cat([r for _, r in self._blocks]))

    def _grouped_apply(self, block_fn, xs, us):
        """``block_fn(block, xs_rows, us_rows)`` on every group's block at
        its knots' rows of xs (T, nx) and us (T, nu), outputs (pytrees with
        a leading knot axis) put back in time order (problem.py:80-119).
        In a batch xs (B, T, nx) and us (B, T, nu): the block's rows are
        its B·K knots in a row, and the outputs (B, T, ...)."""
        B, ax = self.batch, 0 if self.batch is None else 1
        outs = []
        for block, rows in self._blocks:
            x, u = xs, us
            if rows is not None:
                x, u = xs.index_select(ax, rows), us.index_select(ax, rows)
            if B is None:
                outs.append(block_fn(block, x, u))
            else:
                outs.append(_unflat(block_fn(block, x.flatten(0, 1),
                                             u.flatten(0, 1)), B))
        if self._time_order is None:
            return outs[0]
        order = self._time_order
        return tree_map(lambda *ls: torch.cat(ls, ax).index_select(ax, order),
                        *outs)

    @control.cached_property
    def knots(self):
        """The T running knots and the terminal node as a dt=0 knot, stacked
        (T+1, ...), for a one-segment problem: the nodes of one node-kernel
        launch (problem.py:171-184 convention).  Built once per problem
        object, so the kernel descriptor of ops/cuda_kernels.py is built
        once too.  In a batch, the B·(T+1) knots of its problems in a
        row."""
        if self.batch is not None:
            return _flat(tree_map(lambda r, t: torch.cat([r, t[:, None]], 1),
                                  self.segments[0], self.terminal_knot))
        return tree_map(lambda r, t: torch.cat([r, t]), self.segments[0],
                        self.terminal_knot)

    @control.cached_property
    def terminal_knot(self):
        """The terminal node as one dt=0 knot (leaves (1, ...)); in a
        batch, its B problems' terminals as B knots (leaves (B, ...))."""
        knot = (self.terminal if self.batch is not None
                else tree_map(lambda l: l[None], self.terminal))
        return knot.replace(dt=torch.zeros_like(knot.dt))

    @control.cached_property
    def segment_knots(self):
        """The running knots of a one-segment batch, B·T in a row (what
        the single-problem rollout kernel reads per problem); the segment
        itself for one problem."""
        seg = self.segments[0]
        return seg if self.batch is None else _flat(seg)

    @control.cached_property
    def _knot_list(self):
        """The T running knots of every segment in time order for the
        sequential rollouts: (lanes, the segment, the knot's index in it,
        the knot as a single model, sliced once, or None for a lane
        segment and under export, where ``model_rows`` slices it).  In a
        batch the knot is its B problems' knots t (leaves (B, ...)), lane
        or not."""
        out = []
        for seg in self.segments:
            lanes = self._lane(seg)
            if self.batch is not None:
                out += [(lanes, seg, t, tree_map(lambda l: l[:, t], seg))
                        for t in range(_seg_len(seg, 1))]
                continue
            for t in range(_seg_len(seg)):
                out.append((lanes, seg, t, None if lanes or control.exporting()
                            else tree_map(lambda l: l[t], seg)))
        return out

    def knot_calc(self, t: int, xs: torch.Tensor, us: torch.Tensor):
        """(xnext (N, nx), cost (N,)) of running knot t at the rows of xs
        (N, nx), us (N, nu) (``node_calc`` of that knot); in a batch, row r
        belongs to problem r // (N / B)."""
        lanes, seg, i, knot = self._knot_list[t]
        if self.batch is not None:
            if lanes:
                return node_calc(knot, xs, us)
            return _rows(self._repeat(knot, xs), "calc", True, xs, us)
        if lanes:
            return node_calc(seg, xs, us, (i, i + 1))
        # under export the op slices the knot off its segment's leaves
        model, k = (seg, i) if control.exporting() else (knot, -1)
        if xs.shape[0] == 1:
            xn, c = _rows(model, "calc_one", False, xs[0], us[0], knot=k)
            return xn[None], c[None]
        return _rows(model, "calc", False, xs, us, knot=k)

    def _repeat(self, model, xs):
        """A batch's per-problem ``model`` (leaves (B, ...)) repeated to
        the N rows of xs, N / B rows a problem."""
        A = xs.shape[0] // self.batch
        return model if A == 1 else tree_map(
            lambda l: l.repeat_interleave(A, 0), model)

    def terminal_calc(self, xs: torch.Tensor) -> torch.Tensor:
        """Terminal costs (N,) at the rows of xs (N, nx) (``terminal_calc``
        of the terminal); in a batch, row r belongs to problem
        r // (N / B)."""
        if self.batch is None:
            return terminal_calc(self.terminal, xs)
        if self._lane(self.terminal):
            return node_calc(self.terminal_knot, xs,
                             xs.new_zeros((xs.shape[0], self.nu)))[1]
        return _rows(self._repeat(self.terminal, xs), "calc_terminal", True,
                     xs)

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
        (problem.py:181-183).  Leaves are contiguous.  In a batch, xs
        (B, T+1, nx) and us (B, T, nu), and every output carries the
        leading problem axis: one node-kernel launch over the batch's
        B·(T+1) knots where the problem is on the lanes."""
        T = self.T
        if self.batch is not None:
            return self._calc_diff_batch(xs, us)
        if self.on_lanes:
            u_all = torch.cat([us, us.new_zeros((1, us.shape[1]))])
            d, xnext_n, costs = self._lanes(self.knots, xs, u_all)
            derivs = tree_map(lambda a: a[:T], d)
            return (derivs, self._lane_terminal(tree_map(lambda a: a[T], d)),
                    xnext_n[:T], costs)
        derivs, xnexts, costs = self._grouped_apply(self._block, xs[:T], us)
        term = self.terminal
        if _lane_node(term):
            d1, _, cterm = self._lanes(self.terminal_knot, xs[-1:],
                                       xs.new_zeros((1, self.nu)))
            dterm = self._lane_terminal(tree_map(lambda a: a[0], d1))
        else:
            dterm, cterm = _rows(term, "calc_diff_terminal", False, xs[-1])
            cterm = cterm[None]
        return derivs, dterm, xnexts, torch.cat([costs, cterm])

    def _block(self, seg, x, u):
        """(derivs, xnext, cost) of a block's knots at the rows x, u."""
        if self._lane(seg):
            return self._lanes(seg, x, u)
        d, xn, c = _rows(seg, "calc_both", True, x, u)
        return tree_map(torch.Tensor.contiguous, d), xn, c

    def _calc_diff_batch(self, xs, us):
        """``calc_diff_full`` of a batch: every output (B, ...)."""
        T, B = self.T, self.batch
        if self.on_lanes:
            u_all = torch.cat([us, us.new_zeros((B, 1, us.shape[-1]))], 1)
            d, xnext_n, costs = _unflat(self._lanes(
                self.knots, xs.flatten(0, 1), u_all.flatten(0, 1)), B)
            derivs = tree_map(lambda a: a[:, :T].contiguous(), d)
            return (derivs, self._lane_terminal(tree_map(
                lambda a: a[:, T].contiguous(), d)), xnext_n[:, :T], costs)
        derivs, xnexts, costs = self._grouped_apply(self._block, xs[:, :T],
                                                    us)
        if self._lane(self.terminal):
            dterm, _, cterm = self._lanes(self.terminal_knot, xs[:, -1],
                                          xs.new_zeros((B, self.nu)))
            dterm = self._lane_terminal(dterm)
        else:
            dterm, cterm = _rows(self.terminal, "calc_diff_terminal", True,
                                 xs[:, -1])
        return derivs, dterm, xnexts, torch.cat([costs, cterm[:, None]], 1)

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
