"""Shooting problem container for one segment (port of part of
crocoddyl_tpu/core/problem.py).

The running horizon is ONE model dataclass whose tensor leaves carry a
leading T axis; the terminal model is a single node.
"""

from __future__ import annotations

import functools
from typing import Any

import torch

from ..utils.struct import PyTreeNode, tree_leaves, tree_map


class ShootingProblem(PyTreeNode):
    x0: torch.Tensor
    running: Any           # one stacked segment
    terminal: Any

    @property
    def segments(self):
        return (self.running,)

    @property
    def T(self) -> int:
        return tree_leaves(self.running)[0].shape[0]

    @property
    def state(self):
        return self.terminal.state

    @property
    def nu(self) -> int:
        return self.running.nu

    @functools.cached_property
    def knots(self):
        """The T running knots and the terminal node as a dt=0 knot, stacked
        (T+1, ...): the nodes of one node-kernel launch (problem.py:171-184
        convention).  Built once per problem object, so the kernel
        descriptor of ops/cuda_kernels.py is built once too."""
        term = self.terminal.replace(dt=torch.zeros_like(self.terminal.dt))
        return tree_map(lambda r, t: torch.cat([r, t[None]]), self.running,
                        term)

    def calc_diff_full(self, xs: torch.Tensor, us: torch.Tensor):
        """(derivs (T, ...), dterm, xnexts (T, nx), costs (T+1,)) at the
        trajectory xs (T+1, nx), us (T, nu) (problem.py:143-188): the T
        running knots and the dt=0 terminal knot in ONE node linearization
        of T+1 nodes (``ops/fused_node.calc_both_lanes``: the node kernel on
        CUDA tensors).  The terminal's Lu, Lxu and Luu are zeroed
        (problem.py:181-183).  Leaves are contiguous."""
        from ..ops.fused_node import calc_both_lanes
        T = self.T
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

    def quasi_static(self, xs: torch.Tensor) -> torch.Tensor:
        """Quasi-static controls at each running knot (problem.py:205-209),
        one knot at a time."""
        return torch.stack([
            tree_map(lambda l: l[t], self.running).quasi_static(xs[t])
            for t in range(self.T)])
