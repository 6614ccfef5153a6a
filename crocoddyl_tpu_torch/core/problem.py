"""Shooting problem container for one segment (port of part of
crocoddyl_tpu/core/problem.py).

The running horizon is ONE model dataclass whose tensor leaves carry a
leading T axis; the terminal model is a single node.
"""

from __future__ import annotations

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

    def quasi_static(self, xs: torch.Tensor) -> torch.Tensor:
        """Quasi-static controls at each running knot (problem.py:205-209),
        one knot at a time."""
        return torch.stack([
            tree_map(lambda l: l[t], self.running).quasi_static(xs[t])
            for t in range(self.T)])
