"""Per-node derivative block and knot stacking (port of
crocoddyl_tpu/core/action.py: NodeDerivs, stack_models, replicate_model).

A length-T problem is one model dataclass whose tensor leaves carry a
leading T axis (per-knot parameters).
"""

from __future__ import annotations

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


def stack_models(models):
    """Stack same-structure models into one with a leading T axis."""
    return tree_map(lambda *leaves: torch.stack(leaves), *models)


def replicate_model(model, T: int):
    """Broadcast one model's parameters to a leading T axis."""
    return tree_map(lambda leaf: leaf.expand((T,) + leaf.shape).clone(),
                    model)
