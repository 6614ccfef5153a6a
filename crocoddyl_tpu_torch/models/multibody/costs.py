"""Residual cost containers (port of the seven costs of
crocoddyl_tpu/models/multibody/costs.py that the node kernel admits).

Each cost holds its references, an activation, a weight and a 0/1 active
flag.  Residuals, Jacobians and the Gauss-Newton assembly are computed by
the node linearization (ops/fused_node.py), so the classes carry data only.
"""

from __future__ import annotations

import torch

from ...utils.struct import PyTreeNode, field
from .activations import Activation
from .frames import FrictionCone


class Cost(PyTreeNode):
    activation: Activation
    weight: torch.Tensor
    active: torch.Tensor  # 0/1


class CostState(Cost):
    """r = x ⊖ xref."""
    xref: torch.Tensor = None


class CostControl(Cost):
    """r = u − uref."""
    uref: torch.Tensor = None


class CostCoM(Cost):
    """r = com(q) − cref."""
    cref: torch.Tensor = None


class CostFrameTranslation(Cost):
    """r = p_frame − pref."""
    fid: int = field(static=True, default=0)
    pref: torch.Tensor = None


class CostFrameVelocity(Cost):
    """r = v_frame (local) − vref."""
    fid: int = field(static=True, default=0)
    vref: torch.Tensor = None


class CostContactForce(Cost):
    """r = λ_contact − fref."""
    contact_idx: int = field(static=True, default=0)
    fref: torch.Tensor = None


class CostContactFrictionCone(Cost):
    """r = A_cone · f_lin (barrier activation)."""
    contact_idx: int = field(static=True, default=0)
    cone: FrictionCone = None


def cost_nr(cost: Cost, ndx: int) -> int:
    """Static residual size of a cost item."""
    if isinstance(cost, CostState):
        return ndx
    if isinstance(cost, CostControl):
        return cost.uref.shape[-1]
    if isinstance(cost, (CostCoM, CostFrameTranslation)):
        return 3
    if isinstance(cost, CostFrameVelocity):
        return 6
    if isinstance(cost, CostContactForce):
        return cost.fref.shape[-1]
    if isinstance(cost, CostContactFrictionCone):
        return cost.cone.A.shape[-2]
    raise NotImplementedError(type(cost))
