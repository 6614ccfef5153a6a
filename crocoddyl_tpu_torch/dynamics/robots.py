"""Robot models of the main path (port of part of
crocoddyl_tpu/dynamics/robots.py)."""

from __future__ import annotations

import os

import numpy as np
import torch

from .model import RobotModel


def anymal(dtype=torch.float64) -> RobotModel:
    """ANYmal B from the vendored URDF (assets/anymal_b.urdf) through the
    native C++ parser.  nq=19, nv=18."""
    from ..io.urdf import load_urdf
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return load_urdf(os.path.join(root, "assets", "anymal_b.urdf"),
                     floating_base=True, dtype=dtype)


def anymal_standing_q(model: RobotModel, dtype=torch.float64) -> torch.Tensor:
    """example-robot-data's ANYmal 'standing' configuration: base at
    z=0.4792, HAA ±0.1 outward, front legs (HFE, KFE)=(0.7, −1.0), hind legs
    (−0.7, 1.0); leg order LF, RF, LH, RH."""
    q = np.zeros(model.nq)
    q[2] = 0.4792
    q[6] = 1.0
    legs = {"LF": (-0.1, 0.7, -1.0), "RF": (0.1, 0.7, -1.0),
            "LH": (-0.1, -0.7, 1.0), "RH": (0.1, -0.7, 1.0)}
    for i, leg in enumerate(("LF", "RF", "LH", "RH")):
        q[7 + 3 * i: 10 + 3 * i] = legs[leg]
    return torch.tensor(q, dtype=dtype)
