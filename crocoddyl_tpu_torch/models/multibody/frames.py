"""Linearized friction cone and CoP support region (port of
crocoddyl_tpu/models/multibody/frames.py: ``FrictionCone``,
``friction_cone``, ``CoPSupport`` and ``cop_support``)."""

from __future__ import annotations

import numpy as np
import torch

from ...utils.struct import PyTreeNode


def _rot_from_two_vectors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Rotation matrix sending a → b (numpy, build-time)."""
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    v = np.cross(a, b)
    c = float(a @ b)
    if np.linalg.norm(v) < 1e-12:
        if c > 0:
            return np.eye(3)
        axis = np.array([1.0, 0.0, 0.0])
        if abs(a[0]) > 0.9:
            axis = np.array([0.0, 1.0, 0.0])
        v = np.cross(a, axis)
        v /= np.linalg.norm(v)
        K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
        return np.eye(3) + 2.0 * K @ K
    K = np.array([[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]])
    return np.eye(3) + K + K @ K * (1.0 / (1.0 + c))


class FrictionCone(PyTreeNode):
    """Linearized friction cone: lb ≤ A·f ≤ ub."""

    A: torch.Tensor    # (nf+1, 3)
    lb: torch.Tensor   # (nf+1,)
    ub: torch.Tensor   # (nf+1,)

    @property
    def nr(self) -> int:
        return self.A.shape[-2]


def friction_cone(normal=(0.0, 0.0, 1.0), mu: float = 0.7, nf: int = 4,
                  inner_appr: bool = True, min_nforce: float = 0.0,
                  max_nforce: float = np.inf) -> FrictionCone:
    normal = np.asarray(normal, np.float64)
    normal = normal / np.linalg.norm(normal)
    theta = 2.0 * np.pi / nf
    mu_eff = mu * np.cos(theta / 2.0) if inner_appr else mu
    c_R_o = _rot_from_two_vectors(normal, np.array([0.0, 0.0, 1.0]))
    A = np.zeros((nf + 1, 3))
    lb = np.zeros((nf + 1,))
    ub = np.zeros((nf + 1,))
    for i in range(nf // 2):
        t_i = theta * i
        tsurf = np.array([np.cos(t_i), np.sin(t_i), 0.0])
        A[2 * i] = (-mu_eff * np.array([0.0, 0.0, 1.0]) + tsurf) @ c_R_o
        A[2 * i + 1] = (-mu_eff * np.array([0.0, 0.0, 1.0]) - tsurf) @ c_R_o
        lb[2 * i] = lb[2 * i + 1] = -np.inf
        ub[2 * i] = ub[2 * i + 1] = 0.0
    A[nf] = normal
    lb[nf] = min_nforce
    ub[nf] = max_nforce
    return FrictionCone(A=torch.tensor(A), lb=torch.tensor(lb),
                        ub=torch.tensor(ub))


class CoPSupport(PyTreeNode):
    """A·f ≥ 0 keeps the centre of pressure of a 6D contact wrench f
    inside the (length × width) support rectangle of the sole."""

    A: torch.Tensor  # (4, 6)


def cop_support(length: float, width: float) -> CoPSupport:
    """The support rectangle's four rows over f = [f_lin; τ]
    (frames.py:84-91)."""
    A = np.array([
        [0, 0, length / 2.0, 0, -1, 0],
        [0, 0, length / 2.0, 0, 1, 0],
        [0, 0, width / 2.0, 1, 0, 0],
        [0, 0, width / 2.0, -1, 0, 0],
    ], np.float64)
    return CoPSupport(A=torch.tensor(A))
