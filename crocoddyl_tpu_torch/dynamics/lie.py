"""SO(3)/SE(3) Lie-group operations (port of crocoddyl_tpu/dynamics/lie.py).

Conventions: quaternions stored (x, y, z, w); spatial motions ordered
[linear; angular]; M ⊕ v = M·exp6(v) with v in the body frame.  Taylor
branches are selected with ``torch.where`` on a masked argument, as in the
JAX module.
"""

from __future__ import annotations

import torch

_EPS2 = 1e-14   # θ² threshold for Taylor branches


def mm(A, B):
    """Batched matmul (..., m, k) @ (..., k, n) as broadcast-multiply-reduce."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def mv(A, x):
    """Batched matvec (..., m, k) x (..., k) -> (..., m)."""
    return (A * x[..., None, :]).sum(-1)


def mtv(A, x):
    """Batched matvec with the transpose: Aᵀ x."""
    return (A * x[..., :, None]).sum(-2)


def cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1),
    ], dim=-2)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _theta(w):
    """(theta2, theta_safe, small): θ²; θ masked to 1 where small."""
    theta2 = (w * w).sum(-1)
    small = theta2 < _EPS2
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    return theta2, torch.sqrt(t2_safe), small


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def rot_to_quat(R):
    """Rotation matrix → quaternion (x, y, z, w), w >= 0 (Shepperd)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    q0 = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                      R[..., 0, 2] - R[..., 2, 0],
                      R[..., 1, 0] - R[..., 0, 1],
                      1.0 + tr], -1)
    q1 = torch.stack([1.0 + R[..., 0, 0] - R[..., 1, 1] - R[..., 2, 2],
                      R[..., 0, 1] + R[..., 1, 0],
                      R[..., 0, 2] + R[..., 2, 0],
                      R[..., 2, 1] - R[..., 1, 2]], -1)
    q2 = torch.stack([R[..., 0, 1] + R[..., 1, 0],
                      1.0 - R[..., 0, 0] + R[..., 1, 1] - R[..., 2, 2],
                      R[..., 1, 2] + R[..., 2, 1],
                      R[..., 0, 2] - R[..., 2, 0]], -1)
    q3 = torch.stack([R[..., 0, 2] + R[..., 2, 0],
                      R[..., 1, 2] + R[..., 2, 1],
                      1.0 - R[..., 0, 0] - R[..., 1, 1] + R[..., 2, 2],
                      R[..., 1, 0] - R[..., 0, 1]], -1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)         # (..., 4, 4)
    norms2 = (cands * cands).sum(-1)
    idx = torch.argmax(norms2, dim=-1)
    sel = torch.take_along_dim(
        cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = sel / torch.linalg.norm(sel, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_log(q):
    """Rotation vector of unit quaternion q (principal branch)."""
    vec, w = q[..., :3], q[..., 3]
    sgn = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    vec, w = vec * sgn[..., None], w * sgn
    n2 = (vec * vec).sum(-1)
    small = n2 < _EPS2
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / w - 2.0 * n2 / (3.0 * w ** 3), angle / n)
    return vec * scale[..., None]


# ---------------------------------------------------------------------------
# SO(3)
# ---------------------------------------------------------------------------

def exp3(w):
    """Rotation matrix exp([w]×) (Rodrigues, Taylor-safe)."""
    theta2, theta, small = _theta(w)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.where(small, torch.ones_like(theta2), theta2))
    W = skew(w)
    return _eye3(w) + s[..., None, None] * W + c[..., None, None] * mm(W, W)


def log3(R):
    return quat_log(rot_to_quat(R))


# ---------------------------------------------------------------------------
# SE(3): elements as (R (3,3), p (3,)); tangent [v_lin; w_ang] (body frame)
# ---------------------------------------------------------------------------

def se3_v_matrix(w):
    """V(w) with exp6([v;w]) translation part = V(w)·v."""
    theta2, theta, small = _theta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1 - torch.cos(theta)) / t2)
    c2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (t2 * theta))
    W = skew(w)
    return _eye3(w) + c1[..., None, None] * W + c2[..., None, None] * mm(W, W)


def se3_v_inv(w):
    theta2, theta, small = _theta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2 - (1.0 + torch.cos(theta))
                    / (2.0 * theta * torch.sin(theta)))
    W = skew(w)
    return _eye3(w) - 0.5 * W + c[..., None, None] * mm(W, W)


def exp6(xi):
    """SE(3) exponential of [v; w] → (R, p)."""
    v, w = xi[..., :3], xi[..., 3:]
    return exp3(w), mv(se3_v_matrix(w), v)


def log6(R, p):
    """[v; w] = log of SE(3) element (R, p)."""
    w = log3(R)
    v = mv(se3_v_inv(w), p)
    return torch.cat([v, w], dim=-1)
