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
    """Batched matmul (..., m, k) @ (..., k, n)."""
    return A @ B


def mv(A, x):
    """Batched matvec (..., m, k) x (..., k) -> (..., m)."""
    return (A @ x[..., None])[..., 0]


def mtv(A, x):
    """Batched matvec with the transpose: Aᵀ x."""
    return (x[..., None, :] @ A)[..., 0, :]


def cross(a, b):
    if a.shape != b.shape:
        a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([o, -z, y, z, o, -x, -y, x, o], dim=-1).unflatten(
        -1, (3, 3))


def unskew(m):
    return torch.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], dim=-1)


def _eye3(like):
    return torch.eye(3, dtype=like.dtype, device=like.device)


def _theta(w):
    """(theta2, theta_safe, small): θ²; θ masked to 1 where small; each
    with a trailing axis of one.  The coefficients stay off 0-d tensors:
    under ``torch.func.jvp`` a 0-d float32 tensor times a Python float gets
    a float64 tangent (PyTorch 2.13)."""
    theta2 = (w * w).sum(-1, keepdim=True)
    small = theta2 < _EPS2
    t2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    return theta2, torch.sqrt(t2_safe), small


# ---------------------------------------------------------------------------
# Quaternions (x, y, z, w)
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float64, device=None):
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quat_conj(q):
    return q * torch.tensor([-1.0, -1.0, -1.0, 1.0], dtype=q.dtype,
                            device=q.device)


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


# Shepperd's four candidate quaternions (each unnormalized) as one affine
# map of R's entries: cand = C @ vec(R) + d, rows (candidate, component)
_SHEPPERD_C = (
    # q0: (R21 − R12, R02 − R20, R10 − R01, 1 + tr)
    ((7, 1), (5, -1)), ((2, 1), (6, -1)), ((3, 1), (1, -1)),
    ((0, 1), (4, 1), (8, 1)),
    # q1: (1 + R00 − R11 − R22, R01 + R10, R02 + R20, R21 − R12)
    ((0, 1), (4, -1), (8, -1)), ((1, 1), (3, 1)), ((2, 1), (6, 1)),
    ((7, 1), (5, -1)),
    # q2: (R01 + R10, 1 − R00 + R11 − R22, R12 + R21, R02 − R20)
    ((1, 1), (3, 1)), ((0, -1), (4, 1), (8, -1)), ((5, 1), (7, 1)),
    ((2, 1), (6, -1)),
    # q3: (R02 + R20, R12 + R21, 1 − R00 − R11 + R22, R10 − R01)
    ((2, 1), (6, 1)), ((5, 1), (7, 1)), ((0, -1), (4, -1), (8, 1)),
    ((3, 1), (1, -1)))
_SHEPPERD_D = (0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0)
_SHEPPERD = {}


def _shepperd(like):
    key = (like.dtype, str(like.device))
    if key not in _SHEPPERD:
        C = torch.zeros((16, 9), dtype=like.dtype)
        for r, terms in enumerate(_SHEPPERD_C):
            for k, c in terms:
                C[r, k] = c
        _SHEPPERD[key] = (C.to(like.device), torch.tensor(
            _SHEPPERD_D, dtype=like.dtype).to(like.device))
    return _SHEPPERD[key]


def rot_to_quat(R):
    """Rotation matrix → quaternion (x, y, z, w), w >= 0 (Shepperd: of
    the four candidate forms, the one of largest norm)."""
    C, d = _shepperd(R)
    cands = ((R.flatten(-2) @ C.T) + d).unflatten(-1, (4, 4))
    idx = torch.argmax((cands * cands).sum(-1), dim=-1)
    sel = torch.take_along_dim(
        cands, idx[..., None, None].expand(*idx.shape, 1, 4), dim=-2)[..., 0, :]
    q = sel / torch.linalg.norm(sel, dim=-1, keepdim=True)
    return q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)


def quat_exp(w3):
    """Quaternion of the rotation exp3(w3)."""
    theta2, theta, small = _theta(w3)
    half = 0.5 * theta
    sinc_half = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    return torch.cat([w3 * sinc_half, w], dim=-1)


def quat_log(q):
    """Rotation vector of unit quaternion q (principal branch)."""
    vec, w = q[..., :3], q[..., 3:]        # scalars on a trailing axis
    sgn = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    vec, w = vec * sgn, w * sgn
    n2 = (vec * vec).sum(-1, keepdim=True)
    small = n2 < _EPS2
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / w - 2.0 * n2 / (3.0 * w ** 3), angle / n)
    return vec * scale


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
    return _eye3(w) + s[..., None] * W + c[..., None] * mm(W, W)


def log3(R):
    return quat_log(rot_to_quat(R))


def jac_so3_right(w):
    """Right Jacobian Jr of SO(3): exp(w + dw) ≈ exp(w)·exp(Jr·dw)."""
    theta2, theta, small = _theta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1 - torch.cos(theta)) / t2)
    c2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (t2 * theta))
    W = skew(w)
    return _eye3(w) - c1[..., None] * W + c2[..., None] * mm(W, W)


def jac_so3_right_inv(w):
    theta2, theta, small = _theta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2 - (1.0 + torch.cos(theta))
                    / (2.0 * theta * torch.sin(theta)))
    W = skew(w)
    return _eye3(w) + 0.5 * W + c[..., None] * mm(W, W)


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
    return _eye3(w) + c1[..., None] * W + c2[..., None] * mm(W, W)


def se3_v_inv(w):
    theta2, theta, small = _theta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2 - (1.0 + torch.cos(theta))
                    / (2.0 * theta * torch.sin(theta)))
    W = skew(w)
    return _eye3(w) - 0.5 * W + c[..., None] * mm(W, W)


def exp6(xi):
    """SE(3) exponential of [v; w] → (R, p)."""
    v, w = xi[..., :3], xi[..., 3:]
    return exp3(w), mv(se3_v_matrix(w), v)


def log6(R, p):
    """[v; w] = log of SE(3) element (R, p)."""
    w = log3(R)
    v = mv(se3_v_inv(w), p)
    return torch.cat([v, w], dim=-1)


# ---------------------------------------------------------------------------
# SE(3) Jacobians in closed form (lie.py:228-313): the free-flyer blocks of
# the state's jdiff / jintegrate and of the placement residuals
# ---------------------------------------------------------------------------

def se3_adjoint(R, p):
    """Ad(M) = [[R, [p]×R], [0, R]] on [linear; angular] motions."""
    pR = mm(skew(p), R)
    z = torch.zeros_like(R)
    return torch.cat([torch.cat([R, pR], dim=-1),
                      torch.cat([z, R], dim=-1)], dim=-2)


def _se3_Q_left(v, w):
    """Q block of the SE(3) left Jacobian (Barfoot, State Estimation for
    Robotics, eq. 7.86; tangent [ρ; φ] = our [v; w]), Taylor-safe."""
    theta2, theta, small = _theta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - sin_t) / (t2 * theta))
    m2 = torch.where(small, -1.0 / 24.0 + theta2 / 720.0,
                     (1.0 - 0.5 * theta2 - cos_t) / (t2 * t2))
    m3 = torch.where(small, -1.0 / 120.0 + theta2 / 5040.0,
                     (theta - sin_t - theta2 * theta / 6.0)
                     / (t2 * t2 * theta))
    V, W = skew(v), skew(w)
    WV, VW = mm(W, V), mm(V, W)
    WVW = mm(WV, W)
    WWV, VWW = mm(W, WV), mm(VW, W)
    WVWW = mm(WVW, W)
    WWVW = mm(W, WVW)
    return (0.5 * V
            + c1[..., None] * (WV + VW + WVW)
            - m2[..., None] * (WWV + VWW - 3.0 * WVW)
            - 0.5 * (m2 - 3.0 * m3)[..., None] * (WVWW + WWVW))


def jac_se3_left(xi):
    """SE(3) left Jacobian Jl6: exp6(ξ+δ) ≈ exp6(Jl6·δ)·exp6(ξ)."""
    v, w = xi[..., :3], xi[..., 3:]
    Jl = se3_v_matrix(w)
    Q = _se3_Q_left(v, w)
    z = torch.zeros_like(Jl)
    return torch.cat([torch.cat([Jl, Q], dim=-1),
                      torch.cat([z, Jl], dim=-1)], dim=-2)


def jac_se3_right(xi):
    """SE(3) right Jacobian Jr6(ξ) = Jl6(−ξ)."""
    return jac_se3_left(-xi)


def jac_se3_right_inv(xi):
    """Jr6(ξ)⁻¹ = [[Jr3⁻¹, −Jr3⁻¹·Q_r·Jr3⁻¹], [0, Jr3⁻¹]]: Jlog6 at
    exp6(ξ)."""
    v, w = xi[..., :3], xi[..., 3:]
    Jri = jac_so3_right_inv(w)
    QJ = mm(_se3_Q_left(-v, -w), Jri)
    z = torch.zeros_like(Jri)
    return torch.cat([torch.cat([Jri, -mm(Jri, QJ)], dim=-1),
                      torch.cat([z, Jri], dim=-1)], dim=-2)
