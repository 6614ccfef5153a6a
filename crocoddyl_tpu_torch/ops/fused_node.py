"""Node linearization in node-last ("lane") layout — kernel 1 of the port.

Port of crocoddyl_tpu/ops/fused_node.py.  Every per-node quantity carries a
TRAILING node axis of size N; small matrix dimensions lead.  The lane math
below (``lmm``, ``lchol``, ``lane_kin``, ``lane_calc_both`` ...) is a direct
port of the JAX lane code on tensors; it is the plain version of the CUDA
kernel in ``csrc/node_kernel.cu``.

Entry point :func:`calc_both_lanes`: node parameters are NOT broadcast to
lane width.  A launch covers ``K`` knots × ``B`` problems, node n = k·B + b
(k-major), and node n reads knot ``n // B``'s parameters.  CPU tensors go
through the plain version, CUDA tensors through the kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.action import NodeDerivs
from ..dynamics import algorithms as algo
from ..dynamics.model import JointType
from ..utils.struct import flat_spec, tree_map, unflat_spec
from . import cuda_kernels as _ck


# ---------------------------------------------------------------------------
# Lane math: trailing node axis everywhere (fused_node.py:58-200)
# ---------------------------------------------------------------------------

def lmm(A, B):
    """(..., m, k, N) @ (..., k, n, N) -> (..., m, n, N)."""
    return (A[..., :, :, None, :] * B[..., None, :, :, :]).sum(-3)


def lmm_chunk(A, B, chunk=6):
    """Chunked contraction for larger k (same sums as the JAX lane code)."""
    k = A.shape[-2]
    if k <= chunk:
        return lmm(A, B)
    out = None
    for i in range(0, k, chunk):
        t = lmm(A[..., :, i:i + chunk, :], B[..., i:i + chunk, :, :])
        out = t if out is None else out + t
    return out


def lmv(A, x):
    """(..., m, k, N) @ (..., k, N) -> (..., m, N)."""
    return (A * x[..., None, :, :]).sum(-2)


def lmtv(A, x):
    """(..., k, m, N), (..., k, N) -> (..., m, N)  (Aᵀ x)."""
    return (A * x[..., :, None, :]).sum(-3)


def lT(A):
    return A.transpose(-3, -2)


def lcross(a, b):
    a0, a1, a2 = a[..., 0, :], a[..., 1, :], a[..., 2, :]
    b0, b1, b2 = b[..., 0, :], b[..., 1, :], b[..., 2, :]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-2)


def lskew(v):
    z = torch.zeros_like(v[..., 0, :])
    v0, v1, v2 = v[..., 0, :], v[..., 1, :], v[..., 2, :]
    r0 = torch.stack([z, -v2, v1], dim=-2)
    r1 = torch.stack([v2, z, -v0], dim=-2)
    r2 = torch.stack([-v1, v0, z], dim=-2)
    return torch.stack([r0, r1, r2], dim=-3)


def leye(n, like):
    """(n, n, N) identity stack broadcast over lanes."""
    eye = torch.eye(n, dtype=like.dtype, device=like.device)
    return eye[:, :, None].expand(n, n, like.shape[-1])


def _const(a, like):
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


lcat = torch.cat


class TL(NamedTuple):
    """Lane-layout spatial transform: R (..., 3, 3, N), p (..., 3, N)."""
    R: torch.Tensor
    p: torch.Tensor

    def compose(self, o: "TL") -> "TL":
        return TL(lmm(self.R, o.R), self.p + lmv(self.R, o.p))

    def inverse(self) -> "TL":
        RT = lT(self.R)
        return TL(RT, -lmv(RT, self.p))

    def act_motion(self, m):
        lin, ang = m[..., :3, :], m[..., 3:, :]
        Rl, Ra = lmv(self.R, lin), lmv(self.R, ang)
        return lcat([Rl + lcross(self.p, Ra), Ra], -2)

    def act_motion_inv(self, m):
        lin, ang = m[..., :3, :], m[..., 3:, :]
        a = lmtv(self.R, ang)
        l = lmtv(self.R, lin - lcross(self.p, ang))
        return lcat([l, a], -2)

    def act_force(self, f):
        lin, ang = f[..., :3, :], f[..., 3:, :]
        Rl, Ra = lmv(self.R, lin), lmv(self.R, ang)
        return lcat([Rl, Ra + lcross(self.p, Rl)], -2)

    def act_point(self, x):
        return self.p + lmv(self.R, x)


def lcross_motion(v, m):
    vl, w = v[..., :3, :], v[..., 3:, :]
    ml, ma = m[..., :3, :], m[..., 3:, :]
    return lcat([lcross(w, ml) + lcross(vl, ma), lcross(w, ma)], -2)


def lcross_force(v, f):
    vl, w = v[..., :3, :], v[..., 3:, :]
    fl, n = f[..., :3, :], f[..., 3:, :]
    return lcat([lcross(w, fl), lcross(w, n) + lcross(vl, fl)], -2)


def _z33(like):
    return torch.zeros_like(like)


def lCM(m):
    sl, sa = lskew(m[..., :3, :]), lskew(m[..., 3:, :])
    top = lcat([-sa, -sl], -2)
    bot = lcat([_z33(sl), -sa], -2)
    return lcat([top, bot], -3)


def lCF(h):
    sl, sn = lskew(h[..., :3, :]), lskew(h[..., 3:, :])
    top = lcat([_z33(sl), -sl], -2)
    bot = lcat([-sl, -sn], -2)
    return lcat([top, bot], -3)


def lAD(v):
    swl, sww = lskew(v[..., :3, :]), lskew(v[..., 3:, :])
    top = lcat([sww, swl], -2)
    bot = lcat([_z33(swl), sww], -2)
    return lcat([top, bot], -3)


def lADs(v):
    swl, sww = lskew(v[..., :3, :]), lskew(v[..., 3:, :])
    top = lcat([sww, _z33(swl)], -2)
    bot = lcat([swl, sww], -2)
    return lcat([top, bot], -3)


# ---------------------------------------------------------------------------
# Lane Lie-group ops (fused_node.py:207-412)
# ---------------------------------------------------------------------------

_EPS2 = 1e-14


def lquat_to_rot(q):
    x, y, z, w = (q[..., i, :] for i in range(4))
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -2)
    r1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -2)
    r2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -2)
    return torch.stack([r0, r1, r2], -3)


def lrot_to_quat(R):
    """Branchless Shepperd with the argmax as a where-chain."""
    tr = R[..., 0, 0, :] + R[..., 1, 1, :] + R[..., 2, 2, :]
    q0 = torch.stack([R[..., 2, 1, :] - R[..., 1, 2, :],
                      R[..., 0, 2, :] - R[..., 2, 0, :],
                      R[..., 1, 0, :] - R[..., 0, 1, :],
                      1.0 + tr], -2)
    q1 = torch.stack([1.0 + R[..., 0, 0, :] - R[..., 1, 1, :] - R[..., 2, 2, :],
                      R[..., 0, 1, :] + R[..., 1, 0, :],
                      R[..., 0, 2, :] + R[..., 2, 0, :],
                      R[..., 2, 1, :] - R[..., 1, 2, :]], -2)
    q2 = torch.stack([R[..., 0, 1, :] + R[..., 1, 0, :],
                      1.0 - R[..., 0, 0, :] + R[..., 1, 1, :] - R[..., 2, 2, :],
                      R[..., 1, 2, :] + R[..., 2, 1, :],
                      R[..., 0, 2, :] - R[..., 2, 0, :]], -2)
    q3 = torch.stack([R[..., 0, 2, :] + R[..., 2, 0, :],
                      R[..., 1, 2, :] + R[..., 2, 1, :],
                      1.0 - R[..., 0, 0, :] - R[..., 1, 1, :] + R[..., 2, 2, :],
                      R[..., 1, 0, :] - R[..., 0, 1, :]], -2)

    def n2(q):
        return (q * q).sum(-2)

    best, bn = q0, n2(q0)
    for qc in (q1, q2, q3):
        nc = n2(qc)
        take = nc > bn
        best = torch.where(take[..., None, :], qc, best)
        bn = torch.where(take, nc, bn)
    q = best / torch.sqrt(bn)[..., None, :]
    return q * torch.where(q[..., 3:4, :] < 0, -1.0, 1.0).to(q.dtype)


def _ltheta(w):
    theta2 = (w * w).sum(-2)
    small = theta2 < _EPS2
    t2s = torch.where(small, torch.ones_like(theta2), theta2)
    return theta2, torch.sqrt(t2s), small


def lquat_log(q):
    """Plain atan2 (the JAX lane code replaces it with a polynomial only
    because Mosaic has no atan2 lowering)."""
    vec, w = q[..., :3, :], q[..., 3, :]
    sgn = torch.where(w < 0, -1.0, 1.0).to(q.dtype)
    vec, w = vec * sgn[..., None, :], w * sgn
    n2 = (vec * vec).sum(-2)
    small = n2 < _EPS2
    n = torch.sqrt(torch.where(small, torch.ones_like(n2), n2))
    angle = 2.0 * torch.atan2(n, w)
    scale = torch.where(small, 2.0 / w - 2.0 * n2 / (3.0 * w ** 3), angle / n)
    return vec * scale[..., None, :]


def llog3(R):
    return lquat_log(lrot_to_quat(R))


def lexp3(w):
    theta2, theta, small = _ltheta(w)
    s = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    c = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.where(small, torch.ones_like(theta2), theta2))
    W = lskew(w)
    return (leye(3, w) + s[..., None, None, :] * W
            + c[..., None, None, :] * lmm(W, W))


def ljac_so3_right_inv(w):
    theta2, theta, small = _ltheta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2 - (1.0 + torch.cos(theta))
                    / (2.0 * theta * torch.sin(theta)))
    W = lskew(w)
    return leye(3, w) + 0.5 * W + c[..., None, None, :] * lmm(W, W)


def lse3_v_matrix(w):
    theta2, theta, small = _ltheta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c1 = torch.where(small, 0.5 - theta2 / 24.0, (1 - torch.cos(theta)) / t2)
    c2 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - torch.sin(theta)) / (t2 * theta))
    W = lskew(w)
    return (leye(3, w) + c1[..., None, None, :] * W
            + c2[..., None, None, :] * lmm(W, W))


def lse3_v_inv(w):
    theta2, theta, small = _ltheta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / t2 - (1.0 + torch.cos(theta))
                    / (2.0 * theta * torch.sin(theta)))
    W = lskew(w)
    return leye(3, w) - 0.5 * W + c[..., None, None, :] * lmm(W, W)


def lexp6(xi):
    v, w = xi[..., :3, :], xi[..., 3:, :]
    return lexp3(w), lmv(lse3_v_matrix(w), v)


def llog6(R, p):
    w = llog3(R)
    return lcat([lmv(lse3_v_inv(w), p), w], -2)


def lse3_adjoint(R, p):
    pR = lmm(lskew(p), R)
    top = lcat([R, pR], -2)
    bot = lcat([torch.zeros_like(R), R], -2)
    return lcat([top, bot], -3)


def _lse3_Q_left(v, w):
    theta2, theta, small = _ltheta(w)
    t2 = torch.where(small, torch.ones_like(theta2), theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    c1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                     (theta - sin_t) / (t2 * theta))
    m2 = torch.where(small, -1.0 / 24.0 + theta2 / 720.0,
                     (1.0 - 0.5 * theta2 - cos_t) / (t2 * t2))
    m3 = torch.where(small, -1.0 / 120.0 + theta2 / 5040.0,
                     (theta - sin_t - theta2 * theta / 6.0)
                     / (t2 * t2 * theta))
    V, W = lskew(v), lskew(w)
    WV, VW = lmm(W, V), lmm(V, W)
    WVW = lmm(WV, W)
    WWV, VWW = lmm(W, WV), lmm(VW, W)
    WVWW = lmm(WVW, W)
    WWVW = lmm(W, WVW)

    def e(c):
        return c[..., None, None, :]
    return (0.5 * V + e(c1) * (WV + VW + WVW)
            - e(m2) * (WWV + VWW - 3.0 * WVW)
            - 0.5 * e(m2 - 3.0 * m3) * (WVWW + WWVW))


def ljac_se3_left(xi):
    v, w = xi[..., :3, :], xi[..., 3:, :]
    Jl = lse3_v_matrix(w)
    Q = _lse3_Q_left(v, w)
    top = lcat([Jl, Q], -2)
    bot = lcat([torch.zeros_like(Jl), Jl], -2)
    return lcat([top, bot], -3)


def ljac_se3_right(xi):
    return ljac_se3_left(-xi)


def ljac_se3_right_inv(xi):
    v, w = xi[..., :3, :], xi[..., 3:, :]
    Jri = ljac_so3_right_inv(w)
    Qr = _lse3_Q_left(-v, -w)
    top_r = -lmm(Jri, lmm(Qr, Jri))
    top = lcat([Jri, top_r], -2)
    bot = lcat([torch.zeros_like(Jri), Jri], -2)
    return lcat([top, bot], -3)


# ---------------------------------------------------------------------------
# Lane Cholesky + triangular solves (fused_node.py:419-476)
# ---------------------------------------------------------------------------

def lchol(M):
    """Lower Cholesky of (n, n, N); a negative pivot gives NaN (the failure
    signal the solvers read)."""
    n = M.shape[-3]
    cols = []
    for j in range(n):
        s = M[:, j, :]
        if cols:
            prev = torch.stack(cols, dim=1)               # (n, j, N)
            s = s - (prev * prev[j][None]).sum(1)
        d = torch.sqrt(s[j])
        col = s / d[None]
        col = col * _const((np.arange(n) > j).astype(np.float64)[:, None], M)
        col = col + d[None] * _const(
            (np.arange(n) == j).astype(np.float64)[:, None], M)
        cols.append(col)
    return torch.stack(cols, dim=1)


def lsolve_lower(L, B):
    n = L.shape[-3]
    rows = []
    for i in range(n):
        s = B[i]
        if rows:
            prev = torch.stack(rows, dim=0)
            s = s - (L[i][:i][:, None, :] * prev).sum(0)
        rows.append(s / L[i][i][None])
    return torch.stack(rows, dim=0)


def lsolve_upper_t(L, B):
    n = L.shape[-3]
    rows = [None] * n
    for i in range(n - 1, -1, -1):
        s = B[i]
        done = [L[k][i][None, :] * rows[k] for k in range(i + 1, n)]
        if done:
            s = s - sum(done)
        rows[i] = s / L[i][i][None]
    return torch.stack(rows, dim=0)


def lcho_solve(L, B):
    return lsolve_upper_t(L, lsolve_lower(L, B))


def lcho_solve_vec(L, b):
    return lcho_solve(L, b[:, None, :])[:, 0, :]


# ---------------------------------------------------------------------------
# Lane kinematics (fused_node.py:484-666)
# ---------------------------------------------------------------------------

class LInertia(NamedTuple):
    m: torch.Tensor     # (nj, N)
    c: torch.Tensor     # (nj, 3, N)
    Ic: torch.Tensor    # (nj, 3, 3, N)

    def to_matrix(self):
        cx = lskew(self.c)
        m = self.m[..., None, None, :]
        eye = leye(3, self.c)
        I_bar = self.Ic - m * lmm(cx, cx)
        top = lcat([m * eye, -m * cx], -2)
        bot = lcat([m * cx, I_bar], -2)
        return lcat([top, bot], -3)

    def mul_motion(self, v):
        vl, w = v[..., :3, :], v[..., 3:, :]
        m = self.m[..., None, :]
        cx = lskew(self.c)
        fl = m * (vl - lcross(self.c, w))
        fa = (m * lcross(self.c, vl) + lmv(self.Ic, w)
              - m * lmv(cx, lmv(cx, w)))
        return lcat([fl, fa], -2)


class LKin(NamedTuple):
    model: object              # lane-layout RobotModel
    meta: tuple                # algo._tree_meta static tuple
    q: torch.Tensor
    v: torch.Tensor
    oR: torch.Tensor           # (nj, 3, 3, N)
    op: torch.Tensor           # (nj, 3, N)
    vels: torch.Tensor         # (nj, 6, N) joint-local
    biasacc: torch.Tensor      # (nj, 6, N) joint-local
    Jcols: torch.Tensor        # (nv, 6, N) world Jacobian columns
    vel_w: torch.Tensor        # (nj, 6, N)
    Iw: LInertia

    def oMi(self, j) -> TL:
        return TL(self.oR[j], self.op[j])

    def _fX(self, fid) -> TL:
        return TL(self.model.fp_R[fid], self.model.fp_p[fid])

    def frame_placement(self, fid) -> TL:
        return self.oMi(self.model.frame_parents[fid]).compose(self._fX(fid))

    def frame_velocity(self, fid):
        j = self.model.frame_parents[fid]
        return self._fX(fid).act_motion_inv(self.vels[j])

    def frame_bias_acc(self, fid):
        j = self.model.frame_parents[fid]
        return self._fX(fid).act_motion_inv(self.biasacc[j])

    def amask_np(self):
        return self.meta[3]

    def com(self):
        m = self.Iw.m
        return (m[:, None, :] * self.Iw.c).sum(0) / m.sum(0)[None]


def lane_kin(model, meta, q, v) -> LKin:
    """One lane-layout kinematic sweep (fused_node.py:548)."""
    dt = q.dtype
    nj = len(model.joint_types)
    levels, v_off, nv, amask_np, dof_joint, _, _, _ = meta
    types = [JointType(t) for t in model.joint_types]
    has_ff = types[0] == JointType.FREE_FLYER
    N = q.shape[-1]
    z3 = torch.zeros((3, N), dtype=dt, device=q.device)

    R_pl, p_pl, S6, vJ = [None] * nj, [None] * nj, [None] * nj, [None] * nj
    for j in range(nj):
        if types[j] == JointType.FREE_FLYER:
            R_pl[j] = lmm(model.jp_R[j], lquat_to_rot(q[3:7]))
            p_pl[j] = model.jp_p[j] + lmv(model.jp_R[j], q[:3])
            S6[j] = torch.zeros((6, N), dtype=dt, device=q.device)
            vJ[j] = v[:6]
        else:
            qj = q[v_off[j] + (1 if has_ff else 0)]
            ax = model.axis[j]
            if types[j] == JointType.REVOLUTE:
                K = lskew(ax)
                s, c = torch.sin(qj), torch.cos(qj)
                R_J = (leye(3, ax) + s[None, None] * K
                       + (1.0 - c)[None, None] * lmm(K, K))
                R_pl[j] = lmm(model.jp_R[j], R_J)
                p_pl[j] = model.jp_p[j]
                S6[j] = lcat([z3, ax], 0)
            else:
                R_pl[j] = model.jp_R[j]
                p_pl[j] = model.jp_p[j] + lmv(model.jp_R[j], ax * qj[None])
                S6[j] = lcat([ax, z3], 0)
            vJ[j] = S6[j] * v[v_off[j]][None]

    oR, op = [None] * nj, [None] * nj
    vel, bias = [None] * nj, [None] * nj
    for j in range(nj):
        p = model.parents[j]
        Xup = TL(R_pl[j], p_pl[j]).inverse()
        if p == -1:
            oR[j], op[j] = R_pl[j], p_pl[j]
            vel[j] = vJ[j]
            bias[j] = lcross_motion(vel[j], vJ[j])
        else:
            oR[j] = lmm(oR[p], R_pl[j])
            op[j] = op[p] + lmv(oR[p], p_pl[j])
            v_l = Xup.act_motion(vel[p]) + vJ[j]
            vel[j] = v_l
            bias[j] = Xup.act_motion(bias[p]) + lcross_motion(v_l, vJ[j])
    oR = torch.stack(oR)
    op = torch.stack(op)
    vels = torch.stack(vel)
    biasacc = torch.stack(bias)

    cols = [None] * nv
    for j in range(nj):
        Xw = TL(oR[j], op[j])
        if types[j] == JointType.FREE_FLYER:
            e6 = leye(6, q)
            ff_cols = TL(Xw.R[None], Xw.p[None]).act_motion(e6)
            for k in range(6):
                cols[v_off[j] + k] = ff_cols[k]
        else:
            cols[v_off[j]] = Xw.act_motion(S6[j])
    Jcols = torch.stack(cols)

    oX = TL(oR, op)
    vel_w = oX.act_motion(vels)
    Iw = LInertia(m=model.mass, c=oX.act_point(model.com),
                  Ic=lmm(lmm(oR, model.inertia), lT(oR)))
    return LKin(model=model, meta=meta, q=q, v=v, oR=oR, op=op, vels=vels,
                biasacc=biasacc, Jcols=Jcols, vel_w=vel_w, Iw=Iw)


def lane_mass_matrix(kin: LKin, armature=None):
    """M = Σ_i J_iᵀ I_i J_i, looped over bodies (masked dense Jacobians)."""
    amask = kin.amask_np()
    Iw6 = kin.Iw.to_matrix()
    M = None
    for i in range(amask.shape[0]):
        Jw = kin.Jcols * _const(amask[i][:, None, None], kin.Jcols)
        Mi = lmm(lmm(Jw, Iw6[i]), Jw.transpose(0, 1))
        M = Mi if M is None else M + Mi
    if armature is not None:
        M = M + leye(M.shape[0], M) * armature[:, None, :]
    return M


def lane_bias_forces(kin: LKin):
    g6 = lcat([-kin.model.gravity, torch.zeros_like(kin.model.gravity)], 0)
    oX = TL(kin.oR, kin.op)
    a_w = oX.act_motion(kin.biasacc) + g6[None]
    f_w = (kin.Iw.mul_motion(a_w)
           + lcross_force(kin.vel_w, kin.Iw.mul_motion(kin.vel_w)))
    amask = kin.amask_np()
    b = torch.zeros((kin.Jcols.shape[0], f_w.shape[-1]), dtype=kin.q.dtype,
                    device=kin.q.device)
    for i in range(amask.shape[0]):
        b = b + _const(amask[i][:, None], b) * (kin.Jcols * f_w[i][None]).sum(1)
    return b


# ---------------------------------------------------------------------------
# Closed-form generalized-force derivatives and frame tangents
# (fused_node.py:674-880)
# ---------------------------------------------------------------------------

def _stack_parent(arr, parents):
    z = torch.zeros_like(arr[0])
    return torch.stack([arr[p] if p != -1 else z for p in parents])


def _stack_pick(arr, idx):
    return torch.stack([arr[i] for i in idx])


class LTanCtx(NamedTuple):
    dt: object
    nj: int
    nv: int
    dofj: tuple
    parents: tuple
    amask_np: object
    S: torch.Tensor
    vw: torch.Tensor
    vp_w: torch.Tensor
    vJ_w: torch.Tensor
    wv: torch.Tensor
    vjd: torch.Tensor
    oX: TL
    bias_w: torch.Tensor
    amask_l: torch.Tensor
    u: torch.Tensor
    uw: torch.Tensor
    PS: torch.Tensor
    PS_pd: torch.Tensor
    CMv: torch.Tensor
    cw: torch.Tensor
    cu: torch.Tensor


def lane_tan_ctx(kin: LKin, a) -> LTanCtx:
    model, meta = kin.model, kin.meta
    _, v_off, nv, amask_np, dof_joint, _, _, _ = meta
    nj = amask_np.shape[0]
    dofj = [int(j) for j in np.asarray(dof_joint)]
    parents = [int(p) for p in model.parents]
    S = kin.Jcols
    vw = kin.vel_w
    vp_w = _stack_parent(vw, parents)
    vJ_w = vw - vp_w
    wv = _stack_pick(vp_w, dofj)
    vjd = _stack_pick(vw, dofj)
    oX = TL(kin.oR, kin.op)
    bias_w = oX.act_motion(kin.biasacc)
    Jm_np = amask_np[:, np.asarray([v_off[k] for k in range(nj)])]
    amask_l = _const(amask_np[:, :, None, None], S)
    u = (amask_l * (S * a[:, None, :])[None]).sum(1)
    uw = _stack_pick(_stack_parent(u, parents), dofj)
    CMv = lCM(vw)
    CMvJ = lCM(vJ_w)
    Kk = lmm(CMvJ, CMv) + lmm(lAD(vw), CMvJ)
    PS = (_const(Jm_np[:, :, None, None, None], Kk) * Kk[None]).sum(1)
    PS_pd = _stack_pick(_stack_parent(PS, parents), dofj)
    return LTanCtx(dt=S.dtype, nj=nj, nv=nv, dofj=tuple(dofj),
                   parents=tuple(parents), amask_np=amask_np, S=S, vw=vw,
                   vp_w=vp_w, vJ_w=vJ_w, wv=wv, vjd=vjd, oX=oX,
                   bias_w=bias_w, amask_l=amask_l, u=u, uw=uw, PS=PS,
                   PS_pd=PS_pd, CMv=CMv, cw=lcross_motion(S, wv),
                   cu=lcross_motion(S, uw))


def lane_gforce_derivatives(kin: LKin, a, ext_w, ctx: LTanCtx):
    """(dG_dq, dG_dv) each (nv, nv, N) (fused_node.py:764)."""
    nj, dofj, amask_np, S, vw, wv, vjd = (ctx.nj, ctx.dofj, ctx.amask_np,
                                          ctx.S, ctx.vw, ctx.wv, ctx.vjd)
    model = kin.model
    Am2 = amask_np[np.asarray(dofj)].T
    g6 = lcat([-model.gravity, torch.zeros_like(model.gravity)], 0)
    Iw6 = kin.Iw.to_matrix()

    biasg = ctx.bias_w + g6[None]
    h = kin.Iw.mul_motion(biasg + ctx.u)
    h2 = kin.Iw.mul_motion(vw)
    f = h + lcross_force(vw, h2)
    if ext_w is not None:
        f = f - ext_w

    CFh2 = lCF(h2)
    ADsv = lADs(vw)
    G_q = (lCF(h) - lmm(Iw6, lCM(biasg)) + lmm(Iw6, ctx.PS)
           + lmm(CFh2, ctx.CMv) + lmm(ADsv, CFh2))
    if ext_w is not None:
        G_q = G_q - lCF(ext_w)
    Gv = CFh2 + lmm(ADsv, Iw6) + lmm(Iw6, ctx.CMv)

    cw, cu = ctx.cw, ctx.cu
    zeta_q = -cu - lmv(ctx.PS_pd, S) + lcross_motion(cw, wv)
    zeta_v = -cw + lcross_motion(vjd, S)

    def pair_multi(kerns, rights):
        out = None
        for K6, R6 in zip(kerns, rights):
            for i in range(nj):
                m_i = _const(amask_np[i][:, None, None], S)
                blk = lmm(lmm(S * m_i, K6[i]), (R6 * m_i).transpose(0, 1))
                out = blk if out is None else out + blk
        return out

    F = (ctx.amask_l * f[:, None]).sum(0)
    QF = lcross_force(S, F)
    T1 = (QF[:, None] * S[None]).sum(-2) * _const(Am2.T[:, :, None], S)
    dG_dq = T1 + pair_multi([G_q, Iw6, -Gv], [S, zeta_q, cw])
    dG_dv = pair_multi([Gv, Iw6], [S, zeta_v])
    return dG_dq, dG_dv


class LFrameTangents(NamedTuple):
    dxi: torch.Tensor   # (ndx, 6, N)
    dp: torch.Tensor    # (ndx, 3, N)
    dv: torch.Tensor    # (ndx, 6, N)
    dab: torch.Tensor   # (ndx, 6, N)
    dJa: torch.Tensor   # (ndx, 6, N)


def lane_frame_tangents(kin: LKin, a, fid, ctx: LTanCtx) -> LFrameTangents:
    """Closed-form frame-quantity tangents (fused_node.py:838)."""
    nv, S, vw, wv, vjd, bias_w = (ctx.nv, ctx.S, ctx.vw, ctx.wv, ctx.vjd,
                                  ctx.bias_w)
    j = kin.model.frame_parents[fid]
    N = S.shape[-1]
    mask = _const(ctx.amask_np[j][:, None, None], S)
    Y = kin.frame_placement(fid)
    Yinv = Y.inverse()
    Yb = TL(Yinv.R[None], Yinv.p[None])
    zq = torch.zeros((nv, 3, N), dtype=S.dtype, device=S.device)
    z6 = torch.zeros((nv, 6, N), dtype=S.dtype, device=S.device)

    dxi_q = mask * Yb.act_motion(S)
    dp_q = mask * (S[:, :3] + lcross(S[:, 3:], Y.p[None]))
    dv_q = -mask * Yb.act_motion(ctx.cw)
    dv_v = mask * Yb.act_motion(S)
    dJa_q = -mask * Yb.act_motion(ctx.cu)
    wdiff = vw[j][None] - wv
    dbias_w_q = (lmv(ctx.PS[j][None], S) - lmv(ctx.PS_pd, S)
                 - lcross_motion(ctx.cw, wdiff))
    dab_q = mask * Yb.act_motion(
        dbias_w_q - lcross_motion(S, bias_w[j][None]))
    dab_v = mask * Yb.act_motion(lcross_motion(S, wdiff)
                                 + lcross_motion(vjd, S))
    return LFrameTangents(
        dxi=lcat([dxi_q, z6]), dp=lcat([dp_q, zq]), dv=lcat([dv_q, dv_v]),
        dab=lcat([dab_q, dab_v]), dJa=lcat([dJa_q, z6]))


# ---------------------------------------------------------------------------
# Lane contacts, state diff, activations, CoM Jacobian (fused_node.py:885-975)
# ---------------------------------------------------------------------------

def _lane_contact3d_calc(c, kin: LKin):
    """(Jc (3, nv, N), a0 (3, N)) for one Contact3D (unmasked)."""
    j = kin.model.frame_parents[c.fid]
    cols = kin.Jcols * _const(kin.amask_np()[j][:, None, None], kin.q)
    Y = kin.frame_placement(c.fid)
    Yinv = Y.inverse()
    Jl = TL(Yinv.R[None], Yinv.p[None]).act_motion(cols)
    Jc = Jl[:, :3].transpose(0, 1)
    vf = kin.frame_velocity(c.fid)
    vv, vw = vf[:3], vf[3:]
    a0 = (kin.frame_bias_acc(c.fid)[:3] + lcross(vw, vv)
          + c.gains[0][None] * (Y.p - c.pref) + c.gains[1][None] * vv)
    return Jc, a0


def _lane_contact3d_tangent(c, kin: LKin, ft: LFrameTangents):
    """d(−(Jc·a + a0))/dx (ndx, 3, N)."""
    vf = kin.frame_velocity(c.fid)
    vv, vw = vf[:3], vf[3:]
    dvv, dvw = ft.dv[:, :3], ft.dv[:, 3:]
    da0 = (ft.dab[:, :3] + lcross(dvw, vv[None]) + lcross(vw[None], dvv)
           + c.gains[0][None, None] * ft.dp + c.gains[1][None, None] * dvv)
    return -(ft.dJa[:, :3] + da0)


def _lane_state_diff(st_has_ff, nq, nv, xref, x):
    """st.diff(xref, x) in lanes -> ((ndx, N), d6_or_None)."""
    if not st_has_ff:
        return x - xref, None
    M0 = TL(lquat_to_rot(xref[3:7]), xref[:3])
    M1 = TL(lquat_to_rot(x[3:7]), x[:3])
    D = M0.inverse().compose(M1)
    d6 = llog6(D.R, D.p)
    return lcat([d6, x[7:nq] - xref[7:nq], x[nq:] - xref[nq:]], 0), d6


def _lane_activation(act, R):
    """(a, Ar, Arr) of the supported activations; R (nr, N)."""
    from ..models.multibody.activations import (
        ActivationQuad, ActivationQuadraticBarrier, ActivationWeightedQuad,
        ActivationWeightedQuadraticBarrier)
    if isinstance(act, ActivationQuad):
        return 0.5 * (R * R).sum(0), R, torch.ones_like(R)
    if isinstance(act, ActivationWeightedQuad):
        wr = act.weights * R
        return 0.5 * (R * wr).sum(0), wr, act.weights
    if isinstance(act, (ActivationQuadraticBarrier,
                        ActivationWeightedQuadraticBarrier)):
        rlb = torch.clamp(R - act.lb, max=0.0)
        rub = torch.clamp(R - act.ub, min=0.0)
        active = (((R - act.lb) <= 0.0) | ((R - act.ub) >= 0.0)).to(R.dtype)
        if isinstance(act, ActivationQuadraticBarrier):
            a = 0.5 * (rlb * rlb).sum(0) + 0.5 * (rub * rub).sum(0)
            return a, rlb + rub, active
        rb = rlb + rub
        wrb = act.weights * rb
        return 0.5 * (rb * wrb).sum(0), wrb, act.weights * active
    raise NotImplementedError(type(act))


def _lane_com_jac(kin: LKin):
    """dcom/dx (3, ndx, N)."""
    S = kin.Jcols
    nv, N = S.shape[0], S.shape[-1]
    amask = kin.amask_np()
    m = kin.Iw.m
    msub = (_const(amask[:, :, None], S) * m[:, None, :]).sum(0)
    csub = (_const(amask[:, :, None, None], S)
            * (m[:, None, None, :] * kin.Iw.c[:, None, :, :])).sum(0)
    dcom_q = ((msub[:, None, :] * S[:, :3] + lcross(S[:, 3:], csub))
              / m.sum(0)[None, None])
    zero_v = torch.zeros((nv, 3, N), dtype=S.dtype, device=S.device)
    return lcat([dcom_q, zero_v], 0).transpose(0, 1)


# ---------------------------------------------------------------------------
# The node linearization and the node primal (fused_node.py:981-1267,
# 1505-1624)
# ---------------------------------------------------------------------------

def _tau_of(seg, u):
    from ..models.multibody.actuations import (FloatingBaseActuation,
                                               FullActuation)
    if isinstance(seg.actuation, FloatingBaseActuation):
        return lcat([torch.zeros((6, u.shape[-1]), dtype=u.dtype,
                                 device=u.device), u], 0)
    if isinstance(seg.actuation, FullActuation):
        return u
    raise NotImplementedError(type(seg.actuation))


def _lane_dynamics(seg, kin, tau, nc_list):
    """Contact KKT (or free) forward dynamics; returns a dict of the
    primal factorizations the tangent pass reuses."""
    M = lane_mass_matrix(kin, seg.armature)
    tau_mb = tau - lane_bias_forces(kin)
    contacts = tuple(seg.contacts.contacts) if seg.contacts is not None else ()
    N = tau.shape[-1]
    out = {}
    if nc_list:
        nc = sum(nc_list)
        Js, a0s, masks = [], [], []
        for c in contacts:
            Jc_c, a0_c = _lane_contact3d_calc(c, kin)
            act = c.active[None]
            Js.append(Jc_c * act[:, None])
            a0s.append(a0_c * act)
            masks.append(c.active[None].expand(c.nc, N))
        Jc, a0, mask = lcat(Js, 0), lcat(a0s, 0), lcat(masks, 0)
        Lm = lchol(M)
        X = lcho_solve(Lm, lcat([Jc.transpose(0, 1), tau_mb[:, None]], 1))
        MinvJT, a_free = X[:, :nc], X[:, nc]
        S_kkt = lmm_chunk(Jc, MinvJT, chunk=6)
        S_kkt = (S_kkt * (mask[:, None] * mask[None, :])
                 + leye(nc, mask) * (1.0 - mask)[:, None])
        if seg.kkt_damping:
            S_kkt = S_kkt + seg.kkt_damping * leye(nc, mask) \
                * (mask[:, None] * mask[None, :])
        b_lam = -(lmv(Jc, a_free) + a0) * mask
        Ls = lchol(S_kkt)
        lam = lcho_solve_vec(Ls, b_lam)
        a = a_free + lmv(MinvJT, lam)
        out.update(Jc=Jc, mask=mask, Lm=Lm, Ls=Ls, MinvJT=MinvJT)
    else:
        Lm = lchol(M)
        a = lcho_solve_vec(Lm, tau_mb)
        lam = None
        out.update(Lm=Lm)
    out.update(a=a, lam=lam)
    return out


def _model_meta(model):
    return algo._tree_meta(tuple(model.parents), tuple(model.joint_types),
                           tuple(model.frame_parents))


def lane_calc_both(seg, x, u):
    """Full node linearization for lane-layout ``seg`` (leaves (..., N)),
    x (nx, N), u (nu, N) → (NodeDerivs, xnext (nx, N), cost (N,)).

    Port of fused_node.py:981-1267 (RigidBodyNode._tangent_outputs +
    calc_both, Gauss-Newton + Euler/manifold chain)."""
    from ..models.multibody.costs import (
        CostCoM, CostContactForce, CostContactFrictionCone, CostControl,
        CostFrameTranslation, CostFrameVelocity, CostState)

    st = seg.state_
    model = st.model
    meta = _model_meta(model)
    nq, nv = st.nq, st.nv
    ndx = 2 * nv
    nu = seg.actuation.nu
    dtt = x.dtype
    N = x.shape[-1]
    has_ff = JointType(model.joint_types[0]) == JointType.FREE_FLYER

    q, v = x[:nq], x[nq:]
    kin = lane_kin(model, meta, q, v)
    tau = _tau_of(seg, u)
    dtau_du = _const(seg.actuation.dtau_du(x)[:, :, None], x).expand(
        nv, nu, N)

    contacts = tuple(seg.contacts.contacts) if seg.contacts is not None else ()
    nc = sum(c.nc for c in contacts)
    dyn = _lane_dynamics(seg, kin, tau, [c.nc for c in contacts])
    a, lam, Lm = dyn["a"], dyn["lam"], dyn["Lm"]

    if nc:
        ext_acc = [None] * len(model.joint_types)
        i0 = 0
        for c in contacts:
            lam_c = lam[i0:i0 + c.nc]
            i0 += c.nc
            wrench = lcat([lam_c, torch.zeros((3, N), dtype=dtt,
                                              device=x.device)], 0)
            w_w = kin.frame_placement(c.fid).act_force(wrench)
            jid = model.frame_parents[c.fid]
            ext_acc[jid] = w_w if ext_acc[jid] is None else ext_acc[jid] + w_w
        ext_w = torch.stack([e if e is not None else torch.zeros(
            (6, N), dtype=dtt, device=x.device) for e in ext_acc])
    else:
        ext_w = None

    tan_ctx = lane_tan_ctx(kin, a)
    fts = {}

    def ft_of(fid):
        if fid not in fts:
            fts[fid] = lane_frame_tangents(kin, a, fid, tan_ctx)
        return fts[fid]

    dG_dq, dG_dv = lane_gforce_derivatives(kin, a, ext_w, tan_ctx)
    r1_all = lcat([-lcat([dG_dq, dG_dv], 1), dtau_du], 1)
    if nc:
        Jc, mask, Ls, MinvJT = dyn["Jc"], dyn["mask"], dyn["Ls"], dyn["MinvJT"]
        r2x = [_lane_contact3d_tangent(c, kin, ft_of(c.fid)).transpose(0, 1)
               * c.active[None, None] for c in contacts]
        r2_all = lcat([lcat(r2x, 0), torch.zeros((nc, nu, N), dtype=dtt,
                                                 device=x.device)], 1)
        Minv_r1 = lcho_solve(Lm, r1_all)
        dlam = lcho_solve(
            Ls, (r2_all - lmm_chunk(Jc, Minv_r1, chunk=6)) * mask[:, None])
        dacc = Minv_r1 + lmm_chunk(MinvJT, dlam, chunk=6)
    else:
        dacc = lcho_solve(Lm, r1_all)
        dlam = None
    da_dx, da_du = dacc[:, :ndx], dacc[:, ndx:]

    slices, i0 = [], 0
    for c in contacts:
        slices.append((i0, c.nc))
        i0 += c.nc

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtt, device=x.device)

    cost_rate = zeros(N)
    Lx, Lu = zeros(ndx, N), zeros(nu, N)
    Lxx, Lxu, Luu = zeros(ndx, ndx, N), zeros(ndx, nu, N), zeros(nu, nu, N)
    com_jac = None
    for citem in seg.costs.items:
        Ru_c = None
        Rf_c = None
        if isinstance(citem, CostState):
            R_c, d6 = _lane_state_diff(has_ff, nq, nv, citem.xref, x)
            a_val, Ar, Arr = _lane_activation(citem.activation, R_c)
            w = citem.active * citem.weight
            cost_rate = cost_rate + w * a_val
            if has_ff:
                Jri = ljac_se3_right_inv(d6)
                Lx = Lx + w[None] * lcat([lmtv(Jri, Ar[:6]), Ar[6:]], 0)
                TL6 = lmm(lT(Jri), Jri * Arr[:6][:, None])
                top = lcat([TL6, zeros(6, ndx - 6, N)], 1)
                diag_rest = leye(ndx, x)[6:, 6:] * Arr[6:][:, None]
                bot = lcat([zeros(ndx - 6, 6, N), diag_rest], 1)
                Lxx = Lxx + w[None, None] * lcat([top, bot], 0)
            else:
                Lx = Lx + w[None] * Ar
                Lxx = Lxx + w[None, None] * (leye(ndx, x) * Arr[:, None])
            continue
        if isinstance(citem, CostControl):
            R_c = u - citem.uref
            a_val, Ar, Arr = _lane_activation(citem.activation, R_c)
            w = citem.active * citem.weight
            cost_rate = cost_rate + w * a_val
            Lu = Lu + w[None] * Ar
            Luu = Luu + w[None, None] * (leye(nu, u) * Arr[:, None])
            continue
        if isinstance(citem, CostCoM):
            R_c = kin.com() - citem.cref
            if com_jac is None:
                com_jac = _lane_com_jac(kin)
            Rx_c = com_jac
        elif isinstance(citem, CostFrameTranslation):
            R_c = kin.frame_placement(citem.fid).p - citem.pref
            Rx_c = ft_of(citem.fid).dp.transpose(0, 1)
        elif isinstance(citem, CostFrameVelocity):
            R_c = kin.frame_velocity(citem.fid) - citem.vref
            Rx_c = ft_of(citem.fid).dv.transpose(0, 1)
        elif isinstance(citem, CostContactFrictionCone):
            i0c, _ = slices[citem.contact_idx]
            A = citem.cone.A
            R_c = lmv(A, lam[i0c:i0c + 3])
            na = A.shape[0]
            Rx_c = zeros(na, ndx, N)
            parts = []
            if i0c:
                parts.append(zeros(na, i0c, N))
            parts.append(A)
            if nc - i0c - 3:
                parts.append(zeros(na, nc - i0c - 3, N))
            Rf_c = lcat(parts, 1)
        elif isinstance(citem, CostContactForce):
            i0c, _ = slices[citem.contact_idx]
            nrf = citem.fref.shape[0]
            R_c = lam[i0c:i0c + nrf] - citem.fref
            Rx_c = zeros(nrf, ndx, N)
            eye_np = np.zeros((nrf, nc))
            eye_np[:, i0c:i0c + nrf] = np.eye(nrf)
            Rf_c = _const(eye_np[:, :, None], x).expand(nrf, nc, N)
        else:
            raise NotImplementedError(type(citem))

        if Rf_c is not None and nc:
            Rx_c = Rx_c + lmm_chunk(Rf_c, dlam[:, :ndx], chunk=6)
            Ru_fc = lmm_chunk(Rf_c, dlam[:, ndx:], chunk=6)
            Ru_c = Ru_fc if Ru_c is None else Ru_c + Ru_fc

        a_val, Ar, Arr = _lane_activation(citem.activation, R_c)
        w = citem.active * citem.weight
        cost_rate = cost_rate + w * a_val
        RxT = Rx_c.transpose(0, 1)
        Lx = Lx + w[None] * (Rx_c * Ar[:, None]).sum(0)
        Lxx = Lxx + w[None, None] * lmm_chunk(RxT, Rx_c * Arr[:, None],
                                              chunk=6)
        if Ru_c is not None:
            Lu = Lu + w[None] * (Ru_c * Ar[:, None]).sum(0)
            Lxu = Lxu + w[None, None] * lmm_chunk(RxT, Ru_c * Arr[:, None],
                                                  chunk=6)
            Luu = Luu + w[None, None] * lmm_chunk(
                Ru_c.transpose(0, 1), Ru_c * Arr[:, None], chunk=6)

    # -- Euler + manifold chain rule --------------------------------------
    dt_l = seg.dt
    dstep = lcat([v * dt_l[None] + a * (dt_l * dt_l)[None], a * dt_l[None]], 0)
    dv_ddx = _const(np.concatenate([np.zeros((nv, nv)), np.eye(nv)],
                                   axis=1)[:, :, None], x)
    dstep_dx = lcat([dt_l[None, None] * dv_ddx
                     + (dt_l * dt_l)[None, None] * da_dx,
                     dt_l[None, None] * da_dx], 0)
    dstep_du = lcat([(dt_l * dt_l)[None, None] * da_du,
                     dt_l[None, None] * da_du], 0)
    if has_ff:
        xi = dstep[:6]
        eR, ep = lexp6(-xi)
        Jx_blk = lse3_adjoint(eR, ep)
        Jdx_blk = ljac_se3_right(xi)
        top_x = (lmm(Jdx_blk, dstep_dx[:6])
                 + lcat([Jx_blk, zeros(6, ndx - 6, N)], 1))
        bot_x = dstep_dx[6:] + leye(ndx, x)[6:]
        Fx_int = lcat([top_x, bot_x], 0)
        Fu_int = lcat([lmm(Jdx_blk, dstep_du[:6]), dstep_du[6:]], 0)
    else:
        Fx_int = dstep_dx + leye(ndx, x)
        Fu_int = dstep_du
    xnext_int = lane_integrate(has_ff, nq, nv, x, dstep)

    is_term = dt_l == 0.0
    Fx = torch.where(is_term[None, None], leye(ndx, x), Fx_int)
    Fu = torch.where(is_term[None, None], torch.zeros_like(Fu_int), Fu_int)
    xnext = torch.where(is_term[None], x, xnext_int)
    cost = torch.where(is_term, cost_rate, dt_l * cost_rate)
    scale = torch.where(is_term, torch.ones_like(dt_l), dt_l)
    derivs = NodeDerivs(
        Fx=Fx, Fu=Fu, Lx=scale[None] * Lx, Lu=scale[None] * Lu,
        Lxx=scale[None, None] * Lxx, Lxu=scale[None, None] * Lxu,
        Luu=scale[None, None] * Luu)
    return derivs, xnext, cost


def lane_integrate(has_ff, nq, nv, x, dx):
    """state.integrate(x, dx) in lane layout (fused_node.py:1505)."""
    q, v = x[:nq], x[nq:]
    if has_ff:
        dR, dp = lexp6(dx[:6])
        Mn = TL(lquat_to_rot(q[3:7]), q[:3]).compose(TL(dR, dp))
        qn = lrot_to_quat(Mn.R)
        qn = qn / torch.sqrt((qn * qn).sum(0))[None]
        q_next = lcat([Mn.p, qn, q[7:] + dx[6:nv]], 0)
    else:
        q_next = q + dx[:nv]
    return lcat([q_next, v + dx[nv:]], 0)


def lane_calc_primal(seg, x, u):
    """(xnext (nx, N), cost (N,)) — the node primal only
    (fused_node.py:1520-1624)."""
    from ..models.multibody.costs import (
        CostCoM, CostContactForce, CostContactFrictionCone, CostControl,
        CostFrameTranslation, CostFrameVelocity, CostState)

    st = seg.state_
    model = st.model
    nq, nv = st.nq, st.nv
    N = x.shape[-1]
    has_ff = JointType(model.joint_types[0]) == JointType.FREE_FLYER
    q, v = x[:nq], x[nq:]
    kin = lane_kin(model, _model_meta(model), q, v)
    contacts = tuple(seg.contacts.contacts) if seg.contacts is not None else ()
    dyn = _lane_dynamics(seg, kin, _tau_of(seg, u), [c.nc for c in contacts])
    a, lam = dyn["a"], dyn["lam"]
    slices, i0 = [], 0
    for c in contacts:
        slices.append((i0, c.nc))
        i0 += c.nc

    cost_rate = torch.zeros(N, dtype=x.dtype, device=x.device)
    for citem in seg.costs.items:
        if isinstance(citem, CostState):
            R_c, _ = _lane_state_diff(has_ff, nq, nv, citem.xref, x)
        elif isinstance(citem, CostControl):
            R_c = u - citem.uref
        elif isinstance(citem, CostCoM):
            R_c = kin.com() - citem.cref
        elif isinstance(citem, CostFrameTranslation):
            R_c = kin.frame_placement(citem.fid).p - citem.pref
        elif isinstance(citem, CostFrameVelocity):
            R_c = kin.frame_velocity(citem.fid) - citem.vref
        elif isinstance(citem, CostContactFrictionCone):
            i0c, _ = slices[citem.contact_idx]
            R_c = lmv(citem.cone.A, lam[i0c:i0c + 3])
        elif isinstance(citem, CostContactForce):
            i0c, _ = slices[citem.contact_idx]
            R_c = lam[i0c:i0c + citem.fref.shape[0]] - citem.fref
        else:
            raise NotImplementedError(type(citem))
        a_val, _, _ = _lane_activation(citem.activation, R_c)
        cost_rate = cost_rate + citem.active * citem.weight * a_val

    dt_l = seg.dt
    dstep = lcat([v * dt_l[None] + a * (dt_l * dt_l)[None], a * dt_l[None]], 0)
    xnext_int = lane_integrate(has_ff, nq, nv, x, dstep)
    is_term = dt_l == 0.0
    return (torch.where(is_term[None], x, xnext_int),
            torch.where(is_term, cost_rate, dt_l * cost_rate))


# ---------------------------------------------------------------------------
# Structure gate, parameter layout and the entry point
# ---------------------------------------------------------------------------

def supports(seg) -> bool:
    """True iff the node structure is covered by the node kernel
    (fused_node.py:1273-1311)."""
    from ..models.multibody.activations import (
        ActivationQuad, ActivationQuadraticBarrier, ActivationWeightedQuad,
        ActivationWeightedQuadraticBarrier)
    from ..models.multibody.actuations import (FloatingBaseActuation,
                                               FullActuation)
    from ..models.multibody.contacts import Contact3D
    from ..models.multibody.costs import (
        CostCoM, CostContactForce, CostContactFrictionCone, CostControl,
        CostFrameTranslation, CostFrameVelocity, CostState)
    from ..models.multibody.nodes import RigidBodyNode

    if not isinstance(seg, RigidBodyNode) or seg.integrator != "euler":
        return False
    if not isinstance(seg.actuation, (FloatingBaseActuation, FullActuation)):
        return False
    if seg.contacts is not None:
        if not all(isinstance(c, Contact3D) for c in seg.contacts.contacts):
            return False
    ok_costs = (CostCoM, CostContactForce, CostContactFrictionCone,
                CostControl, CostFrameTranslation, CostFrameVelocity,
                CostState)
    ok_acts = (ActivationQuad, ActivationQuadraticBarrier,
               ActivationWeightedQuad, ActivationWeightedQuadraticBarrier)
    for citem in seg.costs.items:
        if type(citem) not in ok_costs or type(citem.activation) not in ok_acts:
            return False
    types = [JointType(t) for t in seg.state_.model.joint_types]
    return not any(t == JointType.FREE_FLYER for t in types[1:])


def lane_params(seg, N: int):
    """Knot-stacked ``seg`` (leaves (K, ...)) → lane layout (leaves
    (..., N)) for the plain versions: node n reads knot n // (N // K); the
    robot model (the same at every knot) is taken from knot 0 and expanded
    without a copy."""
    K = seg.dt.shape[0]
    B = N // K
    idx = torch.arange(N, device=seg.dt.device) // B
    model = tree_map(lambda l: l[0][..., None].expand(*l.shape[1:], N),
                     seg.state_.model)
    rest = tree_map(lambda l: l.movedim(0, -1).index_select(-1, idx),
                    seg.replace(state_=None))
    return rest.replace(state_=seg.state_.replace(model=model))


def _check_nodes(seg, x_l, u_l):
    K = seg.dt.shape[0]
    N = x_l.shape[-1]
    if N % K or u_l.shape[-1] != N:
        raise ValueError(f"{N} nodes do not split into {K} knots "
                         f"(u has {u_l.shape[-1]})")


def calc_both_lanes_plain(seg, x_l, u_l):
    """Plain PyTorch version of the node kernel: seg leaves (K, ...), x_l
    (nx, N), u_l (nu, N) with N = K·B → lane-layout (NodeDerivs, xnext,
    cost).  Ports fused_node.py:1374-1388 (the "jnp" mode of
    ``calc_both_lanes``) over :func:`lane_calc_both`, the port of the lane
    body fused_node.py:981-1267."""
    _check_nodes(seg, x_l, u_l)
    if not torch.compiler.is_compiling():
        calc_both_lanes_plain.calls += 1
    return lane_calc_both(lane_params(seg, x_l.shape[-1]), x_l, u_l)


calc_both_lanes_plain.calls = 0


def calc_both_lanes(seg, x_l, u_l):
    """Node linearization of N = K·B nodes (node n at knot n // B), through
    the op ``torch.ops.crocoddyl_tpu_torch.node_calc_both``: CUDA tensors
    launch the kernel of csrc/node_kernel.cu; CPU tensors take the plain
    version (the op's CPU implementation)."""
    if x_l.is_cuda:
        return _ck.node_calc_both(seg, x_l, u_l)
    leaves, spec = flat_spec(seg)
    out = torch.ops.crocoddyl_tpu_torch.node_calc_both(
        None, None, None, x_l, u_l, seg.state_.ndx, 0, leaves, spec)
    return NodeDerivs(*out[:7]), out[7], out[8]


def _node_cpu(meta, robot, par, x, u, ndx, node_ws, leaves, spec):
    d, xnext, cost = calc_both_lanes_plain(unflat_spec(leaves, spec), x, u)
    return (d.Fx, d.Fu, d.Lx, d.Lu, d.Lxx, d.Lxu, d.Luu, xnext, cost)


torch.library.register_kernel("crocoddyl_tpu_torch::node_calc_both", "cpu",
                              _node_cpu)


def _primal(leaves, spec, x, u, lo, hi):
    seg = unflat_spec(leaves, spec)
    if (lo, hi) != (0, seg.dt.shape[0]):
        seg = tree_map(lambda l: l[lo:hi], seg)
    xnext, cost = lane_calc_primal(lane_params(seg, x.shape[-1]), x, u)
    return xnext, cost


_primal_op = torch.library.custom_op(
    "crocoddyl_tpu_torch::lane_calc_primal", _primal, mutates_args=(),
    schema="(Tensor[] leaves, str spec, Tensor x, Tensor u, int lo, int hi) "
           "-> (Tensor, Tensor)")


@_primal_op.register_fake
def _(leaves, spec, x, u, lo, hi):
    return x.new_empty(x.shape), x.new_empty(x.shape[-1:])


def _state_diff(xa, xb, has_ff, nq, nv):
    return _lane_state_diff(has_ff, nq, nv, xa, xb)[0]


def _state_integrate(x, dx, has_ff, nq, nv):
    return lane_integrate(has_ff, nq, nv, x, dx)


_diff_op = torch.library.custom_op(
    "crocoddyl_tpu_torch::state_diff", _state_diff, mutates_args=(),
    schema="(Tensor xa, Tensor xb, bool has_ff, int nq, int nv) -> Tensor")
_integrate_op = torch.library.custom_op(
    "crocoddyl_tpu_torch::state_integrate", _state_integrate,
    mutates_args=(),
    schema="(Tensor x, Tensor dx, bool has_ff, int nq, int nv) -> Tensor")


@_diff_op.register_fake
def _(xa, xb, has_ff, nq, nv):
    return xa.new_empty((2 * nv,) + tuple(xa.shape[1:]))


@_integrate_op.register_fake
def _(x, dx, has_ff, nq, nv):
    return x.new_empty(x.shape)


def state_diff(has_ff, nq, nv, xa, xb):
    """xb ⊖ xa of the multibody state in lane layout ((nx, N) -> (ndx,
    N)): ``_lane_state_diff`` as the op
    ``torch.ops.crocoddyl_tpu_torch.state_diff`` (one node under
    ``torch.export``)."""
    return torch.ops.crocoddyl_tpu_torch.state_diff(xa, xb, has_ff, nq, nv)


def state_integrate(has_ff, nq, nv, x, dx):
    """x ⊕ dx in lane layout: ``lane_integrate`` as the op
    ``torch.ops.crocoddyl_tpu_torch.state_integrate``."""
    return torch.ops.crocoddyl_tpu_torch.state_integrate(x, dx, has_ff, nq,
                                                         nv)


def calc_primal(seg, x_l, u_l, lo=0, hi=None):
    """(xnext (nx, N), cost (N,)) of the knots lo:hi of the stack ``seg`` at
    N = K·A nodes (node n at knot lo + n // A): the plain lane primal
    (``lane_calc_primal``) on either device, as the op
    ``torch.ops.crocoddyl_tpu_torch.lane_calc_primal``, which
    ``torch.export`` records as one node over the stack's leaves."""
    leaves, spec = flat_spec(seg)
    return torch.ops.crocoddyl_tpu_torch.lane_calc_primal(
        leaves, spec, x_l, u_l, lo, seg.dt.shape[0] if hi is None else hi)


def prepare(seg, like):
    """Build what the kernels read of the stack ``seg`` for tensors like
    ``like``: on the card its descriptor (``cuda_kernels.descriptor``),
    once and before a solver's loops; nothing on the CPU."""
    if like.is_cuda:
        _ck.descriptor(seg, like.device, like.dtype)
