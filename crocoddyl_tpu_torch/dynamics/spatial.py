"""6D spatial algebra, [linear; angular] ordering
(port of crocoddyl_tpu/dynamics/spatial.py).

A transform is (R, p): rotation ``A_R_B`` plus the origin of B in A.
Spatial inertia is (mass m, com lever c, rotational inertia about the com
I_c).  Leading axes broadcast.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .lie import cross, mm, mtv, mv, skew


class Transform(NamedTuple):
    """X = (R, p): frame B expressed in frame A."""
    R: torch.Tensor  # (..., 3, 3)
    p: torch.Tensor  # (..., 3)

    def compose(self, other: "Transform") -> "Transform":
        return Transform(mm(self.R, other.R), self.p + mv(self.R, other.p))

    def inverse(self) -> "Transform":
        RT = self.R.transpose(-1, -2)
        return Transform(RT, -mv(RT, self.p))

    def act_motion(self, m):
        lin, ang = m[..., :3], m[..., 3:]
        Rl, Ra = mv(self.R, lin), mv(self.R, ang)
        return torch.cat([Rl + cross(self.p, Ra), Ra], dim=-1)

    def act_motion_inv(self, m):
        lin, ang = m[..., :3], m[..., 3:]
        a = mtv(self.R, ang)
        l = mtv(self.R, lin - cross(self.p, ang))
        return torch.cat([l, a], dim=-1)

    def act_force(self, f):
        lin, ang = f[..., :3], f[..., 3:]
        Rl, Ra = mv(self.R, lin), mv(self.R, ang)
        return torch.cat([Rl, Ra + cross(self.p, Rl)], dim=-1)

    def act_force_inv(self, f):
        """Force expressed in A → expressed in B."""
        lin, ang = f[..., :3], f[..., 3:]
        return torch.cat([mtv(self.R, lin),
                          mtv(self.R, ang - cross(self.p, lin))], dim=-1)

    def act_point(self, x):
        return self.p + mv(self.R, x)


def transform_identity(dtype=torch.float64, batch=(), device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(batch + (3, 3))
    return Transform(R, torch.zeros(batch + (3,), dtype=dtype,
                                    device=device))


def cross_motion(v, m):
    """v × m for motions (both [lin; ang])."""
    vl, w = v[..., :3], v[..., 3:]
    ml, ma = m[..., :3], m[..., 3:]
    return torch.cat([cross(w, ml) + cross(vl, ma), cross(w, ma)], dim=-1)


def cross_force(v, f):
    """v ×* f for a motion v and force f."""
    vl, w = v[..., :3], v[..., 3:]
    fl, n = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, fl), cross(w, n) + cross(vl, fl)], dim=-1)


class Inertia(NamedTuple):
    m: torch.Tensor    # (...,)
    c: torch.Tensor    # (..., 3)
    I_c: torch.Tensor  # (..., 3, 3)

    def to_matrix(self):
        cx = skew(self.c)
        m = self.m[..., None, None]
        eye = torch.eye(3, dtype=self.c.dtype, device=self.c.device)
        I_bar = self.I_c - m * mm(cx, cx)
        top = torch.cat([m * eye, -m * cx], dim=-1)
        bot = torch.cat([m * cx, I_bar], dim=-1)
        return torch.cat([top, bot], dim=-2)

    def mul_motion(self, v):
        vl, w = v[..., :3], v[..., 3:]
        m = self.m[..., None]
        cx = skew(self.c)
        fl = m * (vl - cross(self.c, w))
        fa = m * cross(self.c, vl) + mv(self.I_c, w) - m * mv(cx, mv(cx, w))
        return torch.cat([fl, fa], dim=-1)
