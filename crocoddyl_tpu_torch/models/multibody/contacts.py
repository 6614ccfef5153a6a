"""Point contacts with fixed-shape activity masks (port of ``Contact3D`` and
``ContactSet`` of crocoddyl_tpu/models/multibody/contacts.py).

The contact stack has a static maximal set of contacts; per-node 0/1
``active`` masks zero an inactive contact's Jacobian rows, and the KKT
solve gives it a unit diagonal so its multiplier is exactly zero.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ...dynamics.lie import cross
from ...utils.struct import PyTreeNode, field


class Contact3D(PyTreeNode):
    """Point contact: a0 = a_lin + ω×v_lin + Kp·(p−pref) + Kv·v_lin."""

    fid: int = field(static=True)
    pref: torch.Tensor = None     # (3,) world reference translation
    gains: torch.Tensor = None    # (2,) Baumgarte (Kp, Kv)
    active: torch.Tensor = None   # 0/1

    @property
    def nc(self) -> int:
        return 3

    def calc(self, cache):
        J = cache.frame_jacobian_local(self.fid)[:3]
        vf = cache.frame_velocity(self.fid)
        vv, vw = vf[:3], vf[3:]
        ab = cache.frame_bias_acc(self.fid)
        a0 = ab[:3] + cross(vw, vv)
        a0 = a0 + self.gains[0] * (cache.frame_placement(self.fid).p
                                   - self.pref)
        a0 = a0 + self.gains[1] * vv
        return J, a0


class ContactSet(PyTreeNode):
    """Static tuple of contacts; stacks masked (Jc, a0)."""

    contacts: Tuple = field(default_factory=tuple)

    @property
    def nc(self) -> int:
        return sum(c.nc for c in self.contacts)

    def slices(self):
        out, i = [], 0
        for c in self.contacts:
            out.append((i, c.nc))
            i += c.nc
        return out

    def calc(self, cache):
        """Masked stacked (Jc (nc, nv), a0 (nc,), active_rows (nc,))."""
        Js, a0s, masks = [], [], []
        for c in self.contacts:
            J, a0 = c.calc(cache)
            Js.append(J * c.active)
            a0s.append(a0 * c.active)
            masks.append(c.active.expand(c.nc))
        return torch.cat(Js), torch.cat(a0s), torch.cat(masks)
