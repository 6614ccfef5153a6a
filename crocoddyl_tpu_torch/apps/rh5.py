"""RH5 thesis analysis: per-foot centres of pressure, the whole-body ZMP and
the CSV log of a solution (port of crocoddyl_tpu/apps/rh5.py).

The thesis checks contact stability by comparing each foot's centre of
pressure (from its contact wrench) and the whole-body zero-moment point
(from the gravito-inertial wrench) with the support polygon.  Everything
is computed after the solve from the solution's trajectories: the node's
dynamics at each knot for the contact wrenches, and
``algorithms.centroidal_momentum`` under ``torch.func.vmap`` along the
states, whose forward difference gives the momentum rate of the ZMP.  A
problem may have several segments (the true-impulse gaits): an impulse
knot has no contact wrench of its own, and its duration is zero.
"""

from __future__ import annotations

import csv
from typing import List, Optional

import numpy as np
import torch

from ..dynamics import algorithms as algo
from ..utils.struct import tree_map


def _np(a) -> np.ndarray:
    return a.detach().cpu().numpy().astype(np.float64)


def calc_cops(problem, sol) -> List[dict]:
    """Per knot and active 6D contact, the centre of pressure in the sole
    frame, CoP = (−τ_y/f_z, τ_x/f_z, 0) (rh5.py:27-59): a list of dicts
    {t, contact_idx, f (6,), cop (3,)}, over every segment that has
    contacts (an impulse segment has none)."""
    out = []
    for seg, (i, j) in zip(problem.segments, problem._seg_slices()):
        if (getattr(seg, "contacts", None) is None
                or not seg.contacts.contacts):
            continue
        for t in range(i, j):
            m = tree_map(lambda l: l[t - i], seg)
            _, cache = m._dynamics(sol.xs[t], sol.us[t])
            for ci, c in enumerate(m.contacts.contacts):
                if c.nc != 6 or float(c.active) == 0.0:
                    continue
                f = _np(cache.forces[ci])            # local (lin, ang)
                fz = f[2] if abs(f[2]) > 1e-9 else 1e-9
                out.append(dict(t=t, contact_idx=ci, f=f,
                                cop=np.array([-f[4] / fz, f[3] / fz, 0.0])))
    return out


def calc_zmps(problem, sol, dts: Optional[np.ndarray] = None) -> np.ndarray:
    """Whole-body ZMP per knot from the gravito-inertial wrench
    (rh5.py:62-108): f_gi = m·g − dh_lin/dt, τ_gi = −dh_ang/dt at the CoM,
    ZMP = (−τ_gi,y/f_gi,z, τ_gi,x/f_gi,z, 0), with the momentum rate the
    forward difference of h(q, v) along the trajectory (a dt=0 knot, and
    an impulse knot, keeps the previous rate).  Returns (T, 3)."""
    m = problem.state.model
    nq = problem.state.nq
    h = _np(torch.func.vmap(
        lambda x: algo.centroidal_momentum(m, x[:nq], x[nq:]))(sol.xs))
    if dts is None:
        dts = np.concatenate([
            np.zeros(n) if getattr(seg, "dt", None) is None
            else np.broadcast_to(_np(seg.dt).reshape(-1), (n,))
            for seg, n in zip(problem.segments, problem.seg_lengths)])
    dts = np.asarray(dts, np.float64)
    mass = float(_np(m.mass).sum())
    g = _np(m.gravity)
    T = h.shape[0] - 1
    zmps = np.zeros((T, 3))
    dh_prev = np.zeros(6)
    for k in range(T):
        if dts[k] > 0:
            dh = (h[k + 1] - h[k]) / dts[k]
            dh_prev = dh
        else:
            dh = dh_prev
        f_gi = mass * g - dh[:3]
        tau_gi = -dh[3:]
        fz = f_gi[2] if abs(f_gi[2]) > 1e-9 else 1e-9
        zmps[k] = [-tau_gi[1] / fz, tau_gi[0] / fz, 0.0]
    return zmps


def log_solution_csv(problem, sol, path: str,
                     dts: Optional[np.ndarray] = None) -> str:
    """Per-knot CSV of state, control, CoM, ZMP and the first two feet's
    CoPs (rh5.py:111-141); returns ``path``."""
    m = problem.state.model
    nq = problem.state.nq
    xs, us = _np(sol.xs), _np(sol.us)
    coms = _np(torch.func.vmap(
        lambda x: algo.center_of_mass(m, x[:nq]))(sol.xs))
    zmps = calc_zmps(problem, sol, dts)
    cop_by_t = {}
    for rec in calc_cops(problem, sol):
        cop_by_t.setdefault(rec["t"], {})[rec["contact_idx"]] = rec["cop"]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t"] + [f"x{i}" for i in range(xs.shape[1])]
                   + [f"u{i}" for i in range(us.shape[1])]
                   + ["com_x", "com_y", "com_z", "zmp_x", "zmp_y"]
                   + ["cop0_x", "cop0_y", "cop1_x", "cop1_y"])
        for t in range(us.shape[0]):
            c = cop_by_t.get(t, {})
            c0 = c.get(0, [np.nan] * 3)
            c1 = c.get(1, [np.nan] * 3)
            w.writerow([t] + list(xs[t]) + list(us[t]) + list(coms[t])
                       + list(zmps[t][:2]) + [c0[0], c0[1], c1[0], c1[1]])
    return path
