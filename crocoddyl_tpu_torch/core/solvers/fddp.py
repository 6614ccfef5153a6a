"""Single-problem FDDP (port of crocoddyl_tpu/core/solvers/fddp.py):
``SolverSettings``, ``Solution`` and ``solve``, the b=1 MPC replan.

Scope of ``solve``: feasibility-driven FDDP, no control bounds, sequential
line search, no trace, one segment whose node structure the node kernel
covers (``supports``).  On CUDA tensors one iteration runs three kernels:
the node linearization of the T+1 nodes (kernel 1, through
``ShootingProblem.calc_diff_full``), the Riccati pass for every backward
pass and ladder probe (kernel 4, ``ops/fused_scans.riccati_backward_fused``)
and one rollout per line-search trial (kernel 5,
``ops/fused_scans.trial_rollout_fused``).  The JAX version is one jitted
program with ``while_loop``s; here the regularization ladder, the line
search and the iteration loop are Python loops with one host sync per
probe, trial or iteration.  The decisions are the same: same probes, same
accepted steps, same regularization schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...dynamics.model import JointType
from ...ops import fused_node as _fn
from ...ops import fused_scans as _fsc
from ...utils.struct import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration; defaults mirror the JAX package.  The
    JAX fields that select paths the port does not have (parallel Riccati,
    fused scans, callbacks) are left out; ``box``, ``parallel_linesearch``,
    ``record_trace`` and ``ms_chunk`` stay so that the solvers can refuse
    them."""

    maxiter: int = 100
    feasibility_driven: bool = True
    th_acceptstep: float = 0.1
    th_stop: float = 1e-9
    th_grad: float = 1e-12
    th_stepdec: float = 0.5
    th_stepinc: float = 0.01
    th_acceptnegstep: float = 2.0
    th_blowup: float = 1e6
    regfactor: float = 10.0
    regmin: float = 1e-9
    regmax: float = 1e9
    n_alphas: int = 10
    parallel_linesearch: bool = True
    ms_chunk: int = 0
    record_trace: bool = True
    box: bool = False

    @property
    def alphas(self):
        return [1.0 / (2.0 ** n) for n in range(self.n_alphas)]


@dataclasses.dataclass
class Solution:
    """Solver output.  From ``solve`` (one problem) the leaves have the
    shapes below and the scalars are 0-d tensors; from ``solve_batch``
    every leaf carries a leading problem axis B.  The direction fields (K,
    k, Vx, Vxx, Qu, fs) belong to the returned trajectory, except from
    ``solve`` with ``maxiter == 1``, where they belong to the candidate
    before the step (fddp.py:817-866)."""

    xs: torch.Tensor          # (T+1, nx)
    us: torch.Tensor          # (T, nu)
    K: torch.Tensor           # (T, nu, ndx) feedback gains
    k: torch.Tensor           # (T, nu) feedforward
    Vx: torch.Tensor          # (T+1, ndx)
    Vxx: torch.Tensor         # (T+1, ndx, ndx)
    Qu: torch.Tensor          # (T, nu)
    fs: torch.Tensor          # (T+1, ndx) gaps
    cost: torch.Tensor
    stop: torch.Tensor
    xreg: torch.Tensor
    ureg: torch.Tensor
    steplength: torch.Tensor
    d0: torch.Tensor
    d1: torch.Tensor
    iter: torch.Tensor
    is_feasible: torch.Tensor
    converged: torch.Tensor
    diverged: torch.Tensor


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: the CUDA device unless the caller
    names another (``device="cpu"`` runs the plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the solvers run on the card by default; "
                "pass device='cpu' to run the plain PyTorch versions on the "
                "CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def cast(tree, device, dtype):
    """``tree`` with its floating leaves on (device, dtype) and its other
    leaves on device; the tree itself when nothing moves, so that the
    kernel descriptors built for it are reused."""
    leaves = tree_leaves(tree)
    if all(l.device == device and (l.dtype == dtype
                                   or not l.is_floating_point())
           for l in leaves):
        return tree
    return tree_map(lambda l: l.to(device=device, dtype=dtype)
                    if l.is_floating_point() else l.to(device), tree)


def _bad(x) -> torch.Tensor:
    """The reference's raiseIfNaN predicate (solver-base.cpp:175-178): true
    for NaN, inf, or magnitude >= 1e30 (fddp.py:44-48)."""
    return ~(x.abs().max() < 1e30)


def supports(problem, settings: SolverSettings) -> bool:
    """True iff ``solve`` covers this problem and configuration: FDDP, no
    control bounds, sequential line search, no trace, no multiple
    shooting, one segment (and the terminal node) whose structure the node
    kernel covers."""
    s = settings
    if (s.box or not s.feasibility_driven or s.parallel_linesearch
            or s.record_trace or s.ms_chunk):
        return False
    return (_fsc.supports_problem(problem, s)
            and _fn.supports(problem.terminal))


def _state_ops(problem):
    st = problem.state
    has_ff = JointType(st.model.joint_types[0]) == JointType.FREE_FLYER
    nq, nv = st.nq, st.nv

    def diff(xa, xb):
        """xb ⊖ xa, rows of (N, nx) -> (N, ndx)."""
        return _fn._lane_state_diff(has_ff, nq, nv, xa.T, xb.T)[0].T

    def integrate(x, dx):
        """x ⊕ dx for one state."""
        return _fn.lane_integrate(has_ff, nq, nv, x[:, None],
                                  dx[:, None])[:, 0]
    return diff, integrate


def _calc_diff(problem, xs, us, feasible: bool):
    """Derivatives, gaps and cost at the candidate (fddp.py:464-472)."""
    diff, _ = _state_ops(problem)
    derivs, dterm, xnexts, costs = problem.calc_diff_full(xs, us)
    cost = costs.sum()
    f0 = diff(xs[:1], problem.x0[None])
    frest = diff(xs[1:], xnexts)
    fs = torch.cat([f0, frest], 0)
    if feasible:
        fs = torch.zeros_like(fs)
    return derivs, dterm, fs, cost


def solve(problem, xs_init: Optional[torch.Tensor] = None,
          us_init: Optional[torch.Tensor] = None,
          settings: SolverSettings = SolverSettings(),
          is_feasible: bool = False, reginit: Optional[float] = None,
          device=None) -> Solution:
    """Solve one shooting problem; mirrors SolverFDDP::solve (fddp.cpp:19-
    105) as the JAX ``solve`` does (fddp.py:479-876), in the scope of
    :func:`supports`.  The problem and the warm start move to ``device``
    (default: the CUDA device) in the problem's dtype."""
    s = settings
    if not supports(problem, s):
        raise ValueError("unsupported configuration for solve: FDDP without "
                         "bounds, sequential line search, no trace, no "
                         "ms_chunk, one segment the node kernel covers")
    dev = resolve_device(device)
    dt = problem.x0.dtype
    problem = cast(problem, dev, dt)
    seg, term = problem.segments[0], problem.terminal
    T, nu = problem.T, problem.nu
    x0 = problem.x0
    diff, integrate = _state_ops(problem)

    xs = (x0[None].expand(T + 1, -1) if xs_init is None
          else xs_init.to(device=dev, dtype=dt)).contiguous()
    us = (torch.zeros((T, nu), dtype=dt, device=dev) if us_init is None
          else us_init.to(device=dev, dtype=dt)).contiguous()
    # the regularization lives on the host, in the problem's dtype, as the
    # JAX loop keeps it in dt: the ladder and the schedule branch on it
    reg0 = torch.tensor(s.regmin if reginit is None else reginit, dtype=dt)
    regmax = torch.tensor(s.regmax, dtype=dt)
    regmin = torch.tensor(s.regmin, dtype=dt)

    def up(r):
        return torch.minimum(r * s.regfactor, regmax)

    def compute_direction(xs, us, feasible, xreg, ureg, diverged):
        """calcDiff, then the regularization ladder (fddp.py:574-664): one
        full pass at the current reg; if it failed, probe reg x10 until a
        pass succeeds or regmax, then one full pass at the final reg.
        Returns (fs, cost, the pass's outputs, the final reg, diverged);
        ureg follows xreg, as in the JAX ladder."""
        derivs, dterm, fs, cost = _calc_diff(problem, xs, us, feasible)

        def bp(xr, ur):
            return _fsc.riccati_backward_fused(derivs, dterm, fs, xr, ur)

        res0 = bp(xreg, ureg)
        pend = bool(res0[-1]) and bool(xreg < regmax)
        xr = up(xreg) if pend else xreg
        while pend:
            pend = bool(bp(xr, xr)[-1]) and bool(xr < regmax)
            if pend:
                xr = up(xr)
        # the redo predicate looks at xreg only (fddp.py:659)
        res = bp(xr, xr) if bool(xr != xreg) else res0
        diverged = diverged or bool(res[-1])
        return fs, cost, res, xr, diverged

    def trial(alpha, xs, us, fs, cost, Vxx, k, K, dg, dq):
        """One line-search trial (fddp.py:680-720): kernel 5 for the T
        running knots, the terminal node here."""
        xs_r, us_r, x_last, cost_r, failed = _fsc.trial_rollout_fused(
            seg, x0, xs, us, k, K, fs, alpha)
        xT = integrate(x_last, (alpha - 1.0) * fs[-1])
        cost_try = cost_r + term.calc_terminal(xT)
        failed = failed | _bad(cost_try)
        xs_try = torch.cat([xs_r, xT[None]], 0)
        dV = cost - cost_try
        failed = failed | (cost_try > s.th_blowup * (1.0 + cost.abs()))
        dx = diff(xs_try, xs)
        dv = -(fs * torch.einsum("tij,tj->ti", Vxx, dx)).sum()
        d0 = dg + dv
        d1 = dq - 2.0 * dv
        dVexp = alpha * (d0 + 0.5 * alpha * d1)
        pos = (dVexp >= 0) & ((d0 < s.th_grad)
                               | (dV > s.th_acceptstep * dVexp))
        neg = (dVexp < 0) & (dV > s.th_acceptnegstep * dVexp)
        return xs_try, us_r, cost_try, (pos | neg) & ~failed, d0, d1

    def iteration(c):
        """compute_direction, expected improvement, line search,
        regularization schedule and the convergence test (fddp.py:797-
        815).  Returns the new carry and the pre-step direction."""
        fs, cost, res, xreg, diverged = compute_direction(
            c["xs"], c["us"], c["feasible"], c["xreg"], c["ureg"],
            c["diverged"])
        Vx, Vxx, Qu, k, K, Quuk, _ = res
        # expected improvement (fddp.py:666-673)
        dg = (Qu * k).sum() - (Vx * fs).sum()
        dq = -(k * Quuk).sum() + (fs * torch.einsum("tij,tj->ti", Vxx,
                                                    fs)).sum()
        # sequential backtracking (fddp.py:731-749): d0/d1 of the last trial
        alphas = s.alphas
        for i, alpha in enumerate(alphas):
            xs_t, us_t, cost_t, accept, d0, d1 = trial(
                alpha, c["xs"], c["us"], fs, cost, Vxx, k, K, dg, dq)
            acc = bool(accept)
            if acc:
                break
        steplength = alphas[min(i, len(alphas) - 1)]
        xs_n, us_n, cost_n = ((xs_t, us_t, cost_t) if acc
                              else (c["xs"], c["us"], cost))
        feasible, was_feasible = c["feasible"], c["was_feasible"]
        if acc:
            was_feasible, feasible = feasible, (was_feasible
                                                or steplength == 1.0)
        # regularization schedule (fddp.py:771-779)
        inc = steplength <= s.th_stepinc
        if steplength > s.th_stepdec:
            xreg = torch.maximum(xreg / s.regfactor, regmin)
        if inc:
            xreg = up(xreg)
        diverged = diverged or (inc and bool(xreg >= regmax))
        stop = (Qu ** 2).sum()
        converged = was_feasible and bool(stop < s.th_stop)
        c = dict(xs=xs_n, us=us_n, feasible=feasible,
                 was_feasible=was_feasible, xreg=xreg, ureg=xreg,
                 cost=cost_n, steplength=steplength, d0=d0, d1=d1, stop=stop,
                 iter=c["iter"] + 1, converged=converged, diverged=diverged)
        return c, (fs, res)

    c = dict(xs=xs, us=us, feasible=bool(is_feasible), was_feasible=False,
             xreg=reg0, ureg=reg0, cost=torch.zeros((), dtype=dt, device=dev),
             steplength=1.0, d0=torch.zeros((), dtype=dt, device=dev),
             d1=torch.zeros((), dtype=dt, device=dev),
             stop=torch.full((), float("inf"), dtype=dt, device=dev), iter=0,
             converged=False, diverged=False)
    if s.maxiter == 1:
        # the MPC replan: the direction fields are the pre-step candidate's
        c, (fs, res) = iteration(c)
        cost = c["cost"]
    else:
        while (c["iter"] < s.maxiter and not c["converged"]
               and not c["diverged"]):
            c, _ = iteration(c)
        # the direction at the returned trajectory; its ladder must not
        # overwrite the loop's xreg/ureg/diverged (fddp.py:857-863)
        fs, cost, res, _, _ = compute_direction(
            c["xs"], c["us"], c["feasible"], c["xreg"], c["ureg"],
            c["diverged"])
    Vx, Vxx, Qu, k, K, _, _ = res

    def sc(v, dtype=dt):
        return torch.as_tensor(v, dtype=dtype).to(dev)
    return Solution(
        xs=c["xs"], us=c["us"], K=K, k=k, Vx=Vx, Vxx=Vxx, Qu=Qu, fs=fs,
        cost=cost, stop=c["stop"], xreg=sc(c["xreg"]), ureg=sc(c["ureg"]),
        steplength=sc(c["steplength"]), d0=c["d0"], d1=c["d1"],
        iter=sc(c["iter"], torch.int32),
        is_feasible=sc(c["feasible"], torch.bool),
        converged=sc(c["converged"], torch.bool),
        diverged=sc(c["diverged"], torch.bool))
