"""Single-problem DDP / FDDP and their box-constrained variants (port of
crocoddyl_tpu/core/solvers/fddp.py): ``SolverSettings``, ``Trace``,
``Solution``, ``solve``, ``polish`` and the settings factories.

``solve`` runs FDDP and DDP (``feasibility_driven=False``), Box-FDDP and
Box-DDP (``box=True`` with control bounds), the parallel and the sequential
line search, with or without the trace and an ``iter_callback``, on one
segment.  Which passes run follows the problem's structure and the
settings, as the JAX ``use_fscan`` does (fddp.py:557-561), never the device:

- every linearization goes through ``ShootingProblem.calc_diff_full``,
  which takes each stack by its structure: a problem whose nodes the node
  kernel admits is one node-kernel launch over the T+1 nodes (kernel 1); a
  running stack or terminal the kernel admits keeps kernel 1 when the
  other one does not; every other stack (a generic ``RigidBodyNode``, an
  ``ActionModel``) gives its own derivatives;
- with ``fused_scans=True``, for a problem whose nodes the node kernel
  admits, without box: every backward pass and ladder probe is the
  single-problem Riccati pass (kernel 4,
  ``ops/fused_scans.riccati_backward_fused``) and every line-search trial
  one single-problem rollout (kernel 5,
  ``ops/fused_scans.trial_rollout_fused``);
- otherwise (the default ``fused_scans=False``, box, or a node the kernel
  does not admit): the generic backward pass ``_backward_pass`` (with a BoxQP per
  node under box) and the generic trial rollout ``_forward_pass``
  (controls clamped under box; the parallel line search's trials as lanes
  of one pass).

On CUDA tensors the kernels run on the card; the generic passes are plain
PyTorch on whatever device the problem is on.  The JAX version is one
jitted program with ``while_loop``s; here the regularization ladder, the
line search and the iteration loop are Python loops with one host sync per
probe, trial or iteration.  The decisions are the same: same probes, same
accepted steps, same regularization schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...dynamics.model import JointType
from ...dynamics.states import StateMultibody
from ...ops import fused_node as _fn
from ...ops import fused_scans as _fsc
from ...ops.smallchol import cho_solve, chol
from ...utils.struct import tree_leaves, tree_map
from ..action import ActionModel
from ..problem import terminal_calc
from . import boxqp


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration; defaults mirror the JAX package
    (fddp.py:51-134).  ``fused_scans=True`` takes the single-problem
    kernels 4 and 5 where the problem admits them, as the JAX ``use_fscan``
    does; ``parallel_riccati`` and ``ms_chunk`` (with its ``th_gaptol``)
    select paths the port does not have yet and are refused by the solvers
    when set.  ``scan_unroll`` is left out: it tunes XLA loops only."""

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
    parallel_riccati: bool = False
    ms_chunk: int = 0
    th_gaptol: float = 1e-7
    fused_scans: bool = False
    # ``iter_callback(iter, cost, xs)`` after every iteration (fddp.py:805)
    iter_callback: Optional[object] = None
    record_trace: bool = True
    box: bool = False
    qp_maxiter: int = 100
    qp_th_acceptstep: float = 0.1
    qp_th_grad: float = 1e-5
    qp_reg: float = 0.0

    @property
    def alphas(self):
        return [1.0 / (2.0 ** n) for n in range(self.n_alphas)]

    def replace(self, **changes) -> "SolverSettings":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class Trace:
    """Per-iteration diagnostics, the CallbackVerbose columns
    (fddp.py:137-147), each (maxiter,) and NaN (feasible: False) past the
    last iteration."""

    cost: torch.Tensor
    stop: torch.Tensor
    grad: torch.Tensor     # −d1
    xreg: torch.Tensor
    ureg: torch.Tensor
    steplength: torch.Tensor
    feasible: torch.Tensor


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
    trace: Optional[Trace] = None


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


def _refusal(problem, settings: SolverSettings) -> Optional[str]:
    """Why ``solve`` does not take this problem and configuration, or
    None."""
    if settings.ms_chunk:
        return "ms_chunk > 0 (the multiple-shooting forward pass)"
    if settings.parallel_riccati:
        return "parallel_riccati=True (the associative-scan Riccati pass)"
    if len(problem.segments) != 1:
        return f"{len(problem.segments)} segments (one is supported)"
    if (isinstance(problem.running, ActionModel)
            and isinstance(problem.terminal, ActionModel)):
        return None
    return ("a node that is not an ActionModel (a RigidBodyNode, or a model "
            "with its own calc and derivatives)")


def supports(problem, settings: SolverSettings) -> bool:
    """True iff ``solve`` covers this problem and configuration: no
    multiple shooting, no parallel Riccati pass, one segment of
    ``ActionModel``s (``RigidBodyNode`` included) and an ``ActionModel``
    terminal."""
    return _refusal(problem, settings) is None


def _state_ops(problem):
    """Row-wise diff(xa, xb) = xb ⊖ xa and integrate(x, dx) = x ⊕ dx on
    (N, nx) / (N, ndx): the lane functions for a multibody state, the
    state's own for others."""
    st = problem.state
    if not isinstance(st, StateMultibody):
        return st.diff, st.integrate
    has_ff = JointType(st.model.joint_types[0]) == JointType.FREE_FLYER
    nq, nv = st.nq, st.nv

    def diff(xa, xb):
        return _fn._lane_state_diff(has_ff, nq, nv, xa.T, xb.T)[0].T

    def integrate(x, dx):
        return _fn.lane_integrate(has_ff, nq, nv, x.T, dx.T).T
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


def _backward_pass(derivs, dterm, fs, xreg, ureg, box_args=None,
                   probe=False):
    """The generic Riccati backward pass (fddp.py:211-303), a loop over
    reversed time: the Jacobi-equilibrated Cholesky of Quu, and with
    ``box_args`` = (us, u_lb, u_ub, k_warm, use_box, qp_kw) the BoxQP gains
    on the knots where ``use_box[t]`` (a host list: the knot has a finite
    bound and the candidate is feasible, fddp.py:265-279).  The JAX pass
    runs every knot's QP and selects; a knot outside ``use_box`` does not
    read its QP, so it is not run.  Returns (Vx, Vxx, Qu, k, K, Quuk,
    failed), or only ``failed`` with ``probe``."""
    dt, dev = fs.dtype, fs.device
    ndx, T = fs.shape[-1], fs.shape[0] - 1
    nu = derivs.Lu.shape[-1]
    xr, ur = float(xreg), float(ureg)
    eye = torch.eye(ndx, dtype=dt, device=dev)
    eye_u = torch.eye(nu, dtype=dt, device=dev)
    Vxx = VxxT = dterm.Lxx + xr * eye
    Vx = VxT = dterm.Lx + Vxx @ fs[-1]
    failed = _bad(Vx) | _bad(Vxx)
    outs = []
    for t in reversed(range(T)):
        Fx, Fu = derivs.Fx[t], derivs.Fu[t]
        FxT_Vxx = Fx.T @ Vxx
        Qxx = derivs.Lxx[t] + FxT_Vxx @ Fx
        Qx = derivs.Lx[t] + Fx.T @ Vx
        Qxu = derivs.Lxu[t] + FxT_Vxx @ Fu
        Quu = derivs.Luu[t] + Fu.T @ Vxx @ Fu + ur * eye_u
        Qu = derivs.Lu[t] + Fu.T @ Vx
        # Jacobi equilibration: solve (D⁻¹QuuD⁻¹)y = D⁻¹b, D = √diag(Quu)
        dscale = torch.sqrt(torch.clamp(torch.diagonal(Quu), min=1e-30))
        L = chol(Quu / dscale[:, None] / dscale[None, :])
        failed = failed | torch.isnan(L).any()
        K = cho_solve(L, Qxu.T / dscale[:, None]) / dscale[:, None]
        kvec = cho_solve(L, Qu / dscale) / dscale
        if box_args is not None and box_args[4][t]:
            us, u_lb, u_ub, k_warm, _, qp_kw = box_args
            qsol = boxqp.solve(Quu, Qu, u_lb[t] - us[t], u_ub[t] - us[t],
                               k_warm[t], **qp_kw)
            K = qsol.Hff_inv @ Qxu.T
            kvec = -qsol.x
            Qu = torch.where(qsol.free, Qu, torch.zeros_like(Qu))
            failed = failed | qsol.failed
        Quuk = Quu @ kvec
        Vx = Qx + K.T @ Quuk - 2.0 * (K.T @ Qu)
        Vxx = Qxx - Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.T) + xr * eye
        Vx = Vx + Vxx @ fs[t]
        failed = failed | _bad(Vx) | _bad(Vxx)  # ddp.cpp:246-251
        if not probe:
            outs.append((Vx, Vxx, Qu, kvec, K, Quuk))
    if probe:
        return failed
    Vx, Vxx, Qu, kvec, K, Quuk = (torch.stack(o[::-1]) for o in zip(*outs))
    return (torch.cat([Vx, VxT[None]]), torch.cat([Vxx, VxxT[None]]), Qu,
            kvec, K, Quuk, failed)


def _forward_pass(problem, xs, us, k, K, fs, alphas, u_lb=None, u_ub=None):
    """Trial rollouts at the step lengths ``alphas`` (fddp.py:310-355), the
    trials as rows: each knot's nodes are evaluated for all trials at once
    (``ShootingProblem.knot_calc``: one plain lane primal for a lane node,
    the model's ``calc`` under vmap otherwise).  ``fs`` must already be zeroed
    for DDP; with bounds the controls are clamped (box-ddp.cpp:95-97).
    Returns (xs_try (A, T+1, nx), us_try (A, T, nu), cost (A,), failed
    (A,))."""
    diff, integrate = _state_ops(problem)
    A = len(alphas)
    al = torch.tensor(alphas, dtype=xs.dtype, device=xs.device)[:, None]
    gap = al - 1.0
    xnext = problem.x0[None].expand(A, -1)
    cost = xs.new_zeros(A)
    failed = torch.zeros(A, dtype=torch.bool, device=xs.device)
    xs_try, us_try = [], []
    for t in range(problem.T):
        x_try = integrate(xnext, gap * fs[t])
        dx = diff(xs[t][None].expand(A, -1), x_try)
        u_try = us[t] - al * k[t] - dx @ K[t].T
        if u_lb is not None:
            u_try = torch.clamp(u_try, u_lb[t], u_ub[t])
        xnext, c = problem.knot_calc(t, x_try, u_try)
        cost = cost + c
        # raiseIfNaN (fddp.cpp:172-180) on the running cost and the state
        failed = (failed | ~(cost.abs() < 1e30)
                  | ~(xnext.abs().amax(-1) < 1e30))
        xs_try.append(x_try)
        us_try.append(u_try)
    xT = integrate(xnext, gap * fs[-1])
    cost = cost + terminal_calc(problem.terminal, xT)
    failed = failed | ~(cost.abs() < 1e30)
    return (torch.stack(xs_try + [xT], 1), torch.stack(us_try, 1), cost,
            failed)


def solve(problem, xs_init: Optional[torch.Tensor] = None,
          us_init: Optional[torch.Tensor] = None,
          settings: SolverSettings = SolverSettings(),
          is_feasible: bool = False, reginit: Optional[float] = None,
          u_lb=None, u_ub=None, device=None) -> Solution:
    """Solve one shooting problem; mirrors SolverFDDP::solve (fddp.cpp:19-
    105), SolverDDP::solve (ddp.cpp:41-118) with
    ``feasibility_driven=False`` and their box variants with ``box=True``,
    as the JAX ``solve`` does (fddp.py:479-876).  ``u_lb``/``u_ub`` (or the
    segment's own ``u_lb``/``u_ub``) broadcast to (T, nu).  The problem and
    the warm start move to ``device`` (default: the CUDA device) in the
    problem's dtype."""
    s = settings
    why = _refusal(problem, s)
    if why is not None:
        raise ValueError(f"unsupported configuration for solve: {why}")
    dev = resolve_device(device)
    dt = problem.x0.dtype
    problem = cast(problem, dev, dt)
    seg, term = problem.running, problem.terminal
    T, nu = problem.T, problem.nu
    x0 = problem.x0
    fd = s.feasibility_driven
    diff, integrate = _state_ops(problem)
    # the single-problem kernels when asked for, where the structure admits
    # them and there are no bounds (fddp.py:557-561, fused_scans.py:334-340)
    use_fscan = (s.fused_scans and _fsc.supports_problem(problem, s)
                 and problem.on_lanes)

    if s.box:
        if u_lb is None:
            u_lb = getattr(seg, "u_lb", None)
            u_ub = getattr(seg, "u_ub", None)
        if u_lb is None:
            raise ValueError("box solver requires control bounds (u_lb/u_ub)")
        u_lb = torch.as_tensor(u_lb, dtype=dt).to(dev).broadcast_to((T, nu))
        u_ub = torch.as_tensor(u_ub, dtype=dt).to(dev).broadcast_to((T, nu))
        has_limits = (torch.isfinite(u_lb).any(1)
                      | torch.isfinite(u_ub).any(1)).tolist()
        qp_kw = dict(maxiter=s.qp_maxiter, th_acceptstep=s.qp_th_acceptstep,
                     th_grad=s.qp_th_grad, reg=s.qp_reg)
    bounds = (u_lb, u_ub) if s.box else (None, None)

    xs = (x0[None].expand(T + 1, -1) if xs_init is None
          else xs_init.to(device=dev, dtype=dt)).contiguous()
    us = (torch.zeros((T, nu), dtype=dt, device=dev) if us_init is None
          else us_init.to(device=dev, dtype=dt)).contiguous()
    # the regularization lives on the host, in the problem's dtype, as the
    # JAX loop keeps it in dt: the ladder and the schedule branch on it
    reg0 = torch.tensor(s.regmin if reginit is None else reginit, dtype=dt)
    regmax = torch.tensor(s.regmax, dtype=dt)
    regmin = torch.tensor(s.regmin, dtype=dt)
    alphas = s.alphas

    def up(r):
        return torch.minimum(r * s.regfactor, regmax)

    def compute_direction(c):
        """calcDiff, then the regularization ladder (fddp.py:574-664): one
        full pass at the current reg; if it failed, probe reg x10 until a
        pass succeeds or regmax, then one full pass at the final reg.
        Returns (fs, cost, the pass's outputs, the final reg, diverged);
        ureg follows xreg, as in the JAX ladder."""
        derivs, dterm, fs, cost = _calc_diff(problem, c["xs"], c["us"],
                                             c["feasible"])
        if use_fscan:
            def bp(xr, ur, probe=False):
                out = _fsc.riccati_backward_fused(derivs, dterm, fs, xr, ur)
                return out[-1] if probe else out
        else:
            box_args = None
            if s.box:
                use_box = [h and c["feasible"] for h in has_limits]
                box_args = (c["us"], u_lb, u_ub, c["k"], use_box, qp_kw)

            def bp(xr, ur, probe=False):
                return _backward_pass(derivs, dterm, fs, xr, ur, box_args,
                                      probe)

        xreg = c["xreg"]
        res0 = bp(xreg, c["ureg"])
        pend = bool(res0[-1]) and bool(xreg < regmax)
        xr = up(xreg) if pend else xreg
        while pend:
            pend = bool(bp(xr, xr, probe=True)) and bool(xr < regmax)
            if pend:
                xr = up(xr)
        # the redo predicate looks at xreg only (fddp.py:659)
        res = bp(xr, xr) if bool(xr != xreg) else res0
        diverged = c["diverged"] or bool(res[-1])
        return fs, cost, res, xr, diverged

    def trial_rollouts(c, fs_fwd, k, K, alphas_):
        """[(xs_try, us_try, cost_try, failed)] at each step length: kernel
        5 for the T running knots and the terminal node here, one launch a
        trial, or the generic pass over all of them at once."""
        if not use_fscan:
            out = _forward_pass(problem, c["xs"], c["us"], k, K, fs_fwd,
                                alphas_, *bounds)
            return [tuple(o[i] for o in out) for i in range(len(alphas_))]
        out = []
        for alpha in alphas_:
            xs_r, us_r, x_last, cost_r, failed = _fsc.trial_rollout_fused(
                seg, x0, c["xs"], c["us"], k, K, fs_fwd, alpha)
            xT = integrate(x_last[None], (alpha - 1.0) * fs_fwd[-1:])
            cost_try = cost_r + terminal_calc(term, xT)[0]
            xT = xT[0]
            out.append((torch.cat([xs_r, xT[None]], 0), us_r, cost_try,
                        failed | _bad(cost_try)))
        return out

    def judge(c, alpha, trial, fs, cost, Vxx, dg, dq):
        """Acceptance of one trial (fddp.py:700-720): (accept, d0, d1)."""
        xs_try, _, cost_try, failed = trial
        dV = cost - cost_try
        failed = failed | (cost_try > s.th_blowup * (1.0 + cost.abs()))
        if fd:
            # fddp.cpp:107-124 expectedImprovement at the trial point
            dx = diff(xs_try, c["xs"])
            dv = -(fs * torch.einsum("tij,tj->ti", Vxx, dx)).sum()
            d0, d1 = dg + dv, dq - 2.0 * dv
        else:
            d0, d1 = dg, dq
        dVexp = alpha * (d0 + 0.5 * alpha * d1)
        if fd:
            pos = (dVexp >= 0) & ((d0 < s.th_grad)
                                   | (dV > s.th_acceptstep * dVexp))
            neg = (dVexp < 0) & (dV > s.th_acceptnegstep * dVexp)
            accept = pos | neg
        else:
            accept = (dVexp >= 0) & ((d0 < s.th_grad) | (not c["feasible"])
                                     | (dV > s.th_acceptstep * dVexp))
        return accept & ~failed, d0, d1

    def line_search(c, fs, cost, res, dg, dq):
        """The step (fddp.py:675-769): (accepted trial or None, steplength,
        d0, d1).  The parallel search evaluates every α and takes the first
        accepted; with none, steplength is the last α and d0/d1 are the
        first trial's (fddp.py:722-727).  The kernel path runs the trials
        one at a time and stops at the first accepted, with the same picks.
        The sequential search stops at the first accepted; with none, d0/d1
        are the last trial's (fddp.py:731-749)."""
        Vx, Vxx, Qu, k, K, _, _ = res
        fs_fwd = fs if fd else torch.zeros_like(fs)
        if s.parallel_linesearch and not use_fscan:
            trials = trial_rollouts(c, fs_fwd, k, K, alphas)
            judged = [judge(c, a, tr, fs, cost, Vxx, dg, dq)
                      for a, tr in zip(alphas, trials)]
            acc = torch.stack([torch.as_tensor(j[0]) for j in judged])
            acc = acc.tolist()
        else:
            trials, judged, acc = [], [], []
            for a in alphas:
                trials += trial_rollouts(c, fs_fwd, k, K, [a])
                judged.append(judge(c, a, trials[-1], fs, cost, Vxx, dg, dq))
                acc.append(bool(judged[-1][0]))
                if acc[-1]:
                    break
        if any(acc):
            i = acc.index(True)
            return trials[i], alphas[i], judged[i][1], judged[i][2]
        j = judged[0] if s.parallel_linesearch else judged[-1]
        return None, alphas[-1], j[1], j[2]

    def iteration(c):
        """compute_direction, expected improvement, line search,
        regularization schedule, trace, callback and the convergence test
        (fddp.py:797-815).  Returns the new carry and the pre-step
        direction."""
        fs, cost, res, xreg, diverged = compute_direction(c)
        Vx, Vxx, Qu, k, K, Quuk, _ = res
        # expected improvement (fddp.py:666-673)
        dg = (Qu * k).sum()
        dq = -(k * Quuk).sum()
        if fd:
            dg = dg - (Vx * fs).sum()
            dq = dq + (fs * torch.einsum("tij,tj->ti", Vxx, fs)).sum()
        trial, steplength, d0, d1 = line_search(c, fs, cost, res, dg, dq)
        xs_n, us_n, cost_n = ((c["xs"], c["us"], cost) if trial is None
                              else trial[:3])
        feasible, was_feasible = c["feasible"], c["was_feasible"]
        if trial is not None:
            was_feasible = feasible
            feasible = ((c["was_feasible"] or steplength == 1.0) if fd
                        else True)
        # regularization schedule (fddp.py:771-779)
        inc = steplength <= s.th_stepinc
        if steplength > s.th_stepdec:
            xreg = torch.maximum(xreg / s.regfactor, regmin)
        if inc:
            xreg = up(xreg)
        diverged = diverged or (inc and bool(xreg >= regmax))
        stop = (Qu ** 2).sum()
        c = dict(xs=xs_n, us=us_n, feasible=feasible,
                 was_feasible=was_feasible, xreg=xreg, ureg=xreg,
                 cost=cost_n, steplength=steplength, d0=d0, d1=d1, stop=stop,
                 k=k, iter=c["iter"], diverged=diverged,
                 trace=c["trace"])
        if s.record_trace:
            c["trace"].append((cost_n, stop, -d1, xreg, xreg, steplength,
                               feasible))
        if s.iter_callback is not None:
            s.iter_callback(c["iter"], cost_n, xs_n)
        c["converged"] = was_feasible and bool(stop < s.th_stop)
        c["iter"] += 1
        return c, (fs, res)

    c = dict(xs=xs, us=us, feasible=bool(is_feasible), was_feasible=False,
             xreg=reg0, ureg=reg0, cost=torch.zeros((), dtype=dt, device=dev),
             steplength=1.0, d0=torch.zeros((), dtype=dt, device=dev),
             d1=torch.zeros((), dtype=dt, device=dev),
             stop=torch.full((), float("inf"), dtype=dt, device=dev),
             k=torch.zeros((T, nu), dtype=dt, device=dev), iter=0,
             converged=False, diverged=False, trace=[])
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
        fs, cost, res, _, _ = compute_direction(c)
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
        diverged=sc(c["diverged"], torch.bool),
        trace=_trace(c["trace"], s.maxiter, dt, dev) if s.record_trace
        else None)


def _trace(rows, maxiter, dt, dev) -> Trace:
    """The recorded rows (cost, stop, grad, xreg, ureg, steplength,
    feasible) as a Trace of (maxiter,) tensors, NaN (False) past the last
    iteration (fddp.py:524-530, 781-795)."""
    cols = []
    for i, name in enumerate(("cost", "stop", "grad", "xreg", "ureg",
                              "steplength", "feasible")):
        kind = torch.bool if name == "feasible" else dt
        col = (torch.zeros(maxiter, dtype=kind, device=dev)
               if kind == torch.bool else
               torch.full((maxiter,), float("nan"), dtype=dt, device=dev))
        if rows:
            col[:len(rows)] = torch.stack([
                torch.as_tensor(r[i], dtype=kind).to(dev) for r in rows])
        cols.append(col)
    return Trace(*cols)


def polish(problem, solution: Solution, iters: int = 2,
           dtype=torch.float64, settings: Optional[SolverSettings] = None,
           device=None) -> Solution:
    """Mixed-precision refinement (fddp.py:879-896): warm-start a few
    iterations in ``dtype`` from a (float32) solution."""
    from ...utils.casting import cast_floats
    s = settings if settings is not None else SolverSettings(
        th_stop=1e-9, record_trace=False)
    return solve(cast_floats(problem, dtype),
                 xs_init=solution.xs.to(dtype), us_init=solution.us.to(dtype),
                 settings=s.replace(maxiter=iters), device=device)


def ddp_settings(**kw) -> SolverSettings:
    return SolverSettings(feasibility_driven=False, **kw)


def fddp_settings(**kw) -> SolverSettings:
    return SolverSettings(feasibility_driven=True, **kw)


def box_ddp_settings(**kw) -> SolverSettings:
    kw.setdefault("th_stop", 5e-5)  # box-ddp.cpp:28
    return SolverSettings(feasibility_driven=False, box=True, **kw)


def box_fddp_settings(**kw) -> SolverSettings:
    kw.setdefault("th_stop", 5e-5)  # box-fddp.cpp:28
    return SolverSettings(feasibility_driven=True, box=True, **kw)
