"""Batch-native FDDP: B problems solved together in lane layout (port of
crocoddyl_tpu/core/solvers/fddp_batch.py).

The data parallelism is the trailing lane axis of three kernels:

- node linearization over all B·(T+1) nodes, the terminal node included
  as B dt=0 nodes (``ops/fused_node.calc_both_lanes``);
- the Riccati backward pass (``ops/fused_scans.riccati_backward_lanes``);
- the trial rollout (``ops/fused_scans.trial_rollout_lanes``).

As in the JAX version, one jitted program with ``while_loop``s, every
decision is a (B,) tensor on the device and the loops run on
``control.while_loop``/``control.cond``: eagerly, one host read of each
predicate, or recorded by ``torch.export`` (``utils/aot.export_bytes``).
The decisions are the JAX ones: same candidates, same accepted steps, same
regularization schedule.  Scope: feasibility-driven FDDP, no control
bounds, one segment whose structure the node kernel supports, sequential
line search, no trace.
"""

from __future__ import annotations

from typing import Optional

import torch

from ...dynamics.model import JointType
from ...ops import fused_node as _fn
from ...ops import fused_scans as _fsc
from ...utils.struct import tree_map
from . import control
from .fddp import Solution, SolverSettings, cast, resolve_device


def supports(problem, settings: SolverSettings) -> bool:
    """Gate of ``solve_batch`` (fddp_batch.py:42-50): feasibility-driven,
    no box, sequential line search, no parallel Riccati pass, no multiple
    shooting, no trace and no iteration callback, one segment whose
    structure the node kernel admits."""
    s = settings
    if (s.box or not s.feasibility_driven or s.parallel_linesearch
            or s.parallel_riccati or s.record_trace or s.ms_chunk
            or s.iter_callback is not None):
        return False
    return (len(problem.segments) == 1 and _fn.supports(problem.segments[0])
            and _fn.supports(problem.terminal))


def solve_batch(problem, x0s, xs_init: Optional[torch.Tensor] = None,
                us_init: Optional[torch.Tensor] = None,
                settings: SolverSettings = SolverSettings(),
                is_feasible: bool = False,
                reginit: Optional[float] = None, device=None) -> Solution:
    """Solve B instances of ``problem``, one per row of x0s (B, nx), from a
    shared or per-problem warm start.  Returns a Solution whose leaves carry
    a leading B axis.  Semantics == JAX ``solve_batch``.  The problem, x0s
    and the warm start move to ``device`` (default: the CUDA device) in the
    dtype of x0s.

    The decisions are (B,) tensors on the device, taken by
    ``control.while_loop``/``control.cond`` where JAX's program takes them
    (fddp_batch.py): the ladder's retries while some lane's probe failed
    (:179) and the redo of the full pass where a lane's regularization
    moved; the α ladder while some active lane has accepted no step (:250);
    the iteration loop while some lane is active (:293)."""
    s = settings
    if not supports(problem, s):
        raise ValueError("unsupported configuration for solve_batch")
    dev = resolve_device(device)
    x0s = x0s.to(dev)
    problem = cast(problem, dev, x0s.dtype)
    seg = problem.segments[0]
    st = problem.state
    T = problem.T
    nx, ndx, nu, nq, nv = st.nx, st.ndx, problem.nu, st.nq, st.nv
    B = x0s.shape[0]
    dt, dev = x0s.dtype, x0s.device
    has_ff = JointType(st.model.joint_types[0]) == JointType.FREE_FLYER

    x0_l = x0s.T.contiguous()
    if xs_init is None:
        xs_init = x0s[:, None].expand(B, T + 1, nx)
    if us_init is None:
        us_init = torch.zeros((B, T, nu), dtype=dt, device=dev)
    if xs_init.ndim == 2:
        xs_init = xs_init[None].expand(B, T + 1, nx)
    if us_init.ndim == 2:
        us_init = us_init[None].expand(B, T, nu)
    xs_l0 = xs_init.to(device=dev, dtype=dt).movedim(0, -1).contiguous()
    us_l0 = us_init.to(device=dev, dtype=dt).movedim(0, -1).contiguous()

    # the node-kernel launch covers T running knots + the terminal knot as
    # a dt=0 node (core/problem.py:171-184 convention)
    knots = problem.knots
    # the kernels' descriptors on the card, built once outside the loops
    _fn.prepare(knots, x0s)
    _fn.prepare(seg, x0s)
    term = tree_map(lambda l: l[T:T + 1], knots)
    u_term = torch.zeros((1, nu, B), dtype=dt, device=dev)

    def nodes_of(a_l):
        """(K, d, B) -> (d, K*B) (k-major node lanes)."""
        return a_l.movedim(0, 1).reshape(a_l.shape[1], -1)

    def unnodes(a_n):
        """(d, K*B) -> (K, d, B)."""
        return a_n.reshape(a_n.shape[0], -1, B).movedim(1, 0)

    def full(v, dtype=dt):
        return torch.full((B,), v, dtype=dtype, device=dev)

    reg0 = full(s.regmin if reginit is None else reginit)
    alphas = torch.tensor(s.alphas, dtype=dt, device=dev)

    def lane_diff(xa_n, xb_n):
        return _fn.state_diff(has_ff, nq, nv, xa_n, xb_n)

    def calc_diff(xs_l, us_l, feasible):
        u_all = torch.cat([us_l, u_term], 0)
        derivs_n, xnext_n, cost_n = _fn.calc_both_lanes(
            knots, nodes_of(xs_l), nodes_of(u_all))
        derivs_all = tree_map(
            lambda a: a.reshape(a.shape[:-1] + (T + 1, B)).movedim(-2, 0),
            derivs_n)
        derivs_l = tree_map(lambda a: a[:T], derivs_all)
        dterm_l = tree_map(lambda a: a[T], derivs_all)
        xnext_l = unnodes(xnext_n)[:T]
        cost_k = cost_n.reshape(T + 1, B)
        cost = cost_k[:T].sum(0) + cost_k[T]
        f0 = lane_diff(xs_l[0], x0_l)
        frest = unnodes(lane_diff(nodes_of(xs_l[1:]), nodes_of(xnext_l)))
        fs_l = torch.cat([f0[None], frest], 0)
        fs_l = torch.where(feasible[None, None], torch.zeros_like(fs_l), fs_l)
        return derivs_l, dterm_l, fs_l, cost

    def iteration(c):
        (xs_l, us_l, feasible, was_feasible, xreg, ureg, cost, steplength,
         d0_o, d1_o, stop_o, it_b, conv, div, active) = c
        derivs_l, dterm_l, fs_l, cost_new = calc_diff(xs_l, us_l, feasible)
        cost = torch.where(active, cost_new, cost)

        def backward(xr, ur):
            return _fsc.riccati_backward_lanes(derivs_l, dterm_l, fs_l, xr,
                                               ur)

        # regularization ladder (ddp.cpp:56-70): one full pass at the current
        # reg; only if some lane failed, probe the final reg (one host sync
        # per probe) and re-run the full pass.  pend0 is not masked by
        # `active`, as in fddp_batch.py:165.
        res0 = backward(xreg, ureg)
        pend0 = res0[-1] & (xreg < s.regmax)

        def retry(rc):
            xr, pend = rc
            pend = backward(xr, xr)[-1] & pend & (xr < s.regmax)
            return (torch.where(pend, torch.clamp(xr * s.regfactor,
                                                  max=s.regmax), xr), pend)
        xr, _ = control.while_loop(
            lambda rc: rc[1].any(), retry,
            (torch.where(pend0, torch.clamp(xreg * s.regfactor,
                                            max=s.regmax), xreg), pend0))
        xreg_m = torch.where(active, xr, xreg)
        ureg_m = torch.where(active, xr, ureg)
        res = control.cond(((xreg_m != xreg) | (ureg_m != ureg)).any(),
                           lambda _: backward(xreg_m, ureg_m),
                           lambda _: res0)
        xreg, ureg = xreg_m, ureg_m
        Vx_l, Vxx_l, Qu_l, k_l, K_l, Quuk_l, failed = res
        div = div | (active & failed)

        # expected improvement (fddp.cpp:126-147)
        dg = (Qu_l * k_l).sum((0, 1)) - (Vx_l * fs_l).sum((0, 1))
        Vxx_fs = (Vxx_l * fs_l[:, None]).sum(2)
        dq = -(k_l * Quuk_l).sum((0, 1)) + (fs_l * Vxx_fs).sum((0, 1))

        def trial(alpha):
            xs_r, us_r, x_last, cost_r, fail_t = _fsc.trial_rollout_lanes(
                seg, x0_l, xs_l[:-1], us_l, k_l, K_l, fs_l[:-1], fs_l[-1],
                alpha)
            xT = _fn.state_integrate(has_ff, nq, nv, x_last,
                                    (alpha - 1.0) * fs_l[-1])
            # terminal trial cost: the port's lane primal on the dt=0
            # terminal knot (plain tensor code, as the JAX package computes
            # it outside any kernel)
            cterm = _fn.calc_primal(term, xT, u_term[0])[1]
            cost_try = cost_r + cterm
            fail_t = fail_t | ~(cost_try.abs() < 1e30)
            xs_try = torch.cat([xs_r, xT[None]], 0)
            dV = cost - cost_try
            fail_t = fail_t | (cost_try > s.th_blowup * (1.0 + cost.abs()))
            dx_l = unnodes(lane_diff(nodes_of(xs_try), nodes_of(xs_l)))
            dv = -(fs_l * (Vxx_l * dx_l[:, None]).sum(2)).sum((0, 1))
            d0 = dg + dv
            d1 = dq - 2.0 * dv
            dVexp = alpha * (d0 + 0.5 * alpha * d1)
            pos = (dVexp >= 0) & ((d0 < s.th_grad)
                                  | (dV > s.th_acceptstep * dVexp))
            neg = (dVexp < 0) & (dV > s.th_acceptnegstep * dVexp)
            return xs_try, us_r, cost_try, (pos | neg) & ~fail_t, d0, d1

        # sequential line search: a global alpha ladder with per-lane
        # acceptance (each lane takes its own first acceptable alpha)
        def ls_body(lc):
            i, acc, xs_a, us_a, cost_a, step_a, d0_a, d1_a = lc
            alpha = control.pick(alphas, i)
            xs_try, us_try, cost_try, accept, d0, d1 = trial(alpha)
            take = ~acc & accept & active
            return (i + 1, acc | accept,
                    torch.where(take[None, None], xs_try, xs_a),
                    torch.where(take[None, None], us_try, us_a),
                    torch.where(take, cost_try, cost_a),
                    torch.where(take, alpha, step_a),
                    torch.where(take, d0, d0_a), torch.where(take, d1, d1_a))
        _, acc, xs_a, us_a, cost_a, step_a, d0_a, d1_a = control.while_loop(
            lambda lc: (lc[0] < len(alphas)) & (~lc[1] & active).any(),
            ls_body,
            (torch.zeros((), dtype=torch.int64, device=dev),
             torch.zeros(B, dtype=torch.bool, device=dev), xs_l.clone(),
             us_l.clone(), cost.clone(), full(s.alphas[-1]), d0_o.clone(),
             d1_o.clone()))

        upd = acc & active
        xs_l = torch.where(upd[None, None], xs_a, xs_l)
        us_l = torch.where(upd[None, None], us_a, us_l)
        cost = torch.where(upd, cost_a, cost)
        steplength = torch.where(active, step_a, steplength)
        d0_o = torch.where(active, d0_a, d0_o)
        d1_o = torch.where(active, d1_a, d1_o)
        feas_new = was_feasible | (step_a == 1.0)
        was_feasible = torch.where(upd, feasible, was_feasible)
        feasible = torch.where(upd, feas_new, feasible)

        # regularization schedule (ddp.cpp:95-104)
        dec = step_a > s.th_stepdec
        inc = step_a <= s.th_stepinc
        xreg_a = torch.where(dec, torch.clamp(xreg / s.regfactor,
                                              min=s.regmin), xreg)
        xreg_a = torch.where(inc, torch.clamp(xreg_a * s.regfactor,
                                              max=s.regmax), xreg_a)
        div = div | (active & inc & (xreg_a >= s.regmax))
        xreg = torch.where(active, xreg_a, xreg)
        ureg = xreg

        stop = (Qu_l ** 2).sum((0, 1))
        stop_o = torch.where(active, stop, stop_o)
        conv = torch.where(active, was_feasible & (stop < s.th_stop), conv)
        it_b = torch.where(active, it_b + 1, it_b)
        active = (it_b < s.maxiter) & ~conv & ~div
        return (xs_l, us_l, feasible, was_feasible, xreg, ureg, cost,
                steplength, d0_o, d1_o, stop_o, it_b, conv, div, active)

    c = (xs_l0, us_l0,
         torch.as_tensor(is_feasible, dtype=torch.bool).to(dev).expand(B)
         .clone(), full(False, torch.bool), reg0, reg0.clone(), full(0.0),
         full(1.0), full(0.0), full(0.0), full(float("inf")),
         full(0, torch.int32), full(False, torch.bool),
         full(False, torch.bool), full(True, torch.bool))
    c = iteration(c)
    if s.maxiter > 1:
        c = control.while_loop(lambda c: c[-1].any(), iteration, c)
    (xs_l, us_l, feasible, _, xreg, ureg, cost, steplength, d0_o, d1_o,
     stop_o, it_b, conv, div, _) = c

    # final direction at the returned candidate (fddp_batch.py:298-302)
    derivs_l, dterm_l, fs_l, _ = calc_diff(xs_l, us_l, feasible)
    Vx_l, Vxx_l, Qu_l, k_l, K_l, _, _ = _fsc.riccati_backward_lanes(
        derivs_l, dterm_l, fs_l, xreg, ureg)

    def tob(a_l):
        return a_l.movedim(-1, 0)

    return Solution(
        xs=tob(xs_l), us=tob(us_l), K=tob(K_l), k=tob(k_l), Vx=tob(Vx_l),
        Vxx=tob(Vxx_l), Qu=tob(Qu_l), fs=tob(fs_l), cost=cost, stop=stop_o,
        xreg=xreg, ureg=ureg, steplength=steplength, d0=d0_o, d1=d1_o,
        iter=it_b, is_feasible=feasible, converged=conv, diverged=div)
