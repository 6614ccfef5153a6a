"""Dense full-space KKT solver, an oracle of one Newton step (port of
crocoddyl_tpu/core/solvers/kkt.py; reference: src/core/solvers/kkt.cpp).

Assembles the (np+nd)² KKT system

    [ H   Aᵀ ] [ primal ]   = - [ grad   ]
    [ A   0  ] [ dual   ]       [ defect ]

with H the block Hessian (Lxx/Lxu/Luu per knot), A the linearized dynamics
(I on each state block, −Fx/−Fu couplings), and solves it densely.  The
step is independent of the Riccati recursion, so it anchors the backward
passes: with no regularization, the Riccati gains give the same step,
du_t = −k_t − K_t·dx_t.  Nothing on the solver's path calls this module.
Uniform ndx and nu per knot (the stacked layout, segments included).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass
class KKTSolution:
    xs: torch.Tensor
    us: torch.Tensor
    dxs: torch.Tensor       # (T+1, ndx) primal state steps (zero, as JAX)
    dus: torch.Tensor       # (T, nu) primal control steps (zero, as JAX)
    lambdas: torch.Tensor   # (T+1, ndx) duals (zero, as JAX)
    cost: torch.Tensor
    stop: torch.Tensor
    iter: torch.Tensor
    converged: torch.Tensor


def _assemble(problem, xs, us, derivs, dterm):
    """(H, grad, A, defect, cost) at the trajectory (kkt.py:41-87)."""
    st = problem.state
    T, ndx, nu = problem.T, st.ndx, problem.nu
    np_, nd = ndx * (T + 1) + nu * T, ndx * (T + 1)
    H = xs.new_zeros((np_, np_))
    grad = xs.new_zeros((np_,))
    A = xs.new_zeros((nd, np_))
    defect = xs.new_zeros((nd,))
    Lxx_all = torch.cat([derivs.Lxx, dterm.Lxx[None]])
    Lx_all = torch.cat([derivs.Lx, dterm.Lx[None]])
    for t in range(T + 1):
        sl = slice(t * ndx, (t + 1) * ndx)
        H[sl, sl] = Lxx_all[t]
        grad[sl] = Lx_all[t]
    off = ndx * (T + 1)
    for t in range(T):
        sx = slice(t * ndx, (t + 1) * ndx)
        su = slice(off + t * nu, off + (t + 1) * nu)
        H[sx, su] = derivs.Lxu[t]
        H[su, sx] = derivs.Lxu[t].T
        H[su, su] = derivs.Luu[t]
        grad[su] = derivs.Lu[t]
    # dx_0 = −(xs0 ⊖ x0);  dx_{t+1} − Fx dx_t − Fu du_t = −gap
    A[:, :nd] = torch.eye(nd, dtype=xs.dtype, device=xs.device)
    xnexts, costs = problem.calc(xs, us)
    defect[:ndx] = st.diff(problem.x0.to(xs.dtype), xs[0])
    for t in range(T):
        r = slice((t + 1) * ndx, (t + 2) * ndx)
        A[r, t * ndx:(t + 1) * ndx] = -derivs.Fx[t]
        A[r, off + t * nu:off + (t + 1) * nu] = -derivs.Fu[t]
        defect[r] = st.diff(xnexts[t], xs[t + 1])
    return H, grad, A, defect, costs.sum()


def newton_step(problem, xs, us, ureg: float = 0.0):
    """One Newton step of the dense KKT system at (xs, us) (the body of
    kkt.py:113-135): (dxs (T+1, ndx), dus (T, nu), lambdas (T+1, ndx), H,
    grad, derivs, defect, cost).  ``ureg`` adds ureg·I to every control
    block of H, as the Riccati pass adds it to Quu: an impulse knot's
    controls move nothing (Fu = 0, Luu = 0), so its block is singular
    without it."""
    T, ndx, nu = problem.T, problem.state.ndx, problem.nu
    derivs, dterm = problem.calc_diff(xs, us)
    H, grad, A, defect, cost = _assemble(problem, xs, us, derivs, dterm)
    np_, nd = H.shape[0], defect.shape[0]
    if ureg:
        iu = torch.arange(ndx * (T + 1), np_, device=H.device)
        H[iu, iu] += ureg
    KKT = xs.new_zeros((np_ + nd, np_ + nd))
    KKT[:np_, :np_] = H
    KKT[np_:, :np_] = A
    KKT[:np_, np_:] = A.T
    sol = torch.linalg.solve(KKT, -torch.cat([grad, defect]))
    primal, dual = sol[:np_], sol[np_:]
    return (primal[:ndx * (T + 1)].reshape(T + 1, ndx),
            primal[ndx * (T + 1):].reshape(T, nu), dual.reshape(T + 1, ndx),
            H, grad, derivs, defect, cost)


def solve(problem, xs_init: Optional[torch.Tensor] = None,
          us_init: Optional[torch.Tensor] = None, maxiter: int = 100,
          is_feasible: bool = False, th_acceptstep: float = 0.1,
          th_stop: float = 1e-9, th_grad: float = 1e-12,
          n_alphas: int = 10) -> KKTSolution:
    """Newton iterations on the dense KKT system with a parallel
    backtracking line search and the Lagrangian-stationarity stop
    (kkt.py:90-175), on the problem's device."""
    st = problem.state
    T, ndx, nu = problem.T, st.ndx, problem.nu
    x0 = problem.x0
    dt = x0.dtype
    xs = (x0[None].expand(T + 1, -1).clone() if xs_init is None
          else xs_init.to(dt))
    us = (x0.new_zeros((T, nu)) if us_init is None else us_init.to(dt))
    alphas = [2.0 ** (-k) for k in range(n_alphas)]
    cost = x0.new_zeros(())
    feasible, was_feasible = bool(is_feasible), False
    it, conv, stop = 0, False, x0.new_tensor(float("inf"))
    while it < maxiter and not conv:
        dxs, dus, lam, H, grad, derivs, defect, cost_c = newton_step(
            problem, xs, us)
        primal = torch.cat([dxs.reshape(-1), dus.reshape(-1)])
        d0 = -grad @ primal
        d1 = -(primal @ (H @ primal))
        trial = None
        for alpha in alphas:
            xs_try = torch.func.vmap(st.integrate)(xs, alpha * dxs)
            us_try = us + alpha * dus
            cost_try = problem.calc(xs_try, us_try)[1].sum()
            dV = cost_c - cost_try
            dVexp = alpha * d0 + 0.5 * alpha * alpha * d1
            accept = (bool(d0 < th_grad) or not feasible
                      or bool(dV > th_acceptstep * dVexp))
            if accept and not bool(torch.isnan(cost_try)):
                trial = (xs_try, us_try, cost_try)
                break
        if trial is not None:
            xs, us, cost = trial
            was_feasible, feasible = feasible, True
        else:
            cost = cost_c
        # Lagrangian stationarity (kkt.cpp:128-149)
        dF_x = lam[:-1] - torch.einsum("tij,ti->tj", derivs.Fx, lam[1:])
        dF_u = -torch.einsum("tij,ti->tj", derivs.Fu, lam[1:])
        res_x = grad[:ndx * (T + 1)].reshape(T + 1, ndx) + torch.cat(
            [dF_x, lam[-1][None]])
        res_u = grad[ndx * (T + 1):].reshape(T, nu) + dF_u
        stop = (res_x ** 2).sum() + (res_u ** 2).sum() + (defect ** 2).sum()
        conv = was_feasible and bool(stop < th_stop)
        it += 1
    z = x0.new_zeros
    return KKTSolution(xs=xs, us=us, dxs=z((T + 1, ndx)), dus=z((T, nu)),
                       lambdas=z((T + 1, ndx)), cost=cost, stop=stop,
                       iter=torch.tensor(it, dtype=torch.int32),
                       converged=torch.tensor(conv))
