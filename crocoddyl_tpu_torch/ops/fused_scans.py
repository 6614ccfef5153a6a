"""Riccati backward pass and trial rollout — kernels 2 to 5 of the port.

Batch lane (kernels 2 and 3): ``riccati_backward_lanes`` and
``trial_rollout_lanes`` (crocoddyl_tpu/ops/fused_scans.py:350-720), problems
on the trailing lane axis B, time on the leading axis.  b=1 lane (kernels 4
and 5): ``riccati_backward_fused`` and ``trial_rollout_fused``
(fused_scans.py:57-331), one problem, time on the leading axis, or P
problems on a leading problem axis (the batching rule that ``jax.vmap``
applies to these two Pallas kernels: one program instance a problem).

The functions named ``*_plain`` are the plain PyTorch versions (a loop over
t of the JAX step functions; the b=1 ones are the lane loops at B=1 with
the lane axis squeezed).  The wrappers send CUDA tensors to the kernels of
csrc/riccati_kernel.cu, rollout_kernel.cu, riccati_fused_kernel.cu and
rollout_fused_kernel.cu and CPU tensors to the plain versions.  The Riccati
passes go through the ops ``torch.ops.crocoddyl_tpu_torch.riccati_backward``
and ``riccati_backward_b1`` on either device: their CPU implementation,
registered here, is the plain version.  The rollouts' plain versions read
the segment's dataclasses, which an op argument cannot carry, so on the
CPU their wrappers call them directly; on the card
``ops/cuda_kernels.trial_rollout``/``trial_rollout_b1`` call the ops.
"""

from __future__ import annotations

import torch

from ..core.action import NodeDerivs
from ..dynamics.model import JointType
from ..utils.struct import flat_spec, tree_map, unflat_spec
from . import cuda_kernels as _ck
from .fused_node import (_lane_state_diff, lane_calc_primal, lane_integrate,
                         lane_params, lchol, lcho_solve, leye, lmm_chunk,
                         lmv, lT, supports)


def _riccati_step(Vx_n, Vxx_n, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, f, xreg, ureg):
    """One reversed-time step (fused_scans.py:375-410)."""
    nu, ndx = Lu.shape[0], Lx.shape[0]
    FxT = lT(Fx)
    FxT_Vxx = lmm_chunk(FxT, Vxx_n, chunk=6)
    Qxx = Lxx + lmm_chunk(FxT_Vxx, Fx, chunk=6)
    Qx = Lx + lmv(FxT, Vx_n)
    Qxu = Lxu + lmm_chunk(FxT_Vxx, Fu, chunk=6)
    FuT = lT(Fu)
    Quu = Luu + lmm_chunk(lmm_chunk(FuT, Vxx_n, chunk=6), Fu, chunk=6)
    Quu = Quu + ureg[None, None] * leye(nu, Quu[0])
    Qu = Lu + lmv(FuT, Vx_n)
    diag_q = (Quu * leye(nu, Quu[0])).sum(1)
    dscale = torch.sqrt(torch.clamp(diag_q, min=1e-30))
    Quu_eq = Quu / dscale[:, None] / dscale[None, :]
    chol = lchol(Quu_eq)
    bad_ch = torch.isnan(chol).any(dim=1).any(dim=0)

    def chol_solve_mat(Bm):
        return lcho_solve(chol, Bm / dscale[:, None]) / dscale[:, None]

    K = chol_solve_mat(lT(Qxu))
    kvec = chol_solve_mat(Qu[:, None])[:, 0]
    Quuk = lmv(Quu, kvec)
    KT = lT(K)
    Vx = Qx + lmv(KT, Quuk) - 2.0 * lmv(KT, Qu)
    Vxx = Qxx - lmm_chunk(Qxu, K, chunk=6)
    Vxx = 0.5 * (Vxx + lT(Vxx))
    Vxx = Vxx + xreg[None, None] * leye(ndx, Vxx[0])
    Vx = Vx + lmv(Vxx, f)
    bad = (bad_ch | ~(Vx.abs().amax(0) < 1e30)
           | ~(Vxx.abs().amax((0, 1)) < 1e30))
    return Vx, Vxx, Qu, kvec, K, Quuk, bad


def _riccati_loop(derivs_l, dterm_l, fs_l, xreg, ureg):
    """The reversed-time loop of the plain Riccati versions (lane layout)."""
    T = derivs_l.Fx.shape[0]
    ndx = fs_l.shape[1]
    VxxT = dterm_l.Lxx + xreg[None, None] * leye(ndx, dterm_l.Lxx[0])
    VxT = dterm_l.Lx + lmv(VxxT, fs_l[-1])
    failed = ~(VxT.abs().amax(0) < 1e30) | ~(VxxT.abs().amax((0, 1)) < 1e30)
    Vx, Vxx = [None] * (T + 1), [None] * (T + 1)
    Qu, kv, K, Quuk = [None] * T, [None] * T, [None] * T, [None] * T
    Vx[T], Vxx[T] = VxT, VxxT
    d = derivs_l
    for t in reversed(range(T)):
        (Vx[t], Vxx[t], Qu[t], kv[t], K[t], Quuk[t], bad) = _riccati_step(
            Vx[t + 1], Vxx[t + 1], d.Fx[t], d.Fu[t], d.Lx[t], d.Lu[t],
            d.Lxx[t], d.Lxu[t], d.Luu[t], fs_l[t], xreg, ureg)
        failed = failed | bad
    st = torch.stack
    return st(Vx), st(Vxx), st(Qu), st(kv), st(K), st(Quuk), failed


def riccati_backward_lanes_plain(derivs_l, dterm_l, fs_l, xreg, ureg):
    """Plain PyTorch version of the Riccati kernel.  Ports
    fused_scans.py:350-453 (its lax.scan path): derivs_l leaves (T, ..., B),
    dterm_l Lx (ndx, B) / Lxx (ndx, ndx, B), fs_l (T+1, ndx, B), xreg/ureg
    (B,).  Returns (Vx (T+1,ndx,B), Vxx (T+1,ndx,ndx,B), Qu (T,nu,B),
    k (T,nu,B), K (T,nu,ndx,B), Quuk (T,nu,B), failed (B,) bool)."""
    if not torch.compiler.is_compiling():
        riccati_backward_lanes_plain.calls += 1
    return _riccati_loop(derivs_l, dterm_l, fs_l, xreg, ureg)


riccati_backward_lanes_plain.calls = 0


def riccati_backward_lanes(derivs_l, dterm_l, fs_l, xreg, ureg):
    """Batched Riccati backward pass (see the plain version for shapes),
    through the op ``riccati_backward``."""
    return torch.ops.crocoddyl_tpu_torch.riccati_backward(
        *_ck.riccati_args(derivs_l, dterm_l, fs_l), xreg, ureg)


def _rollout_loop(seg, x0_l, xs_l, us_l, k_l, K_l, fs_l, alpha):
    """The time loop of the plain rollout versions (lane layout)."""
    st = seg.state_
    nq, nv = st.nq, st.nv
    has_ff = JointType(st.model.joint_types[0]) == JointType.FREE_FLYER
    T, B = us_l.shape[0], x0_l.shape[-1]
    # knot t of each of the seg's K / T problems: one knot for all lanes
    # (kernel 3), or lane p's own (kernel 5 over P problems, K = P·T)
    K = seg.dt.shape[0]
    xnext = x0_l
    cost = torch.zeros(B, dtype=x0_l.dtype, device=x0_l.device)
    failed = torch.zeros(B, dtype=torch.bool, device=x0_l.device)
    xs_try, us_try = [], []
    for t in range(T):
        x_try = lane_integrate(has_ff, nq, nv, xnext, (alpha - 1.0) * fs_l[t])
        dx, _ = _lane_state_diff(has_ff, nq, nv, xs_l[t], x_try)
        u_try = us_l[t] - alpha * k_l[t] - lmv(K_l[t], dx)
        knot = lane_params(tree_map(lambda l: l[t:K:T], seg), B)
        xnext, c = lane_calc_primal(knot, x_try, u_try)
        cost = cost + c
        failed = failed | ~((cost.abs() < 1e30)
                            & (xnext.abs().amax(0) < 1e30))
        xs_try.append(x_try)
        us_try.append(u_try)
    return torch.stack(xs_try), torch.stack(us_try), xnext, cost, failed


def trial_rollout_lanes_plain(seg, x0_l, xs_l, us_l, k_l, K_l, fs_l, fsT_l,
                              alpha):
    """Plain PyTorch version of the rollout kernel.  Ports
    fused_scans.py:554-640 (its lax.scan path): seg leaves (T, ...) are the
    knot parameters, read by knot; x0_l (nx, B); xs_l/us_l/k_l/K_l/fs_l
    (T, ..., B); alpha a float.  Returns (xs_try (T,nx,B), us_try (T,nu,B),
    x_last (nx,B), cost (B,), failed (B,) bool)."""
    if not torch.compiler.is_compiling():
        trial_rollout_lanes_plain.calls += 1
    return _rollout_loop(seg, x0_l, xs_l, us_l, k_l, K_l, fs_l, alpha)


trial_rollout_lanes_plain.calls = 0


def trial_rollout_lanes(seg, x0_l, xs_l, us_l, k_l, K_l, fs_l, fsT_l, alpha):
    """One batched FDDP trial rollout at scalar step length ``alpha``
    (see the plain version for shapes).  ``fsT_l`` (fs[T]) is not read: the
    terminal node stays with the caller, as in the JAX signature."""
    if x0_l.is_cuda:
        return _ck.trial_rollout(seg, x0_l, xs_l, us_l, k_l, K_l, fs_l, alpha)
    leaves, spec = flat_spec(seg)
    return torch.ops.crocoddyl_tpu_torch.trial_rollout(
        None, None, None, x0_l, xs_l, us_l, k_l, K_l, fs_l,
        _ck.as_scalar(alpha, x0_l), 0, leaves, spec)


# ---------------------------------------------------------------------------
# b=1 lane: one problem, kernels 4 and 5
# ---------------------------------------------------------------------------

def _lane(a):
    return a[..., None]


def _lanes_of(a):
    """(P, ...) → (..., P): a problem axis as the lane axis."""
    return a.movedim(0, -1)


def riccati_backward_fused_plain(derivs, dterm, fs, xreg, ureg):
    """Plain PyTorch version of the single-problem Riccati kernel.  Ports
    fused_scans.py:57-219 (the step math of :106-136): derivs leaves
    (T, ...), dterm Lx (ndx,) / Lxx (ndx, ndx), fs (T+1, ndx), xreg/ureg
    scalars.  Returns (Vx (T+1,ndx), Vxx (T+1,ndx,ndx), Qu (T,nu), k (T,nu),
    K (T,nu,ndx), Quuk (T,nu), failed () bool) — the outputs of
    fddp._backward_pass (non-box).  Over P problems every input and output
    carries a leading problem axis (xreg/ureg (P,)): the same loop with
    the problems as its lanes."""
    if not torch.compiler.is_compiling():
        riccati_backward_fused_plain.calls += 1
    if fs.dim() == 3:
        out = _riccati_loop(tree_map(_lanes_of, derivs),
                            tree_map(_lanes_of, dterm), _lanes_of(fs),
                            xreg, ureg)
        return tuple(a.movedim(-1, 0).contiguous() for a in out)

    def reg(r):
        return torch.as_tensor(r, dtype=fs.dtype, device=fs.device).reshape(1)
    out = _riccati_loop(tree_map(_lane, derivs), tree_map(_lane, dterm),
                        _lane(fs), reg(xreg), reg(ureg))
    return tuple(a[..., 0] for a in out)


riccati_backward_fused_plain.calls = 0


def riccati_backward_fused(derivs, dterm, fs, xreg, ureg):
    """Single-problem Riccati backward pass (see the plain version for
    shapes), through the op ``riccati_backward_b1``: CUDA tensors go to
    csrc/riccati_fused_kernel.cu.  Over P problems (fs (P, T+1, ndx)) one
    launch of P CTAs."""
    lead = fs.shape[:-2]
    return torch.ops.crocoddyl_tpu_torch.riccati_backward_b1(
        *_ck.riccati_args(derivs, dterm, fs), _ck.as_scalar(xreg, fs, lead),
        _ck.as_scalar(ureg, fs, lead))


def trial_rollout_fused_plain(seg, x0, xs, us, k, K, fs, alpha):
    """Plain PyTorch version of the single-problem rollout kernel.  Ports
    fused_scans.py:227-331 (the step math of :252-265): seg leaves (T, ...)
    are the T running knots; x0 (nx,); xs (T or T+1, nx) and fs (T or T+1,
    ndx), of which the first T rows are read; us/k (T, nu); K (T, nu, ndx);
    alpha a float.  Returns (xs_try (T,nx), us_try (T,nu), x_last (nx,),
    cost (), failed () bool); the terminal node stays with the caller.
    Over P problems every array carries a leading problem axis (alpha
    (P,)) and seg holds their P·T knots, problem by problem: the same loop
    with the problems as its lanes, each reading its own knots."""
    if not torch.compiler.is_compiling():
        trial_rollout_fused_plain.calls += 1
    T = us.shape[-2]
    if x0.dim() == 2:
        out = _rollout_loop(seg, *(_lanes_of(a) for a in (
            x0, xs[:, :T], us, k, K, fs[:, :T])), alpha)
        return tuple(a.movedim(-1, 0).contiguous() for a in out)
    out = _rollout_loop(seg, _lane(x0), _lane(xs[:T]), _lane(us), _lane(k),
                        _lane(K), _lane(fs[:T]), alpha)
    return tuple(a[..., 0] for a in out)


trial_rollout_fused_plain.calls = 0


def trial_rollout_fused(seg, x0, xs, us, k, K, fs, alpha):
    """One single-problem FDDP trial rollout at step length ``alpha`` (see
    the plain version for shapes); CUDA tensors go to
    csrc/rollout_fused_kernel.cu.  Over P problems (x0 (P, nx), alpha
    (P,), seg their P·T knots) one launch of P CTAs."""
    T = us.shape[-2]
    xs, fs = xs[..., :T, :], fs[..., :T, :]
    if x0.is_cuda:
        return _ck.trial_rollout_b1(seg, x0, xs, us, k, K, fs, alpha)
    leaves, spec = flat_spec(seg)
    return torch.ops.crocoddyl_tpu_torch.trial_rollout_b1(
        None, None, None, x0, xs, us, k, K, fs,
        _ck.as_scalar(alpha, x0, x0.shape[:-1]), 0, leaves, spec)


def supports_problem(problem, settings) -> bool:
    """Gate of the b=1 kernels (fused_scans.py:334-340): no control bounds,
    one segment whose node structure the node kernel covers."""
    return (not settings.box and len(problem.segments) == 1
            and supports(problem.segments[0]))


def _riccati_cpu(plain):
    """The CPU implementation of a Riccati op: its plain version on the
    op's flat arguments."""
    def impl(*args):
        *blocks, fs, xreg, ureg = args
        return tuple(plain(*_ck.riccati_trees(*blocks), fs, xreg, ureg))
    return impl


def _rollout_lanes_cpu(meta, robot, par, x0, xs, us, k, K, fs, alpha, ws,
                       leaves, spec):
    return tuple(trial_rollout_lanes_plain(
        unflat_spec(leaves, spec), x0, xs, us, k, K, fs, None, alpha))


def _rollout_b1_cpu(meta, robot, par, x0, xs, us, k, K, fs, alpha, ws,
                    leaves, spec):
    return tuple(trial_rollout_fused_plain(
        unflat_spec(leaves, spec), x0, xs, us, k, K, fs, alpha))


torch.library.register_kernel("crocoddyl_tpu_torch::trial_rollout", "cpu",
                              _rollout_lanes_cpu)
torch.library.register_kernel("crocoddyl_tpu_torch::trial_rollout_b1", "cpu",
                              _rollout_b1_cpu)
torch.library.register_kernel("crocoddyl_tpu_torch::riccati_backward", "cpu",
                              _riccati_cpu(riccati_backward_lanes_plain))
torch.library.register_kernel(
    "crocoddyl_tpu_torch::riccati_backward_b1", "cpu",
    _riccati_cpu(riccati_backward_fused_plain))

PLAIN = (riccati_backward_lanes_plain, trial_rollout_lanes_plain,
         riccati_backward_fused_plain, trial_rollout_fused_plain)

__all__ = ["NodeDerivs", "riccati_backward_lanes", "trial_rollout_lanes",
           "riccati_backward_lanes_plain", "trial_rollout_lanes_plain",
           "riccati_backward_fused", "trial_rollout_fused",
           "riccati_backward_fused_plain", "trial_rollout_fused_plain",
           "supports_problem"]
