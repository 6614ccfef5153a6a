"""Single-problem DDP / FDDP and their box-constrained variants (port of
crocoddyl_tpu/core/solvers/fddp.py): ``SolverSettings``, ``Trace``,
``Solution``, ``solve``, ``polish`` and the settings factories.

``solve`` runs FDDP and DDP (``feasibility_driven=False``), Box-FDDP and
Box-DDP (``box=True`` with control bounds), the parallel and the sequential
line search, with or without the trace and an ``iter_callback``, the
multiple-shooting trial rollout (``ms_chunk > 0``, FDDP only) and the
associative-scan backward pass (``parallel_riccati=True``), on a problem of
one segment or several (the true-impulse gaits).  Which passes run follows
the problem's structure and the settings, as the JAX ``use_fscan`` does
(fddp.py:557-561), never the device:

- every linearization goes through ``ShootingProblem.calc_diff_full``,
  which takes each group of same-structure segments and the terminal by
  its structure: a one-segment problem whose nodes the node kernel admits
  is one node-kernel launch over the T+1 nodes (kernel 1); any other block
  the kernel admits is one kernel-1 launch over its knots; every other
  block (a generic ``RigidBodyNode``, an ``ImpulseNode``, an
  ``ActionModel``) gives its own derivatives;
- ``parallel_riccati=True`` without box: every backward pass and ladder
  probe is ``parallel_riccati.backward_pass_parallel`` (before kernel 4,
  as in JAX);
- with ``fused_scans=True``, for a one-segment problem whose nodes the
  node kernel admits, without box: every backward pass and ladder probe is
  the single-problem Riccati pass (kernel 4,
  ``ops/fused_scans.riccati_backward_fused``) and, with ``ms_chunk == 0``,
  every line-search trial one single-problem rollout (kernel 5,
  ``ops/fused_scans.trial_rollout_fused``);
- otherwise (the default ``fused_scans=False``, box, several segments, or a
  node the kernel does not admit): the generic backward pass
  ``_backward_pass`` (with a BoxQP per node under box) and the generic
  trial rollout, ``_forward_pass`` or ``_forward_pass_ms`` (controls
  clamped under box; the parallel line search's trials as rows of one
  pass).

On CUDA tensors the kernels run on the card; the generic passes are plain
PyTorch on whatever device the problem is on.  As in the JAX version, whose
``solve`` is one jitted program with ``while_loop``s, the regularization
ladder, the line search and the iteration loop decide on the device: their
state is 0-d tensors, and ``control.while_loop``/``control.cond`` run them
(eagerly, one host read of each predicate; or recorded by ``torch.export``,
so that ``utils/aot.export_bytes`` serializes a whole solve).  The decisions
are the JAX ones: same probes, same accepted steps, same regularization
schedule.

``solve`` also takes a batch of B problems of one structure (every leaf
with a leading problem axis, as ``jax.vmap`` sees them; ``vmap_solve`` is
the ``jax.vmap``-shaped call) and solves it as one program: every tensor of
the solve carries the problem axis, the decisions are (B,) tensors, and the
loops follow ``jax.vmap``'s batching rule (``control.while_loop`` and
``control.cond`` of a (B,) predicate), so each problem takes the decisions
of its own single solve.  The batch's node linearizations are
one kernel-1 launch over all its knots, and kernels 4 and 5 take the
batch's problems as their problem axis.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...dynamics.model import JointType
from ...dynamics.states import StateMultibody
from ...ops import cuda_kernels as _ck
from ...ops import fused_node as _fn
from ...ops import fused_scans as _fsc
from ...ops.smallchol import cho_solve, chol
from ...utils.struct import tree_leaves, tree_map
from ..action import ActionModel
from ..problem import node_calc
from . import boxqp, control
from .parallel_riccati import backward_pass_parallel


@dataclasses.dataclass(frozen=True)
class SolverSettings:
    """Static solver configuration; defaults mirror the JAX package
    (fddp.py:51-134).  ``fused_scans=True`` takes the single-problem
    kernels 4 and 5 where the problem admits them, as the JAX ``use_fscan``
    does; ``parallel_riccati=True`` the associative-scan backward pass;
    ``ms_chunk > 0`` the multiple-shooting trial rollout, whose solves
    converge on ``th_stop`` and the gaps below ``th_gaptol``.
    ``scan_unroll`` is left out: it tunes XLA loops only."""

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
    shapes below and the scalars are 0-d tensors; from ``solve_batch`` and
    ``vmap_solve`` every leaf carries a leading problem axis B.  The
    direction fields (K, k, Vx, Vxx, Qu, fs) belong to the returned
    trajectory, except from ``solve`` with ``maxiter == 1``, where they
    belong to the candidate before the step (fddp.py:817-866)."""

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


def _bad(x, nb=0) -> torch.Tensor:
    """The reference's raiseIfNaN predicate (solver-base.cpp:175-178): true
    for NaN, inf, or magnitude >= 1e30 (fddp.py:44-48); one per problem
    over the leading ``nb`` axes."""
    return ~(control.per_problem(x.abs(), nb, "max") < 1e30)


def _reg(v, fs):
    """A regularization (a float, 0-d or (B,)) as a tensor of fs's dtype,
    one per problem of fs (T+1, ndx) or (B, T+1, ndx)."""
    return torch.as_tensor(v, dtype=fs.dtype, device=fs.device).reshape(
        fs.shape[:-2])


def _refusal(problem, settings: SolverSettings) -> Optional[str]:
    """Why ``solve`` does not take this problem and configuration, or
    None."""
    if settings.ms_chunk > 0 and not settings.feasibility_driven:
        # fddp.py:491-496: plain DDP zeroes the gaps in its rollout and
        # would never measure the chunk-boundary defects
        return ("ms_chunk > 0 requires feasibility_driven=True "
                "(multiple-shooting defects are FDDP gaps)")
    if all(isinstance(m, ActionModel)
           for m in (*problem.segments, problem.terminal)):
        return None
    return ("a node that is not an ActionModel (a RigidBodyNode, an "
            "ImpulseNode, or a model with its own calc and derivatives)")


def supports(problem, settings: SolverSettings) -> bool:
    """True iff ``solve`` covers this problem and configuration: segments
    of ``ActionModel``s (``RigidBodyNode`` and ``ImpulseNode`` included),
    an ``ActionModel`` terminal, and no multiple shooting under DDP."""
    return _refusal(problem, settings) is None


def _state_ops(problem):
    """Row-wise diff(xa, xb) = xb ⊖ xa and integrate(x, dx) = x ⊕ dx on
    (N, nx) / (N, ndx), or (..., N, nx) of equal leading shapes: the lane
    functions for a multibody state, the state's own for others."""
    st = problem.state
    if not isinstance(st, StateMultibody):
        return st.diff, st.integrate
    has_ff = JointType(st.model.joint_types[0]) == JointType.FREE_FLYER
    nq, nv = st.nq, st.nv

    def rows(f):
        def g(a, b):
            if a.dim() <= 2:
                return f(a, b)
            return f(a.reshape(-1, a.shape[-1]),
                     b.reshape(-1, b.shape[-1])).reshape(a.shape[:-1] + (-1,))
        return g

    @rows
    def diff(xa, xb):
        return _fn.state_diff(has_ff, nq, nv, xa.T, xb.T).T

    @rows
    def integrate(x, dx):
        return _fn.state_integrate(has_ff, nq, nv, x.T, dx.T).T
    return diff, integrate


def _calc_diff(problem, xs, us, feasible):
    """Derivatives, gaps and cost at the candidate (fddp.py:464-472); the
    gaps are zero where ``feasible`` (a bool, a 0-d bool tensor, or (B,)
    for a batch)."""
    diff, _ = _state_ops(problem)
    derivs, dterm, xnexts, costs = problem.calc_diff_full(xs, us)
    cost = costs.sum(-1)
    fs = torch.cat([diff(xs[..., :1, :], problem.x0[..., None, :]),
                    diff(xs[..., 1:, :], xnexts)], -2)
    if isinstance(feasible, torch.Tensor):
        fs = torch.where(control.lanes(feasible, fs), torch.zeros_like(fs),
                         fs)
    elif feasible:
        fs = torch.zeros_like(fs)
    return derivs, dterm, fs, cost


def _backward_pass(derivs, dterm, fs, xreg, ureg, box_args=None,
                   probe=False):
    """The generic Riccati backward pass (fddp.py:211-303): the pass of
    ``_backward_loop`` through the op
    ``torch.ops.crocoddyl_tpu_torch.backward_pass``, or with ``box_args``
    ``backward_pass_box`` (its loop over time, with a knot's BoxQP loop,
    is one node under ``torch.export``, as JAX's ``lax.scan`` is one
    primitive).  Every tensor may carry a leading problem axis (a batch).
    Returns (Vx, Vxx, Qu, k, K, Quuk, failed), or only ``failed`` with
    ``probe``."""
    args = (*_ck.riccati_args(derivs, dterm, fs), _reg(xreg, fs),
            _reg(ureg, fs))
    if box_args is None:
        out = torch.ops.crocoddyl_tpu_torch.backward_pass(*args)
    else:
        us, u_lb, u_ub, k_warm, use_box, qp_kw = box_args
        out = torch.ops.crocoddyl_tpu_torch.backward_pass_box(
            *args, us, u_lb, u_ub, k_warm,
            torch.as_tensor(use_box, dtype=torch.bool, device=fs.device),
            *(qp_kw[k] for k in _QP_KEYS))
    return out[-1] if probe else out


def _backward_op(*args):
    *blocks, fs, xreg, ureg = args
    return _backward_loop(*_ck.riccati_trees(*blocks), fs, xreg, ureg)


_QP_KEYS = ("maxiter", "th_acceptstep", "th_grad", "reg")


def _backward_box_op(*args):
    *blocks, fs, xreg, ureg, us, u_lb, u_ub, k_warm, use_box = args[:-4]
    return _backward_loop(*_ck.riccati_trees(*blocks), fs, xreg, ureg, (
        us, u_lb, u_ub, k_warm, use_box, dict(zip(_QP_KEYS, args[-4:]))))


_bp_op = torch.library.custom_op(
    "crocoddyl_tpu_torch::backward_pass", _backward_op, mutates_args=(),
    schema=_ck.RICCATI_SCHEMA)
_bp_box_op = torch.library.custom_op(
    "crocoddyl_tpu_torch::backward_pass_box", _backward_box_op,
    mutates_args=(), schema=_ck.RICCATI_SCHEMA.replace(
        "Tensor ureg)", "Tensor ureg, Tensor us, Tensor u_lb, Tensor u_ub, "
        "Tensor k_warm, Tensor use_box, int qp_maxiter, "
        "float qp_th_acceptstep, float qp_th_grad, float qp_reg)"))


@_bp_op.register_fake
def _(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, xreg, ureg):
    return _ck.riccati_outs(Fx.shape[0], fs.shape[1], Lu.shape[1], (), fs)


@_bp_box_op.register_fake
def _(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, LxT, LxxT, fs, *rest):
    return _ck.riccati_outs(Fx.shape[0], fs.shape[1], Lu.shape[1], (), fs)


def _backward_loop(derivs, dterm, fs, xreg, ureg, box_args=None,
                   probe=False):
    """The generic Riccati backward pass (fddp.py:211-303), a loop over
    reversed time: the Jacobi-equilibrated Cholesky of Quu, and with
    ``box_args`` = (us, u_lb, u_ub, k_warm, use_box, qp_kw) the BoxQP gains
    on the knots where ``use_box[t]`` (the knot has a finite bound and the
    candidate is feasible, fddp.py:265-279).  ``use_box`` is a host list
    or a (T,) bool tensor, read once; the JAX pass runs every knot's QP and
    selects, here a knot outside ``use_box`` does not run its QP, which it
    would not read.  ``xreg``/``ureg`` are floats or 0-d tensors.  In a
    batch (fs (B, T+1, ndx)) every tensor carries the leading problem axis,
    xreg/ureg and ``use_box`` too, a knot's QP runs for the problems that
    use it (one batched BoxQP) and each step is one batched step.  Returns
    (Vx, Vxx, Qu, k, K, Quuk, failed), or only ``failed`` with
    ``probe``."""
    dt, dev = fs.dtype, fs.device
    nb = fs.dim() - 2
    ndx, T = fs.shape[-1], fs.shape[-2] - 1
    nu = derivs.Lu.shape[-1]
    xr, ur = xreg, ureg
    if nb:
        # time leads inside the loop; the scalars broadcast over matrices
        xr, ur = xr[:, None, None], ur[:, None, None]
        derivs = tree_map(lambda a: a.transpose(0, 1), derivs)
        fs = fs.transpose(0, 1)
    if box_args is not None:
        us, u_lb, u_ub, k_warm, use_box, qp_kw = box_args
        if nb:
            us, u_lb, u_ub, k_warm, use_box = (
                a.transpose(0, 1) for a in (us, u_lb, u_ub, k_warm, use_box))
            use_any = use_box.any(1).tolist()
        elif isinstance(use_box, torch.Tensor):
            use_box = use_box.tolist()
    eye = torch.eye(ndx, dtype=dt, device=dev)
    eye_u = torch.eye(nu, dtype=dt, device=dev)
    Vxx = VxxT = dterm.Lxx + xr * eye
    Vx = VxT = dterm.Lx + control.mv(Vxx, fs[-1])
    failed = _bad(Vx, nb) | _bad(Vxx, nb)
    outs = []
    for t in reversed(range(T)):
        Fx, Fu = derivs.Fx[t], derivs.Fu[t]
        FxT_Vxx = Fx.mT @ Vxx
        Qxx = derivs.Lxx[t] + FxT_Vxx @ Fx
        Qx = derivs.Lx[t] + control.mv(Fx.mT, Vx)
        Qxu = derivs.Lxu[t] + FxT_Vxx @ Fu
        Quu = derivs.Luu[t] + Fu.mT @ Vxx @ Fu + ur * eye_u
        Qu = derivs.Lu[t] + control.mv(Fu.mT, Vx)
        # Jacobi equilibration: solve (D⁻¹QuuD⁻¹)y = D⁻¹b, D = √diag(Quu)
        dscale = torch.sqrt(torch.clamp(
            torch.diagonal(Quu, dim1=-2, dim2=-1), min=1e-30))
        L = chol(Quu / dscale[..., :, None] / dscale[..., None, :])
        failed = failed | control.per_problem(torch.isnan(L), nb,
                                              "any")
        K = cho_solve(L, Qxu.mT / dscale[..., :, None]) / dscale[..., :, None]
        kvec = cho_solve(L, Qu / dscale) / dscale
        if box_args is not None and (use_any[t] if nb else use_box[t]):
            on = use_box[t] if nb else None
            qsol = boxqp.solve(Quu, Qu, u_lb[t] - us[t], u_ub[t] - us[t],
                               k_warm[t], active=on, **qp_kw)
            Qu_box = torch.where(qsol.free, Qu, torch.zeros_like(Qu))
            if nb:
                K = torch.where(on[:, None, None], qsol.Hff_inv @ Qxu.mT, K)
                kvec = torch.where(on[:, None], -qsol.x, kvec)
                Qu = torch.where(on[:, None], Qu_box, Qu)
                failed = failed | (on & qsol.failed)
            else:
                K, kvec, Qu = qsol.Hff_inv @ Qxu.mT, -qsol.x, Qu_box
                failed = failed | qsol.failed
        Quuk = control.mv(Quu, kvec)
        Vx = Qx + control.mv(K.mT, Quuk) - 2.0 * control.mv(K.mT, Qu)
        Vxx = Qxx - Qxu @ K
        Vxx = 0.5 * (Vxx + Vxx.mT) + xr * eye
        Vx = Vx + control.mv(Vxx, fs[t])
        failed = failed | _bad(Vx, nb) | _bad(Vxx, nb)  # ddp.cpp:246-251
        if not probe:
            outs.append((Vx, Vxx, Qu, kvec, K, Quuk))
    if probe:
        return failed
    Vx, Vxx, Qu, kvec, K, Quuk = (torch.stack(o[::-1], nb)
                                  for o in zip(*outs))
    return (torch.cat([Vx, VxT.unsqueeze(nb)], nb),
            torch.cat([Vxx, VxxT.unsqueeze(nb)], nb), Qu, kvec, K, Quuk,
            failed)


def _forward_pass(problem, xs, us, k, K, fs, alphas, u_lb=None, u_ub=None):
    """Trial rollouts at the step lengths ``alphas`` (a list or an (A,)
    tensor; fddp.py:310-355), the
    trials as rows, through every segment in turn: each knot's nodes are
    evaluated for all trials at once (``ShootingProblem.knot_calc``: one
    plain lane primal for a lane node, the model's ``calc`` under vmap
    otherwise).  ``fs`` must already be zeroed
    for DDP; with bounds the controls are clamped (box-ddp.cpp:95-97).
    Returns (xs_try (A, T+1, nx), us_try (A, T, nu), cost (A,), failed
    (A,)).  In a batch every tensor carries the leading problem axis B, the
    step lengths too when they are per problem ((B, A)), and each knot is
    one evaluation of its B·A rows."""
    diff, integrate = _state_ops(problem)
    al = torch.as_tensor(alphas, dtype=xs.dtype, device=xs.device)[..., None]
    A, bs = al.shape[-2], xs.shape[:-2]
    nx, nu = xs.shape[-1], us.shape[-1]
    gap = al - 1.0
    xnext = problem.x0[..., None, :].expand(bs + (A, nx))
    cost = xs.new_zeros(bs + (A,))
    failed = torch.zeros(bs + (A,), dtype=torch.bool, device=xs.device)
    xs_try, us_try = [], []
    for t in range(problem.T):
        x_try = integrate(xnext, gap * fs[..., t, None, :])
        dx = diff(xs[..., t, None, :].expand(bs + (A, nx)), x_try)
        u_try = us[..., t, None, :] - al * k[..., t, None, :] - dx @ K[
            ..., t, :, :].mT
        if u_lb is not None:
            u_try = torch.clamp(u_try, u_lb[..., t, None, :],
                                u_ub[..., t, None, :])
        xnext, c = problem.knot_calc(t, x_try.reshape(-1, nx),
                                     u_try.reshape(-1, nu))
        xnext, c = xnext.reshape(x_try.shape), c.reshape(cost.shape)
        cost = cost + c
        # raiseIfNaN (fddp.cpp:172-180) on the running cost and the state
        failed = (failed | ~(cost.abs() < 1e30)
                  | ~(xnext.abs().amax(-1) < 1e30))
        xs_try.append(x_try)
        us_try.append(u_try)
    xT = integrate(xnext, gap * fs[..., -1, None, :])
    cost = cost + problem.terminal_calc(xT.reshape(-1, nx)).reshape(
        cost.shape)
    failed = failed | ~(cost.abs() < 1e30)
    return (torch.stack(xs_try + [xT], -2), torch.stack(us_try, -2), cost,
            failed)


def _rows_calc(sub, xs, us, A, lanes):
    """(xnext, cost) of the K knots of the stack ``sub`` at the rows of xs
    (K·A, nx), us (K·A, nu), row r at knot r // A; ``lanes`` for a stack
    that goes through the lane functions."""
    if lanes or A == 1:
        return node_calc(sub, xs, us, lanes=lanes)
    return node_calc(tree_map(lambda l: l.repeat_interleave(A, 0), sub), xs,
                     us, lanes=lanes)


def _forward_pass_ms(problem, xs, us, k, K, fs, alphas, ms_chunk, u_lb=None,
                     u_ub=None):
    """Multiple-shooting trial rollouts (fddp.py:358-457): each segment's
    knots split into chunks of ``ms_chunk`` (the last one shorter), and all
    chunks of a segment roll out at once, each from the candidate's
    reconstruction of its incoming state ``integrate(xs[t0], fs[t0])`` (x0
    at t0 = 0, the previous knot's xnext inside the horizon).  The chunks
    and the trials are the rows of one evaluation per step (chunk-major), so
    a segment takes ``ms_chunk`` steps instead of its length.  The returned
    trials are those of ``_forward_pass``; the chunk-boundary mismatches
    become the next iteration's gaps.  In a batch the rows are
    problem-major (B, chunks, trials), as ``_forward_pass``'s."""
    diff, integrate = _state_ops(problem)
    al = torch.as_tensor(alphas, dtype=xs.dtype, device=xs.device)[..., None]
    A, T, bs, nb = al.shape[-2], problem.T, xs.shape[:-2], xs.dim() - 2
    nx = xs.shape[-1]
    xs_try = xs.new_empty(bs + (A, T + 1, nx))
    us_try = us.new_empty(bs + (A, T, us.shape[-1]))
    cost = xs.new_zeros(bs + (A,))
    failed = torch.zeros(bs + (A,), dtype=torch.bool, device=xs.device)
    x_last = None
    lead = (slice(None),) * (nb + 1)

    def rows(a):
        """(bs..., n, ...) → the (bs·n·A, ...) rows, A trials a chunk."""
        return a.reshape((-1,) + a.shape[nb + 1:]).repeat_interleave(A, 0)

    for seg, (i, j) in zip(problem.segments, problem._seg_slices()):
        L = j - i
        c = min(ms_chunk, L)
        n_c = L // c
        pieces = [(i, i + n_c * c, n_c)]
        if L > n_c * c:
            pieces.append((i + n_c * c, j, 1))
        seg_cost = xs.new_zeros(bs + (A,))
        lanes = problem._lane(seg)
        for lo, hi, n in pieces:
            clen = (hi - lo) // n
            starts = torch.arange(lo, hi, clen, device=xs.device)
            x = rows(integrate(xs[..., starts, :], fs[..., starts, :]))
            alr = al.unsqueeze(-3).expand(bs + (n, A, 1)).reshape(-1, 1)
            c_rows = xs.new_zeros(x.shape[0])
            f_rows = torch.zeros(x.shape[0], dtype=torch.bool,
                                 device=xs.device)
            for s in range(clen):
                ts = starts + s
                sub = tree_map(lambda l: l[lead[1:] + (slice(
                    lo - i + s, hi - i, clen),)], seg)
                if nb:
                    sub = tree_map(lambda l: l.flatten(0, 1), sub)
                x_try = integrate(x, (alr - 1.0) * rows(fs[..., ts, :]))
                dx = diff(rows(xs[..., ts, :]), x_try)
                u_try = (rows(us[..., ts, :]) - alr * rows(k[..., ts, :])
                         - (rows(K[..., ts, :, :]) @ dx[..., None])[..., 0])
                if u_lb is not None:
                    u_try = torch.clamp(u_try, rows(u_lb[..., ts, :]),
                                        rows(u_ub[..., ts, :]))
                x, cc = _rows_calc(sub, x_try, u_try, A, lanes)
                c_rows = c_rows + cc
                # raiseIfNaN per chunk on its running cost and the state
                f_rows = (f_rows | ~(c_rows.abs() < 1e30)
                          | ~(x.abs().amax(-1) < 1e30))
                xs_try[lead + (ts,)] = x_try.view(
                    bs + (n, A, -1)).transpose(nb, nb + 1)
                us_try[lead + (ts,)] = u_try.view(
                    bs + (n, A, -1)).transpose(nb, nb + 1)
            seg_cost = seg_cost + c_rows.view(bs + (n, A)).sum(nb)
            failed = failed | f_rows.view(bs + (n, A)).any(nb)
            x_last = x.view(bs + (n, A, -1)).select(nb, -1)
        cost = cost + seg_cost
    xT = integrate(x_last, (al - 1.0) * fs[..., -1, None, :])
    cost = cost + problem.terminal_calc(xT.reshape(-1, nx)).reshape(
        cost.shape)
    xs_try[..., T, :] = xT
    return xs_try, us_try, cost, failed | ~(cost.abs() < 1e30)


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
    problem's dtype.

    Every decision is a tensor on the problem's device, taken by
    ``control.while_loop`` and ``control.cond`` where JAX's program takes
    it (fddp.py):

    - the regularization ladder's retries, a loop on the probe's failure
      flag (``while_loop`` at :649), and the redo of the full pass when the
      regularization moved (:658), a ``cond``;
    - the sequential line search, a loop over the index of α in a device
      tensor of the step lengths, until a trial is accepted (:744); the
      parallel search picks the first accepted row with ``argmax`` (:720);
    - the iteration loop, on ``iter < maxiter & ~converged & ~diverged``
      (:855), with the trace written at ``iter`` into (maxiter,) columns
      (:781-795).

    In eager mode each loop and branch reads its predicate once on the
    host; under ``torch.export`` (``utils/aot.export_bytes``) they are
    recorded, so the exported program decides on the device.  Export takes
    every problem and setting that the eager solve takes but an
    ``iter_callback``, which runs on the host and only in eager mode (as
    ``jax.export`` refuses a host callback).

    The problem may be a batch of B problems (x0 (B, nx), every leaf with
    a leading problem axis; see ``vmap_solve``); the warm start is
    then (B, T+1, nx) / (B, T, nu) or shared, the bounds and
    ``is_feasible`` broadcast to the batch, and every leaf of the Solution
    carries the problem axis.  A batched solve takes every setting but an
    ``iter_callback``, and is not exported."""
    s = settings
    why = _refusal(problem, s)
    if why is not None:
        raise ValueError(f"unsupported configuration for solve: {why}")
    if control.exporting() and s.iter_callback is not None:
        raise ValueError("export: iter_callback is a host callback, which "
                         "an exported program cannot record (jax.export "
                         "refuses host callbacks too)")
    B = problem.batch
    if B is not None:
        if s.iter_callback is not None:
            raise ValueError("a batched solve takes no iter_callback")
        if control.exporting():
            raise ValueError("export: a batched solve (vmap_solve) is not "
                             "exported")
    bs, nb = (() if B is None else (B,)), (0 if B is None else 1)
    dev = resolve_device(device)
    dt = problem.x0.dtype
    problem = cast(problem, dev, dt)
    seg, term = problem.segments[0], problem.terminal
    T, nu = problem.T, problem.nu
    x0 = problem.x0
    nx = x0.shape[-1]
    fd = s.feasibility_driven
    diff, integrate = _state_ops(problem)
    # the single-problem kernels when asked for, where the structure admits
    # them and there are no bounds (fddp.py:557-561, fused_scans.py:334-340)
    use_fscan = (s.fused_scans and _fsc.supports_problem(problem, s)
                 and problem.on_lanes)
    # kernel 5 takes the trials only without multiple shooting
    # (fddp.py:680-695); the associative-scan pass comes before kernel 4
    fscan_trials = use_fscan and s.ms_chunk == 0
    par_riccati = s.parallel_riccati and not s.box
    tsum = "tij,tj->ti" if B is None else "btij,btj->bti"

    def total(x):
        return control.per_problem(x, nb, "sum")

    def sc(v, dtype=dt):
        return torch.full(bs, v, dtype=dtype, device=dev)

    def where(p, a, b):
        return torch.where(control.lanes(p, a), a, b)

    def shared(a, i):
        """a[i] of a table shared by the problems; (B,) indices give
        (B,)."""
        return control.pick(a, i) if i.dim() == 0 else a.index_select(0, i)

    if s.box:
        if u_lb is None:
            u_lb = getattr(seg, "u_lb", None)
            u_ub = getattr(seg, "u_ub", None)
        if u_lb is None:
            raise ValueError("box solver requires control bounds (u_lb/u_ub)")
        u_lb = torch.as_tensor(u_lb, dtype=dt).to(dev).broadcast_to(
            bs + (T, nu))
        u_ub = torch.as_tensor(u_ub, dtype=dt).to(dev).broadcast_to(
            bs + (T, nu))
        has_limits = (torch.isfinite(u_lb).any(-1)
                      | torch.isfinite(u_ub).any(-1))
        qp_kw = dict(maxiter=s.qp_maxiter, th_acceptstep=s.qp_th_acceptstep,
                     th_grad=s.qp_th_grad, reg=s.qp_reg)
    bounds = (u_lb, u_ub) if s.box else (None, None)

    def warm(init, shape, default):
        if init is None:
            return default()
        init = init.to(device=dev, dtype=dt)
        return init if B is None else init.broadcast_to(shape)
    xs = warm(xs_init, bs + (T + 1, nx),
              lambda: x0[..., None, :].expand(bs + (T + 1, nx))).contiguous()
    us = warm(us_init, bs + (T, nu),
              lambda: torch.zeros(bs + (T, nu), dtype=dt,
                                  device=dev)).contiguous()
    # the regularization and the step lengths live on the device, in the
    # problem's dtype, as the JAX loop keeps them in dt
    reg0 = sc(s.regmin if reginit is None else reginit)
    regmax, regmin = sc(s.regmax), sc(s.regmin)
    alphas = torch.tensor(s.alphas, dtype=dt, device=dev)
    A = s.n_alphas
    # what the loops read of the problem (the stacked knots, the per-knot
    # models, the kernels' descriptors on the card) is built out of them
    if problem.on_lanes:
        _fn.prepare(problem.knots, x0)
    if fscan_trials:
        _fn.prepare(problem.segment_knots, x0)
    elif s.ms_chunk == 0:
        problem._knot_list

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
        if par_riccati:
            def bp(xr, ur, probe=False):
                out = backward_pass_parallel(derivs, dterm, fs, xr, ur)
                return out[-1] if probe else out
        elif use_fscan:
            def bp(xr, ur, probe=False):
                out = _fsc.riccati_backward_fused(derivs, dterm, fs, xr, ur)
                return out[-1] if probe else out
        else:
            box_args = None
            if s.box:
                box_args = (c["us"], u_lb, u_ub, c["k"],
                            has_limits & control.lanes(c["feasible"],
                                                       has_limits), qp_kw)

            def bp(xr, ur, probe=False):
                return _backward_pass(derivs, dterm, fs, xr, ur, box_args,
                                      probe)

        xreg = c["xreg"]
        res0 = bp(xreg, c["ureg"])
        pend0 = res0[-1] & (xreg < regmax)

        def retry(rc):
            xr, _ = rc
            pend = bp(xr, xr, probe=True) & (xr < regmax)
            return torch.where(pend, up(xr), xr), pend
        xr, _ = control.while_loop(lambda rc: rc[1], retry,
                                   (torch.where(pend0, up(xreg), xreg),
                                    pend0))
        # the redo predicate looks at xreg only (fddp.py:659)
        res = control.cond(xr != xreg, lambda _: bp(xr, xr),
                           lambda _: res0)
        return fs, cost, res, xr, c["diverged"] | res[-1]

    def trial_rows(c, fs_fwd, k, K, al):
        """(xs_try, us_try, cost, failed) of the trials at the step lengths
        ``al`` ((A,), or (B, 1) for a batch's own) as rows: kernel 5 (one
        α a problem) for the T running knots and the terminal node here, or
        the generic pass (multiple-shooting with ``ms_chunk``) over all of
        them at once."""
        if not fscan_trials:
            if s.ms_chunk > 0:
                return _forward_pass_ms(problem, c["xs"], c["us"], k, K,
                                        fs_fwd, al, s.ms_chunk, *bounds)
            return _forward_pass(problem, c["xs"], c["us"], k, K, fs_fwd, al,
                                 *bounds)
        alpha = al[..., 0]
        xs_r, us_r, x_last, cost_r, failed = _fsc.trial_rollout_fused(
            problem.segment_knots, x0, c["xs"], c["us"], k, K, fs_fwd, alpha)
        xT = integrate(x_last[..., None, :],
                       (control.lanes(alpha, fs_fwd) - 1.0)
                       * fs_fwd[..., -1:, :])
        cost_try = cost_r + problem.terminal_calc(
            xT.reshape(-1, nx)).reshape(cost_r.shape)
        return (torch.cat([xs_r, xT], -2)[..., None, :, :],
                us_r[..., None, :, :], cost_try[..., None],
                (failed | _bad(cost_try, nb))[..., None])

    def judge(c, alpha, xs_try, cost_try, failed, fs, cost, Vxx, dg, dq):
        """Acceptance of one trial (fddp.py:700-720): (accept, d0, d1)."""
        dV = cost - cost_try
        failed = failed | (cost_try > s.th_blowup * (1.0 + cost.abs()))
        if fd:
            # fddp.cpp:107-124 expectedImprovement at the trial point
            dx = diff(xs_try, c["xs"])
            dv = -total(fs * torch.einsum(tsum, Vxx, dx))
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
            accept = (dVexp >= 0) & ((d0 < s.th_grad) | ~c["feasible"]
                                     | (dV > s.th_acceptstep * dVexp))
        return accept & ~failed, d0, d1

    def line_search(c, fs, cost, res, dg, dq):
        """The step (fddp.py:675-769): (accepted, xs_try, us_try, cost_try,
        steplength, d0, d1) of the accepted trial, or of the last one run
        when none is (the caller keeps the candidate then).  The parallel
        search evaluates every α and takes the first accepted; with none,
        steplength is the last α and d0/d1 are the first trial's
        (fddp.py:722-727).  The kernel path runs the trials one at a time
        and stops at the first accepted, with the same picks.  The
        sequential search stops at the first accepted; with none, d0/d1 are
        the last trial's (fddp.py:731-749)."""
        Vx, Vxx, Qu, k, K, _, _ = res
        fs_fwd = fs if fd else torch.zeros_like(fs)
        if s.parallel_linesearch and not fscan_trials:
            xs_t, us_t, cost_t, failed_t = trial_rows(c, fs_fwd, k, K, alphas)
            judged = [judge(c, alphas[i], xs_t[..., i, :, :],
                            cost_t[..., i], failed_t[..., i], fs, cost, Vxx,
                            dg, dq) for i in range(A)]
            acc, d0s, d1s = (torch.stack(j, -1) for j in zip(*judged))
            j = torch.argmax(acc.to(torch.int32), -1)
            any_acc = acc.any(-1)
            xs_j, us_j, cost_j, d0_j, d1_j = (
                control.pick(a, j) for a in (xs_t, us_t, cost_t, d0s, d1s))
            return (any_acc, xs_j, us_j, cost_j,
                    torch.where(any_acc, shared(alphas, j), alphas[-1]), d0_j,
                    d1_j)

        def ls_body(lc):
            i = lc[0]
            alpha = shared(alphas, i)
            xs_t, us_t, cost_t, failed_t = trial_rows(c, fs_fwd, k, K,
                                                      alpha[..., None])
            acc, d0, d1 = judge(c, alpha, xs_t[..., 0, :, :], cost_t[..., 0],
                                failed_t[..., 0], fs, cost, Vxx, dg, dq)
            first = i == 0
            return (i + 1, acc, xs_t[..., 0, :, :], us_t[..., 0, :, :],
                    cost_t[..., 0], d0, d1, torch.where(first, d0, lc[7]),
                    torch.where(first, d1, lc[8]))
        i, acc, xs_t, us_t, cost_t, d0, d1, d0f, d1f = control.while_loop(
            lambda lc: (lc[0] < A) & ~lc[1], ls_body,
            (torch.zeros(bs, dtype=torch.int64, device=dev),
             torch.zeros(bs, dtype=torch.bool, device=dev),
             torch.zeros_like(c["xs"]), torch.zeros_like(c["us"]))
            + tuple(sc(0.0) for _ in range(5)))
        if s.parallel_linesearch:
            d0, d1 = torch.where(acc, d0, d0f), torch.where(acc, d1, d1f)
        return (acc, xs_t, us_t, cost_t,
                shared(alphas, torch.clamp(i - 1, max=A - 1)), d0, d1)

    def iteration(c):
        """compute_direction, expected improvement, line search,
        regularization schedule, trace, callback and the convergence test
        (fddp.py:797-815).  Returns the new carry and the pre-step
        direction."""
        fs, cost, res, xreg, diverged = compute_direction(c)
        Vx, Vxx, Qu, k, K, Quuk, _ = res
        # expected improvement (fddp.py:666-673)
        dg = total(Qu * k)
        dq = -total(k * Quuk)
        if fd:
            dg = dg - total(Vx * fs)
            dq = dq + total(fs * torch.einsum(tsum, Vxx, fs))
        acc, xs_t, us_t, cost_t, steplength, d0, d1 = line_search(
            c, fs, cost, res, dg, dq)
        xs_n = where(acc, xs_t, c["xs"])
        us_n = where(acc, us_t, c["us"])
        cost_n = torch.where(acc, cost_t, cost)
        feasible, was_feasible = c["feasible"], c["was_feasible"]
        if not fd:
            feas_new = torch.ones_like(feasible)
        elif s.ms_chunk > 0:
            # a multiple-shooting step always leaves chunk-boundary
            # defects: its candidate is never feasible (fddp.py:756-764)
            feas_new = torch.zeros_like(feasible)
        else:
            feas_new = was_feasible | (steplength == 1.0)
        was_feasible = torch.where(acc, feasible, was_feasible)
        feasible = torch.where(acc, feas_new, feasible)
        # regularization schedule (fddp.py:771-779)
        inc = steplength <= s.th_stepinc
        xreg = torch.where(steplength > s.th_stepdec,
                           torch.maximum(xreg / s.regfactor, regmin), xreg)
        xreg = torch.where(inc, up(xreg), xreg)
        diverged = diverged | (inc & (xreg >= regmax))
        stop = total(Qu ** 2)
        it = c["iter"]
        n = dict(c)
        n.update(xs=xs_n, us=us_n, feasible=feasible,
                 was_feasible=was_feasible, xreg=xreg, ureg=xreg.clone(),
                 cost=cost_n, steplength=steplength, d0=d0, d1=d1, stop=stop,
                 k=k, diverged=diverged, iter=it + 1)
        if s.record_trace:
            at = torch.arange(s.maxiter, device=dev) == control.lanes(
                it, c["trace"][0])
            n["trace"] = tuple(
                torch.where(at, control.lanes(v, col), col) for v, col in zip(
                    (cost_n, stop, -d1, xreg, xreg, steplength, feasible),
                    c["trace"]))
        if s.iter_callback is not None:
            s.iter_callback(it, cost_n, xs_n)
        if s.ms_chunk > 0:
            # converged once the gaps contract too (fddp.py:807-812)
            n["converged"] = (stop < s.th_stop) & (control.per_problem(
                fs.abs(), nb, "max") < s.th_gaptol)
        else:
            n["converged"] = was_feasible & (stop < s.th_stop)
        return n, (fs, res)

    false = torch.zeros(bs, dtype=torch.bool, device=dev)
    feasible0 = torch.as_tensor(is_feasible, dtype=torch.bool).to(dev)
    c = dict(xs=xs, us=us,
             feasible=feasible0 if B is None else
             feasible0.broadcast_to(bs).clone(),
             was_feasible=false, xreg=reg0, ureg=reg0.clone(), cost=sc(0.0),
             steplength=sc(1.0), d0=sc(0.0), d1=sc(0.0),
             stop=sc(float("inf")),
             k=torch.zeros(bs + (T, nu), dtype=dt, device=dev),
             iter=torch.zeros(bs, dtype=torch.int32, device=dev),
             converged=false, diverged=false.clone())
    if s.record_trace:
        nan = torch.full(bs + (s.maxiter,), float("nan"), dtype=dt,
                         device=dev)
        c["trace"] = tuple(nan.clone() for _ in range(6)) + (
            torch.zeros(bs + (s.maxiter,), dtype=torch.bool, device=dev),)
    if s.maxiter == 1:
        # the MPC replan: the direction fields are the pre-step candidate's
        c, (fs, res) = iteration(c)
        cost = c["cost"]
    else:
        c = control.while_loop(
            lambda c: ((c["iter"] < s.maxiter) & ~c["converged"]
                       & ~c["diverged"]),
            lambda c: iteration(c)[0], c)
        # the direction at the returned trajectory; its ladder must not
        # overwrite the loop's xreg/ureg/diverged (fddp.py:857-863)
        fs, cost, res, _, _ = compute_direction(c)
    Vx, Vxx, Qu, k, K, _, _ = res
    return Solution(
        xs=c["xs"], us=c["us"], K=K, k=k, Vx=Vx, Vxx=Vxx, Qu=Qu, fs=fs,
        cost=cost, stop=c["stop"], xreg=c["xreg"], ureg=c["ureg"],
        steplength=c["steplength"], d0=c["d0"], d1=c["d1"], iter=c["iter"],
        is_feasible=c["feasible"], converged=c["converged"],
        diverged=c["diverged"],
        trace=Trace(*c["trace"]) if s.record_trace else None)


def vmap_solve(solve_fn):
    """The counterpart of ``jax.vmap(solve_fn)`` for a ``solve_fn`` that
    calls ``solve``: ``run(problems)`` is ``solve_fn(problems)``, called
    once on a batch of B problems of one structure (x0 (B, nx), every leaf
    with a leading problem axis; e.g. ``tree_map(lambda *ls:
    torch.stack(ls), *problems)``), which ``solve`` takes as one program.
    Each problem takes the decisions of its own single ``solve`` (the loops
    run while any problem's predicate holds, and a problem whose predicate
    is false keeps its state).  A batched solve refuses an
    ``iter_callback`` and export."""
    def run(*args, **kwargs):
        return solve_fn(*args, **kwargs)
    return run


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
