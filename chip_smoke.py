#!/usr/bin/env python3
"""Drive the PyTorch port's two paths, the rest of ``solve``, the quadruped
gaits, the MPC loop, the generic rigid-body node, the biped, humanoid and
quadrotor of the model zoo, the segmented problems of the true impulse
switch knot, the data-parallel fleet with the display and aot layers,
whole exported solves and batched solves once on one NVIDIA GPU.

Phases (any failure exits non-zero; each prints its seconds):

1. card: CUDA present, card name and power limit, TF32 off;
2. build: compile the five CUDA kernels of crocoddyl_tpu_torch/csrc for
   sm_90a, one nvcc per source, all at once;
3. kernels: each kernel against its plain PyTorch version on the card:
   the batch lane's node, Riccati and rollout kernels in float64 at the
   reduced walk (B=3: a CTA whose second warp lies past B) and at bench
   size and in float32 at bench size; the b=1 lane's Riccati and rollout
   kernels (and the node kernel at the T+1 nodes of one problem) in
   float64 at the reduced walk and at T=108 and, at the warm start,
   float32 against the float64 plain version; a forced Riccati failure,
   and forced rollout failures (one lane's gaps, and in one extra b=1
   call all gaps, scaled by 1e35) flagged by kernel and plain alike; the
   registers, stack and spills (``ptxas -v``) of kernels 1 to 5, and the
   launch shapes (CTAs, threads, nodes or problems per CTA, dynamic shared
   memory) of kernels 1 (at N=27,904 and N=109), 2, 3 and 4 per dtype;
4. batch lane: ``solve_batch(maxiter=1)`` on the ANYmal walk (T=108,
   B=256) through the kernels in float32 (launch counts, finite costs),
   then the float64 kernel path against the float64 plain path (same
   decisions);
5. b=1 lane: ``solve(maxiter=1)``, the MPC replan, on the same walk from
   the quasi-static warm start through kernels 1, 4 and 5 in float32
   (launch counts, finite cost); float64 kernel path against plain path
   (same decisions); ``solve(maxiter=20)`` on the reduced walk, kernel
   path against plain path (same decisions); ``solve(maxiter=50)`` at
   T=108 converges and becomes the steady-state warm start;
6. solver surface: four replans of the T=108 walk through ``solve`` in
   float32: Box-FDDP with the URDF's effort limits from the rollout of
   the quasi-static controls (kernel 1 and the generic passes: kernels 4
   and 5 must not run; the BoxQP solves' iterations and the controls on a
   bound), the default ``SolverSettings(maxiter=1)`` (kernel 1 and the
   generic passes), DDP and ``SolverSettings(fused_scans=True)`` with the
   parallel line search and the trace (kernels 1, 4 and 5),
   no plain call on any; each in float64 against the plain path (same
   decisions); a binding Box-FDDP replan (0.15 × the limits, from the
   rollout of the clamped quasi-static controls) on the reduced walk,
   kernel against plain path; the unicycle anchor, FDDP and
   Box-FDDP, on the card against the CPU; the four float32 times (CUDA
   events, no warm-up beyond the run above, median of 3; the box and the
   default-settings replans timed in their first run, host clock to a
   device sync, the box replan's with the syncs of phase 8's split);
7. timing: CUDA events, one warm-up, median of 5 runs: the batch step, the
   cold and the steady-state b=1 replan, and each kernel beside its plain
   version (one run, no warm-up: a plain rollout takes seconds) at its
   lane's shapes;
8. profile: one float32 batch step and one float32 cold replan under
   ``torch.profiler``: each kernel's device time, the rest of the device
   time (ATen glue), the idle share of the wall time and the stream syncs
   (chiprun_out/chip_smoke/profile.json and profile_b1.json); the host-
   clock split of phase 6's first float32 box replan into linearization,
   backward passes and trial rollouts;
9. gaits and MPC: (a) the five gaits of examples/quadrupedal_gaits.py on
   the programmatic quadruped (T = 108, 56, 62, 76, 61), each a float32
   cold replan through kernels 1, 4 and 5 (launches, no plain call, finite
   cost; timed once), the jump and the trot in float64 against the plain
   path (same decisions, cost rtol 1e-8), and the graft entry's walk
   through ``solve_batch`` at B=2 in float32 (kernels 1 to 3); (b) the
   quadruped anchors of tests/golden.json in float64 on the card, the
   walk through kernels 1, 4 and 5 and the Box-FDDP walk through kernel 1
   and the generic passes, with the bar of tests/test_examples_golden.py
   (in ``goldens_worker``, beside phases 3-5);
   (c) the receding-horizon loop of examples/mpc_receding_horizon.py on
   the T=108 walk in float32: a maxiter=60 plan, then 6 ticks of horizon
   rotation, shifted warm start and maxiter=1 replan (tick latency p50 and
   p90, the plant step timed apart, the kernel descriptors' share,
   launches per tick, no divergence), and 1 float64 tick against the
   plain path (same decisions; cost and the plant's x0 rtol 1e-8);
10. generic nodes: the two fixed-base anchors of tests/golden.json built
   from the port's modules and solved on the card in float64 through the
   generic ``RigidBodyNode`` and the generic passes, kernels 1, 4 and 5
   launched 0 times: examples/arm_manipulation.py (T=250, DDP) held to its
   golden with the bar of tests/test_examples_golden.py, and
   examples/double_pendulum.py (T=100, a user ``Actuation``), its first
   iteration held to the same solve on the CPU and its solve capped at
   ``DP_MAXITER`` iterations (its golden is printed beside it, not held:
   that solve turns rounding-level differences into another local
   minimum, tests/test_torch_generic_node.py) (the two anchors in
   ``exports_worker``, beside phases 3-5);
   the T=108 walk's replan launching what phase 5 launched; the reduced
   walk with a FramePlacement cost on its terminal (kernel 1 for the
   running knots at each linearization, the generic terminal) against the
   plain path in float64; the generic node's ``calc_both`` under ``vmap``
   over the T=108 walk's 109 knots against kernel 1 in float64 (1e-9 of
   each field's max-abs); and the first float32 numbers of the generic
   path: one arm DDP replan (one run) with its host-clock split, and one
   vmapped ``calc_both`` over its 251 knots;
11. the model zoo (6D contacts, the CoP cost, the multicopter and
   squashing actuations), every solve in it through the generic node and
   the generic passes with kernels 1 to 5 launched 0 times and no plain
   version called: (a) the thesis's CoP walk of
   examples/bipedal_walk_cop.py at the example's size (the biped, T=60,
   a CoP support cost on every supporting sole) as a float32 cold replan
   (FDDP maxiter=1 from the quasi-static controls; one run with the
   host-clock split), and in float64 on the card against the CPU (the
   same decisions and xreg, cost rtol 1e-10 or 4 × the card's own
   sensitivity, ``cost_tol``); (b) the goldens
   ``bipedal_walk_cop_fast``, ``humanoid_taichi_fast``, ``quadrotor`` and
   ``quadrotor_ubound`` in float64 with the bar of
   tests/test_examples_golden.py, held where the record is
   rounding-stable (``ZOO_UNSTABLE``: the first iteration against the CPU,
   ``converged`` and the cost held, the iterations' bar printed); on the
   CoP walk's solution the worst CoP-barrier residual and apps/rh5.py's
   ``calc_cops``, ``calc_zmps`` and ``log_solution_csv``
   (chiprun_out/chip_smoke/bipedal_walk_cop_fast.csv); and the CoP walk of
   tests/test_gaits.py:121-150 (0.3 m steps) converged with every CoP
   inside its support (worst residual > -0.5); (b) and the walk of
   tests/test_gaits.py run in ``goldens_worker``, beside phases 3-5;
12. segments: (a) the true-impulse ANYmal walk at bench size
   (``pseudo_impulse=False``: T=108 in 8 segments, 104 rigid-body knots
   and 4 ``ImpulseNode`` knots) as a float32 cold replan
   (``SolverSettings(maxiter=1)`` from the quasi-static controls): kernel
   1 on the rigid-body group, kernels 2-5 at 0 launches, no plain call,
   one timed run and the host-clock split, and in float64 kernel against
   plain path (same decisions, cost rtol 1e-8, or ``cost_tol`` above it);
   (b) the reduced
   true-impulse walk of tests/test_gaits.py:104-118 (T=22) solved in
   float64 (``maxiter=60``) on the card against the CPU; (c) the
   true-impulse CoP walk (examples/bipedal_walk_cop.py --impulse, T=60) as
   a float32 cold replan (every kernel at 0 launches) and in float64 on
   the card against the CPU (``cost_tol`` from 1e-10); (d) 1 float32 MPC
   tick of ``rotate_segmented``, ``shift_warm_start`` and a replan on the
   reduced walk (p50, p90) and 1 float64 tick kernel against plain path;
   (e) the unicycle anchors with ``ms_chunk=8`` and
   ``parallel_riccati=True`` on the card against the CPU, and the
   one-segment T=108 walk's float32 replans with ``ms_chunk=12`` (kernel
   1 only) and with ``fused_scans=True, parallel_riccati=True`` (kernels 1
   and 5, not 4), timed once with their host-clock split, each in float64
   kernel against plain path; (f) the oracles on the card: an impulse
   knot's derivatives against ``numdiff_fxlx`` and one dense KKT step
   against the Riccati step on the reduced true-impulse walk;
13. fleet: (a) phase 4's B=256 walk in float64 split over two ranks of
   ``crocoddyl_tpu_torch.parallel`` (spawned processes, gloo, both on
   ``cuda:0``), each running ``solve_batch(maxiter=1)`` on its 128 problems
   through kernels 1-3 (its launches printed), the gathered batch held to
   phase 4's one-process solve (the same decisions, cost rtol 1e-12) and
   the ranks' ``fleet_metrics`` to the one process's (mean cost rtol
   1e-14, fractions equal); (b) the same split in float32 timed once
   against the one-process step (the ranks share one card: what the layer
   costs, not a scaling figure; held to no decision); (c)
   ``dryrun_multichip`` with one NCCL rank per card (``all_reduce`` on
   CUDA tensors); (d) ``skeleton`` of the float64 walk solution on the card
   against the CPU (atol 1e-12) and ``export_html``'s JSON payload; (e)
   ``aot.precompile`` of a ``solve_batch`` call: the next call compiles
   nothing, builds no kernel descriptor and gives the same costs;
14. export: the T=108 walk's replan ``solve(maxiter=1, fused_scans=True)``
   and phase 4's batch step ``solve_batch(maxiter=1)`` at B=256, whose
   ladders, line searches and iteration loops decide on the device, each
   recorded whole by ``aot.export_bytes`` in float64 and float32 and
   loaded with ``aot.import_bytes`` (program bytes, export seconds): the
   float64 programs against the eager solves on the card (the same
   decisions, lane by lane; cost rtol 1e-12), the float32 programs'
   launches of kernels 1, 4 and 5 and of kernels 1, 2 and 3 (the custom
   ops ``torch.ops.crocoddyl_tpu_torch.*``; no plain call), CUDA-event
   medians of the eager solves and of the programs, and the stream syncs
   and device-to-host copies of one run of each under ``torch.profiler``
   beside the counts of the solvers that decided on the host.  Then, in
   float64 only, three solves whose nodes take their derivatives outside
   kernel 1: (a) the thesis's CoP walk (T=60, generic ``RigidBodyNode``
   running and terminal) and (b) the true-impulse walk (T=108, 8
   segments: kernel 1 on the 104 rigid-body knots, ``ImpulseNode``s at
   the 4 switch knots), each ``solve(maxiter=1)`` from its quasi-static
   warm start, and (c) the Box-DDP solve of examples/boxfddp_vs_boxddp.py
   (the arm, T=60, dt=2e-3, ``box_ddp_settings(maxiter=100)``, bounds
   ±0.15 × the effort limits), each exported and loaded on the card: the
   program against the eager solve (the same decisions, cost rtol 1e-12),
   the program's launches equal to the eager solve's (kernel 1: 0, the
   eager count and 0; no plain call), (c) held to its golden (bar of
   tests/test_examples_golden.py:49-58; the record is rounding-stable,
   ``golden_sensitivity.py boxfddp_vs_boxddp``) eagerly and loaded, the
   program's bytes, the export seconds and one CUDA-event time each of
   the eager solve and the program after a warm-up.  Every program of the
   phase is run once eagerly and then exported on the card in
   ``exports_worker``, beside phases 3-5;
15. batched solves (``vmap_solve``, the counterpart of
   ``jax.vmap(solve)``): (a) the six walks of
   examples/baumgarte_grid_search.py (the ported example's grid, T=30,
   contact gains Kv from 0 to 200) in float64, ``maxiter=3``, batched
   against each problem's single solve on the card (the decisions and
   xreg equal, cost rtol 1e-8, us max abs 1e-6), kernel 1 launched once
   a batched linearization, no plain call; (b) the same six with
   ``fused_scans=True``: the batched solve's launches of kernels 4 and 5
   at least the single solve's that needs most and fewer than the six's
   sum; kernels 4 and 5 over the six problems (one launch of P=6 CTAs)
   bitwise equal to six single-problem launches on the same inputs, and
   against their plain versions at phase 3's bars, a forced failure of
   problem 5 (its gaps × 1e35) flagged by kernel and plain alike; (c) the
   arm's Box-DDP of examples/boxfddp_vs_boxddp.py (T=60) over four
   initial states through ``parallel.sharded_solve_x0`` on a one-rank
   mesh: problem 0 (the example's x0) held to its golden (the bar of
   tests/test_examples_golden.py:49-58), the others to their single
   solves, no kernel launched; (a)-(c) in ``vmap_worker``, beside phases
   3-5; (d) after phase 14: one float32 CUDA-event time each, after a
   warm-up, of the six walks' batched ``maxiter=1`` replan against the
   six single replans in series (default settings and ``fused_scans``),
   and kernels 4 and 5 at P=6 beside their plain versions and bound.

Three spawned processes, ``exports_worker``, ``goldens_worker`` and
``vmap_worker``, start after the build and end before phase 6: phases 3-5
time nothing, and phases 6-15 run with no other process on the card.  The anchors' seconds
that the workers print are not metrics.

The line before the last two is the ``kernels`` JSON object: for each of
the five kernels its launches on its lane's main path (and on each replan
of phase 6, ``launches_surface``, per MPC tick, ``launches_mpc``, on
phase 10's two generic solves, ``launches_generic``, on phase 11's
solves, ``launches_zoo``, on phase 12's, ``launches_seg``, on each
rank of phase 13, ``launches_fleet``, on phase 14's float32 programs
and float64 node-kind programs, ``launches_export``, and on phase 15's
batched solves, ``launches_vmap``), its error against
the plain version, its time and the plain version's, and its bound: the
larger of its bytes (inputs read once, outputs written once) over 3.35
TB/s and its operations over 67 TFLOP/s (float32 outside the tensor cores;
operations counted by a dispatch-level counter over the plain version at
one node or one step, scaled by the shapes); kernels 4 and 5 also over
phase 15's six problems (``ms_p6``, ``plain_ms_p6``, ``bound_ms_p6``,
``bound_by_p6``, and ``max_abs_err_p6_f64`` against the plain version in
float64).

Usage: ``python3 chip_smoke.py`` from the repository root (one GPU).  The
last line of standard output is ``{"ok": true, "device": {...}}``; the line
before it is the card's ``name, power.limit``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "chiprun_out", "chip_smoke")
FEET = ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"]
B_BENCH = 256
DEVICE = "cuda:0"

# tolerances, relative to each output's max-abs value
TOL_F64 = 1e-9      # same math, other summation order
TOL_GAIN_F64 = 1e-8  # k and K solve Quu·k = Qu with cond(Quu) ~ 1e6 on this
#                     walk: a last-bit change of Quu moves them ~1e-9
# float32: the kernel and its plain version each carry their own rounding
# error, and on this walk the Riccati pass amplifies it to ~1e-2 of |V|
# (Vxx reaches 2e7, and T=108 steps compound it), so the two are not held
# to each other.  Both are held to the float64 plain version on the same
# (float32-rounded) inputs: the kernel's error may be at most F32_FACTOR
# times the plain version's, or TOL_F32.  A wrong index or term gives O(1).
F32_FACTOR = 4.0
TOL_F32 = 1e-4
# float32 Riccati checks run at the warm start and this regularization: at
# random states, or below ~1e-2, Quu loses definiteness in float32 on this
# walk (the plain version fails too), and a lane on the edge could flip
REG_F32 = 1.0
# the bound of a kernel: bytes over the memory rate, operations over the
# float32 rate outside the tensor cores (H100 SXM data sheet, 700 W)
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12
# each kernel's wrapper in crocoddyl_tpu_torch/ops/cuda_kernels.py
WRAPPER = {"node": "node_calc_both", "riccati": "riccati_backward",
           "rollout": "trial_rollout", "riccati_b1": "riccati_backward_b1",
           "rollout_b1": "trial_rollout_b1"}
LIBRARY_NONE = ("no single PyTorch call computes it: a sequential "
                "recursion or node model written for this solver")


def log(*a):
    print(*a, flush=True)


class CheckFailed(Exception):
    pass


def need(ok, msg):
    """Fail the smoke run (an explicit check: ``python -O`` keeps it)."""
    if not ok:
        raise CheckFailed(msg)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def rel_err(a, b):
    a = a.double()
    b = b.double()
    return float((a - b).abs().max() / a.abs().max().clamp_min(1e-300))


def abs_err(a, b):
    return float((a.double() - b.double()).abs().max())


def build_walk(torch, step_knots, support_knots, pseudo_impulse=True):
    """The ANYmal walk of bench.py:52-75 (a fresh factory), with true
    impulse switch knots when ``pseudo_impulse`` is False; (problem, xs0,
    us0) from the quasi-static warm start, float64 on the CPU."""
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.anymal(dtype=torch.float64)
    q0 = robots.anymal_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    prob = fac.walking_problem(x0, 0.25, 0.15, 1e-2, step_knots=step_knots,
                               support_knots=support_knots,
                               pseudo_impulse=pseudo_impulse)
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)
    return prob, xs0, us0


def to_dev(torch, tree, dev, dt):
    from crocoddyl_tpu_torch.utils.struct import tree_map
    return tree_map(lambda l: l.to(device=dev, dtype=dt)
                    if l.is_floating_point() else l.to(dev), tree)


def kernel_inputs(torch, prob, B, dev, dt, seed, warm=None):
    """Node, Riccati and rollout inputs: a randomly perturbed trajectory, or,
    with ``warm`` = (xs0, us0), the warm start with 1e-3 noise on the
    velocities and controls (where the float32 solve works)."""
    from crocoddyl_tpu_torch.utils.struct import tree_map
    rng = np.random.default_rng(seed)
    T, nx, nu = prob.T, prob.state.nx, prob.nu
    nq, ndx = prob.state.nq, prob.state.ndx
    term = prob.terminal.replace(dt=torch.zeros_like(prob.terminal.dt))
    knots = tree_map(lambda r, t: torch.cat([r, t[None]]), prob.running, term)
    if warm is None:
        x0 = prob.x0.cpu().numpy()
        xs = np.tile(x0[None, :, None], (T + 1, 1, B))
        xs = xs + 0.01 * rng.standard_normal(xs.shape)
        xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=1, keepdims=True)
        us = 0.5 * rng.standard_normal((T, nu, B))
    else:
        xs = np.tile(warm[0].cpu().numpy()[:, :, None], (1, 1, B))
        xs[:, nq:] += 1e-3 * rng.standard_normal(xs[:, nq:].shape)
        us = np.tile(warm[1].cpu().numpy()[:, :, None], (1, 1, B))
        us = us + 1e-3 * rng.standard_normal(us.shape)
    xs_l = torch.tensor(xs, dtype=dt, device=dev)
    us_l = torch.tensor(us, dtype=dt, device=dev)
    u_all = torch.cat([us_l, torch.zeros((1, nu, B), dtype=dt, device=dev)])
    x_n = xs_l.movedim(0, 1).reshape(nx, -1).contiguous()
    u_n = u_all.movedim(0, 1).reshape(nu, -1).contiguous()
    fs = torch.tensor(1e-3 * rng.standard_normal((T + 1, ndx, B)),
                      dtype=dt, device=dev)
    return dict(knots=knots, x_n=x_n, u_n=u_n, xs_l=xs_l, us_l=us_l, fs=fs)


def split_derivs(torch, derivs_n, T, B):
    from crocoddyl_tpu_torch.utils.struct import tree_map
    d = tree_map(lambda a: a.reshape(a.shape[:-1] + (T + 1, B)).movedim(-2, 0)
                 .contiguous(), derivs_n)
    return (tree_map(lambda a: a[:T].contiguous(), d),
            tree_map(lambda a: a[T].contiguous(), d))


def _agree(tag, kernel, names, k_out, p_out, r_out, ok=None):
    """Hold a kernel's outputs to its plain version's (float64: ``r_out`` is
    None) or to the float64 plain version's ``r_out`` (float32); lanes
    outside ``ok`` are left out.  Returns the worst |kernel − plain|."""
    worst_abs = 0.0
    for i, name in enumerate(names):
        k, p = k_out[i], p_out[i]
        r = None if r_out is None else r_out[i]
        if ok is not None:
            k, p = k[..., ok], p[..., ok]
            r = None if r is None else r[..., ok]
        if r is None:
            e = rel_err(p, k)
            tol = TOL_GAIN_F64 if name in ("k", "K") else TOL_F64
            log(f"  [{tag}] {kernel} {name}: rel {e:.3e} (tol {tol:.0e})")
        else:
            e, ep = rel_err(r, k), rel_err(r, p)
            tol = max(F32_FACTOR * ep, TOL_F32)
            log(f"  [{tag}] {kernel} {name}: rel to f64 {e:.3e}, plain "
                f"f32 {ep:.3e} (tol {tol:.3e})")
        need(e <= tol, f"{kernel} kernel disagrees ({tag}, {name}): {e:.3e}")
        worst_abs = max(worst_abs, abs_err(p, k))
    return worst_abs


def check_kernels(torch, prob, B, dev, dt, tag, seed=0, warm=None,
                  reg=1e-9):
    """Each kernel against its plain version (and, in float32, against the
    float64 plain version of the same inputs), the Riccati pass at
    regularization ``reg``; returns {kernel: max_abs} and the inputs."""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    f32 = dt == torch.float32
    inp = kernel_inputs(torch, prob, B, dev, dt, seed, warm)
    T = prob.T

    def up(tree):
        return to_dev(torch, tree, dev, torch.float64) if f32 else None

    errs = {}
    # node linearization
    fields = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
    kd, kx, kc = ck.node_calc_both(inp["knots"], inp["x_n"], inp["u_n"])
    pd, px, pc = fn.calc_both_lanes_plain(inp["knots"], inp["x_n"],
                                          inp["u_n"])
    rn = None
    if f32:
        rd, rx, rc = fn.calc_both_lanes_plain(
            up(inp["knots"]), up(inp["x_n"]), up(inp["u_n"]))
        rn = [getattr(rd, f) for f in fields] + [rx, rc]
    torch.cuda.synchronize()
    errs["node"] = _agree(tag, "node", fields + ("xnext", "cost"),
                          [getattr(kd, f) for f in fields] + [kx, kc],
                          [getattr(pd, f) for f in fields] + [px, pc], rn)
    # Riccati, on the plain node derivatives; lane 0 gets a non-PD Quu
    derivs_l, dterm_l = split_derivs(torch, pd, T, B)
    xreg = torch.full((B,), reg, dtype=dt, device=dev)
    ureg = xreg.clone()
    ureg[0] = -1e6
    ric_in = (derivs_l, dterm_l, inp["fs"], xreg, ureg)
    kr = ck.riccati_backward(*ric_in)
    pr = fsc.riccati_backward_lanes_plain(*ric_in)
    rr = fsc.riccati_backward_lanes_plain(*up(ric_in)) if f32 else None
    torch.cuda.synchronize()
    need(bool((kr[-1] == pr[-1]).all()), f"Riccati failure flags ({tag})")
    need(bool(pr[-1][0]) and not bool(pr[-1][1:].any()),
         f"Riccati failure flags not as set up ({tag}): {pr[-1].tolist()}")
    names = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")
    errs["riccati"] = _agree(tag, "riccati", names, kr[:-1], pr[:-1],
                             None if rr is None else rr[:-1], ~pr[-1])
    # rollout at alpha = 0.5 with the plain gains; the last lane's gaps are
    # scaled by 1e35, so that lane must fail in the kernel and the plain
    # version alike
    ureg[0] = reg
    _, _, _, k_l, K_l, _, _ = fsc.riccati_backward_lanes_plain(*ric_in)
    fs_r = inp["fs"][:-1].clone()
    fs_r[..., B - 1] *= 1e35
    args = (prob.running, inp["xs_l"][0], inp["xs_l"][:-1].contiguous(),
            inp["us_l"], k_l.contiguous(), K_l.contiguous(), fs_r)
    ko = ck.trial_rollout(*args, 0.5)
    po = fsc.trial_rollout_lanes_plain(*args, inp["fs"][-1], 0.5)
    ro = (fsc.trial_rollout_lanes_plain(*up(args + (inp["fs"][-1],)), 0.5)
          if f32 else None)
    torch.cuda.synchronize()
    need(bool((ko[-1] == po[-1]).all()), f"rollout failure flags ({tag}): "
         f"kernel {ko[-1].tolist()}, plain {po[-1].tolist()}")
    need(bool(po[-1][B - 1]), f"rollout forced failure not flagged ({tag})")
    ok = ~po[-1]
    log(f"  [{tag}] rollout: {int(ok.sum())}/{B} lanes without failure, "
        f"forced failure of lane {B - 1} flagged by kernel and plain")
    names = ("xs_try", "us_try", "x_last", "cost")
    errs["rollout"] = _agree(tag, "rollout", names, ko[:-1], po[:-1],
                             None if ro is None else ro[:-1], ok)
    return errs, inp, derivs_l, dterm_l, xreg, k_l, K_l



def check_b1_kernels(torch, prob, dev, dt, tag, seed=0, warm=None, reg=1e-9):
    """The b=1 lane's kernels against their plain versions on one problem:
    the node kernel at the T+1 nodes, the single-problem Riccati pass at
    regularization ``reg`` (and with a negative ureg, which must fail in
    both), the single-problem rollout at α=0.5 with the plain gains.
    Returns ({kernel: max_abs}, the inputs of each kernel)."""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    from crocoddyl_tpu_torch.utils.struct import tree_map
    f32 = dt == torch.float32
    inp = kernel_inputs(torch, prob, 1, dev, dt, seed, warm)
    T = prob.T

    def up(tree):
        return to_dev(torch, tree, dev, torch.float64) if f32 else None

    def one(tree):
        return tree_map(lambda a: a[..., 0].contiguous(), tree)
    errs = {}
    fields = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
    node_args = (inp["knots"], inp["x_n"], inp["u_n"])
    kd, kx, kc = ck.node_calc_both(*node_args)
    pd, px, pc = fn.calc_both_lanes_plain(*node_args)
    rn = None
    if f32:
        rd, rx, rc = fn.calc_both_lanes_plain(*up(node_args))
        rn = [getattr(rd, f) for f in fields] + [rx, rc]
    torch.cuda.synchronize()
    errs["node_b1"] = _agree(tag, "node b=1", fields + ("xnext", "cost"),
                             [getattr(kd, f) for f in fields] + [kx, kc],
                             [getattr(pd, f) for f in fields] + [px, pc], rn)
    derivs_l, dterm_l = split_derivs(torch, pd, T, 1)
    ric_args = (one(derivs_l), one(dterm_l), inp["fs"][..., 0].contiguous())
    kr = ck.riccati_backward_b1(*ric_args, reg, reg)
    pr = fsc.riccati_backward_fused_plain(*ric_args, reg, reg)
    rr = (fsc.riccati_backward_fused_plain(*up(ric_args), reg, reg)
          if f32 else None)
    kf = ck.riccati_backward_b1(*ric_args, reg, -1e6)[-1]
    pf = fsc.riccati_backward_fused_plain(*ric_args, reg, -1e6)[-1]
    torch.cuda.synchronize()
    need(not bool(kr[-1]) and not bool(pr[-1]),
         f"riccati b=1 failed at reg {reg} ({tag}): kernel {bool(kr[-1])}, "
         f"plain {bool(pr[-1])}")
    need(bool(kf) and bool(pf), f"riccati b=1 forced failure not flagged "
         f"({tag}): kernel {bool(kf)}, plain {bool(pf)}")
    names = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")
    errs["riccati_b1"] = _agree(tag, "riccati b=1", names, kr[:-1], pr[:-1],
                                None if rr is None else rr[:-1])
    ro_args = (prob.running, inp["xs_l"][0, :, 0].contiguous(),
               inp["xs_l"][:-1, :, 0].contiguous(),
               inp["us_l"][..., 0].contiguous(), pr[3], pr[4],
               ric_args[2][:-1].contiguous())
    ko = ck.trial_rollout_b1(*ro_args, 0.5)
    po = fsc.trial_rollout_fused_plain(*ro_args, 0.5)
    ro = fsc.trial_rollout_fused_plain(*up(ro_args), 0.5) if f32 else None
    torch.cuda.synchronize()
    need(bool(ko[-1]) == bool(po[-1]) and not bool(po[-1]),
         f"rollout b=1 failure flags ({tag}): kernel {bool(ko[-1])}, plain "
         f"{bool(po[-1])}")
    fs_bad = ro_args[6] * 1e35
    kf = ck.trial_rollout_b1(*ro_args[:6], fs_bad, 0.5)[-1]
    pf = fsc.trial_rollout_fused_plain(*ro_args[:6], fs_bad, 0.5)[-1]
    torch.cuda.synchronize()
    need(bool(kf) and bool(pf), f"rollout b=1 forced failure (gaps x 1e35) "
         f"not flagged ({tag}): kernel {bool(kf)}, plain {bool(pf)}")
    log(f"  [{tag}] rollout b=1: forced failure flagged by kernel and plain")
    names = ("xs_try", "us_try", "x_last", "cost")
    errs["rollout_b1"] = _agree(tag, "rollout b=1", names, ko[:-1], po[:-1],
                                None if ro is None else ro[:-1])
    return errs, dict(node_b1=node_args, riccati_b1=ric_args,
                      rollout_b1=ro_args)


def ptxas_lines(build_log, kernels):
    """``ptxas -v``'s registers, stack, spills and shared memory of each
    kernel whose (mangled) name holds one of ``kernels``, labelled with its
    template arguments (the scalar, and the Riccati kernels' padded nu)."""
    import re
    out, name = [], None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            name = None
            for k in kernels:
                if f"{len(k)}{k}I" in mangled:
                    args = ["double" if f"{len(k)}{k}Id" in mangled
                            else "float"]
                    args += re.findall(r"Li(\d+)E", mangled)
                    name = f"{k}<{', '.join(args)}>"
                    break
        elif name and ("spill" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def log_launch_shapes(torch, ck, prob, dev):
    """Kernels 1 to 4's launch shapes at the main path's sizes, per dtype,
    as their launchers compute them."""
    from crocoddyl_tpu_torch.utils.struct import tree_map
    T, ndx, nu = prob.T, prob.state.ndx, prob.nu
    term = prob.terminal.replace(dt=torch.zeros_like(prob.terminal.dt))
    knots = tree_map(lambda r, t: torch.cat([r, t[None]]), prob.running, term)
    for dt in (torch.float32, torch.float64):
        for N in ((T + 1) * B_BENCH, T + 1):
            ctas, threads, per, smem = ck.node_launch_shape(knots, N, dt, dev)
            log(f"[kernels] node kernel launch at N={N} ({dt}): {ctas} CTAs "
                f"of {threads} threads, {per} nodes (one a warp) per CTA, "
                f"{smem} B of dynamic shared memory per CTA")
        k2, k4 = ck.riccati_launch_shape(B_BENCH, ndx, nu, dt)
        log(f"[kernels] riccati kernel launch at B={B_BENCH} ({dt}): "
            f"{k2[0]} CTAs of {k2[1]} threads, 1 problem per CTA, {k2[2]} B "
            f"of dynamic shared memory per CTA")
        log(f"[kernels] riccati_b1 kernel launch ({dt}): {k4[0]} CTA of "
            f"{k4[1]} threads, {k4[2]} B of dynamic shared memory")
        ctas, threads, smem = ck.rollout_launch_shape(prob.running, B_BENCH,
                                                      dt)
        log(f"[kernels] rollout kernel launch at B={B_BENCH} ({dt}): {ctas} "
            f"CTAs of {threads // 32} warps (one problem per warp), {smem} B "
            f"of dynamic shared memory per CTA")


def count_ops(torch, fn):
    """Floating-point operations that ``fn()`` dispatches: 2·m·k·n for a
    matrix product, the input size for a reduction, the output size for
    any other operation on floating tensors; copies, views, concatenation,
    indexing, selection (``where``) and tensor creation count nothing."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_flatten
    free = {"view", "_unsafe_view", "reshape", "expand", "clone", "copy",
            "_to_copy", "slice", "select", "cat", "stack", "index_select",
            "index", "permute", "transpose", "t", "unsqueeze", "squeeze",
            "unbind", "split", "split_with_sizes", "alias", "detach",
            "lift_fresh", "as_strided", "zeros", "zeros_like", "ones",
            "ones_like", "full", "full_like", "empty", "empty_like",
            "new_zeros", "new_ones", "new_full", "new_empty",
            "empty_strided", "arange", "eye", "fill", "where",
            "scalar_tensor", "_local_scalar_dense", "masked_fill",
            "repeat", "expand_as", "lift_fresh_copy", "movedim"}
    reduce_ = {"sum", "amax", "amin", "max", "min", "mean", "prod", "any",
               "all", "norm", "linalg_vector_norm"}
    mm = {"mm", "bmm", "matmul", "addmm", "baddbmm"}
    total = [0]

    class Counter(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__.rstrip("_")
            ins = [a for a in tree_flatten((args, kwargs))[0]
                   if isinstance(a, torch.Tensor)]
            if name in free or not any(a.is_floating_point() for a in ins):
                return out
            if name in mm:
                total[0] += 2 * ins[-2].numel() * ins[-1].shape[-1]
            elif name in reduce_:
                total[0] += max(a.numel() for a in ins)
            else:
                total[0] += sum(o.numel() for o in tree_flatten(out)[0]
                                if isinstance(o, torch.Tensor))
            return out
    with Counter():
        fn()
    return total[0]


def op_counts(torch, prob):
    """Operations per node of the node linearization, per Riccati step (and
    the terminal), per rollout step: ``count_ops`` over the plain versions
    on the CPU in float64 at one node, and at one and two steps."""
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    from crocoddyl_tpu_torch.utils.struct import tree_map
    cpu = to_dev(torch, prob, "cpu", torch.float64)
    inp = kernel_inputs(torch, cpu, 1, "cpu", torch.float64, seed=0)
    knot0 = tree_map(lambda l: l[:1], inp["knots"])
    node = count_ops(torch, lambda: fn.calc_both_lanes_plain(
        knot0, inp["x_n"][:, :1], inp["u_n"][:, :1]))
    pd = fn.calc_both_lanes_plain(inp["knots"], inp["x_n"], inp["u_n"])[0]
    d_l, dT_l = split_derivs(torch, pd, prob.T, 1)
    reg = torch.full((1,), 1e-9, dtype=torch.float64)
    _, _, _, k_l, K_l, _, _ = fsc.riccati_backward_lanes_plain(
        d_l, dT_l, inp["fs"], reg, reg)

    def ric(n):
        return count_ops(torch, lambda: fsc.riccati_backward_lanes_plain(
            tree_map(lambda a: a[:n], d_l), dT_l, inp["fs"][:n + 1], reg,
            reg))

    def ro(n):
        return count_ops(torch, lambda: fsc.trial_rollout_lanes_plain(
            tree_map(lambda l: l[:n], cpu.running), inp["xs_l"][0],
            inp["xs_l"][:n], inp["us_l"][:n], k_l[:n], K_l[:n],
            inp["fs"][:n], None, 0.5))
    r1, r2 = ric(1), ric(2)
    return dict(node=node, riccati_step=r2 - r1, riccati_term=2 * r1 - r2,
                rollout_step=ro(2) - ro(1))


def nbytes(torch, *trees):
    """Bytes of every tensor in ``trees``."""
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(trees)[0]
               if isinstance(t, torch.Tensor))


def same(tag, a, b, fields):
    """Fail unless the solutions ``a`` and ``b`` agree in ``fields``."""
    for fld in fields:
        x, y = getattr(a, fld).cpu(), getattr(b, fld).cpu()
        need(x.equal(y), f"{tag}: {fld} differs: {x.tolist()} vs "
             f"{y.tolist()}")


def bound_ms(n_bytes, n_ops):
    """(ms, what bounds it): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    t_b, t_o = n_bytes / PEAK_BYTES * 1e3, n_ops / PEAK_F32 * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


class plain_path:
    """Within the block, the solvers call the plain versions in place of
    the kernels (the plain path: the same solvers on the same device)."""

    def __enter__(self):
        from crocoddyl_tpu_torch.ops import fused_node as fn
        from crocoddyl_tpu_torch.ops import fused_scans as fsc
        self.saved = [(fn, "calc_both_lanes", fn.calc_both_lanes_plain)] + [
            (fsc, n, getattr(fsc, n + "_plain"))
            for n in ("riccati_backward_lanes", "trial_rollout_lanes",
                      "riccati_backward_fused", "trial_rollout_fused")]
        self.saved = [(m, n, getattr(m, n), p) for m, n, p in self.saved]
        for m, n, _, p in self.saved:
            setattr(m, n, p)

    def __exit__(self, *exc):
        for m, n, orig, _ in self.saved:
            setattr(m, n, orig)


def reset_counts():
    """Zero every kernel's launch count and every plain version's call
    count."""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    ck.reset_counts()
    for f in (fn.calc_both_lanes_plain,) + fsc.PLAIN:
        f.calls = 0


def plain_calls():
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    return [f.calls for f in (fn.calc_both_lanes_plain,) + fsc.PLAIN]


def cuda_time(torch, fn, runs=5, warmup=True):
    """Median milliseconds of ``fn`` over ``runs`` runs, after one warm-up
    unless the caller ran ``fn`` already (``warmup=False``)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def profile_step(torch, step, keys, warmup=True):
    """Device-time breakdown of one ``step()`` under torch.profiler (after a
    warm-up run unless ``warmup=False``): ms per kernel of the path (a
    device event whose name holds ``{key}_kernel``), the other device time
    (glue), the device total, the wall time and its idle share; None if
    the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if warmup:
        step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {k: 0.0 for k in keys}
    total, glue_n, syncs, h2d, d2h = 0.0, 0, 0, 0, 0
    # the raw events: ``prof.events()`` parses each into a Python object
    # (~80 µs an event), minutes for the ~3M events of a box replan
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            syncs += name == "cudaStreamSynchronize"
            continue
        if e.is_user_annotation():
            continue
        ms = e.duration_ns() / 1e6
        total += ms
        h2d += "HtoD" in name
        d2h += "DtoH" in name
        for k in kern:
            if f"{k}_kernel" in name:
                kern[k] += ms
                break
        else:
            glue_n += 1
    if total == 0.0:
        return None
    glue = total - sum(kern.values())
    return {"kernel_ms": kern, "glue_ms": glue, "glue_events": glue_n,
            "device_ms": total, "wall_ms": wall,
            "idle_ms": wall - total, "idle_share": (wall - total) / wall,
            "stream_syncs": syncs, "h2d_copies": h2d, "d2h_copies": d2h}


# The Box-FDDP replans' cost is held to 1e-8 or to SENS_FACTOR times the
# plain path's own sensitivity, whichever is larger (``cost_tol``; phase
# 11 holds its card-against-CPU costs so, from 1e-10: the T=60 CoP walk's
# replan cost moves by ~1e-9 under such a change): at the URDF's limits
# most BoxQPs of the walk run to maxiter (a clamped control keeps max|g|
# above th_grad) and the backward pass then moves with the rounding of its
# inputs, so a change of the node derivatives as small as the node kernel's
# float64 error (DERIV_EPS relative) moves the replan's cost by more than
# 1e-8 (the JAX package's box pass moves as much).  The sensitivity is the
# plain path's cost change when its node derivatives are multiplied by
# (1 + DERIV_EPS·N(0, 1)), measured in the same run.
DERIV_EPS = 1e-14
SENS_FACTOR = 4.0


class perturbed_derivs:
    """Within the block, the solvers' node derivatives are multiplied by
    (1 + eps·N(0, 1)), drawn from a generator seeded on their device."""

    def __init__(self, torch, eps, seed=0):
        self.torch, self.eps, self.seed = torch, eps, seed

    def __enter__(self):
        from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
        from crocoddyl_tpu_torch.utils.struct import tree_map
        torch, eps = self.torch, self.eps
        self.mod, self.orig = tfddp, tfddp._calc_diff

        def calc_diff(*a, **k):
            d, dterm, fs, cost = self.orig(*a, **k)
            g = torch.Generator(device=fs.device).manual_seed(self.seed)
            d = tree_map(lambda l: l * (1 + eps * torch.randn(
                l.shape, generator=g, dtype=l.dtype, device=l.device)), d)
            return d, dterm, fs, cost
        tfddp._calc_diff = calc_diff
        return self

    def __exit__(self, *exc):
        self.mod._calc_diff = self.orig


def cost_tol(torch, run, plain_cost, floor=1e-8):
    """(tolerance, sensitivity) of a replan's cost against another path's
    (the Box-FDDP replans' kernel against plain path; phase 11's card
    against the CPU): ``run()`` once more on the plain path with perturbed
    node derivatives (see DERIV_EPS); the tolerance is ``floor`` or
    SENS_FACTOR times the sensitivity, whichever is larger."""
    with plain_path(), perturbed_derivs(torch, DERIV_EPS):
        pert = run()
    sens = float((pert.cost - plain_cost).abs() / plain_cost.abs())
    return max(floor, SENS_FACTOR * sens), sens


class record_qp:
    """Within the block, every BoxQP solve's iteration count and free set
    are kept (device tensors, read after the run): the solver reads
    neither, so the run is the same."""

    def __enter__(self):
        from crocoddyl_tpu_torch.core.solvers import boxqp
        self.mod, self.orig, self.out = boxqp, boxqp.solve, []

        def rec(*a, **k):
            sol = self.orig(*a, **k)
            self.out.append((sol.iterations, sol.free))
            return sol
        boxqp.solve = rec
        return self

    def __exit__(self, *exc):
        self.mod.solve = self.orig

    def summary(self, torch, T):
        """(QP solves, total, mean and largest iteration count, clamped
        controls in the last T solves: the final backward pass)."""
        if not self.out:
            return 0, 0, 0.0, 0, 0
        its = torch.stack([i for i, _ in self.out]).cpu()
        clamped = int(sum(int((~f).sum()) for _, f in self.out[-T:]))
        return (len(self.out), int(its.sum()), float(its.double().mean()),
                int(its.max()), clamped)


def host_split(torch, step):
    """Wall milliseconds of one ``step()`` and of the solver's
    linearizations (``_calc_diff``: kernel 1 and the gaps), generic
    backward passes (with their BoxQPs) and generic trial rollouts, each
    timed between device syncs on the host clock (the rest is the line
    search's decisions and glue); the multiple-shooting rollouts and the
    associative-scan backward passes apart."""
    from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
    acc = {"_calc_diff": 0.0, "_backward_pass": 0.0, "_forward_pass": 0.0,
           "_forward_pass_ms": 0.0, "backward_pass_parallel": 0.0}
    saved = {n: getattr(tfddp, n) for n in acc}

    def timed(name, f):
        def w(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = f(*a, **k)
            torch.cuda.synchronize()
            acc[name] += (time.perf_counter() - t0) * 1e3
            return out
        return w
    for n, f in saved.items():
        setattr(tfddp, n, timed(n, f))
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for n, f in saved.items():
            setattr(tfddp, n, f)
    return wall, acc


# examples/quadrupedal_gaits.py:24-35, on robots.quadruped from
# quadruped_standing_q: T = 108, 56, 62, 76 and 61
GAITS = {
    "walking": dict(step_length=0.25, step_height=0.15, dt=1e-2,
                    step_knots=25, support_knots=2),
    "trotting": dict(step_length=0.15, step_height=0.1, dt=1e-2,
                     step_knots=25, support_knots=2),
    "pacing": dict(step_length=0.15, step_height=0.1, dt=1e-2,
                   step_knots=25, support_knots=5),
    "bounding": dict(step_length=0.007, step_height=0.05, dt=1e-2,
                     step_knots=25, support_knots=12),
    "jumping": dict(jump_height=0.15, jump_length=[0.0, 0.3, 0.0], dt=1e-2,
                    ground_knots=10, flying_knots=20),
}
# the gaits whose float64 replans are held to the plain path: the jump
# (its flight knots have every contact inactive) and a gait that swings
# two feet at once
GAITS_F64 = ("jumping", "trotting")
# examples/mpc_receding_horizon.py:65 runs 50; 20 and 3 until phase 14
# came, 10 until phase 15: the script's time limit
MPC_TICKS = 6
# float64 ticks held to the plain path (~20 s each on the card's host): 3
# until phase 14, 2 until its float64 node kinds
MPC_F64_TICKS = 1


def gait_problem(torch, name):
    """(problem, xs0, us0) of one of GAITS, float64 on the CPU, built by a
    fresh factory, with the quasi-static warm start."""
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    prob = getattr(fac, f"{name}_problem")(x0, **GAITS[name])
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    return prob, xs0, prob.quasi_static(xs0)


def b1_launches(ck):
    """Launches of kernels 1, 4 and 5 since the counts were last zeroed."""
    return {"node": ck.node_calc_both.launches,
            "riccati_b1": ck.riccati_backward_b1.launches,
            "rollout_b1": ck.trial_rollout_b1.launches}


def run_gaits(torch, ck, dev, card):
    """Phase 9a: each gait's float32 cold replan through kernels 1, 4 and 5
    (launches, no plain call, finite cost; one timed run), the GAITS_F64
    replans in float64 against the plain path, and the graft entry's
    programmatic walk through ``solve_batch`` at B=2.  Returns {gait: ms}."""
    from crocoddyl_tpu_torch import SolverSettings, solve, solve_batch
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    f32, f64 = torch.float32, torch.float64
    st = SolverSettings(maxiter=1, fused_scans=True, parallel_linesearch=False,
                        record_trace=False)
    times = {}
    for name in GAITS:
        prob, xs0, us0 = gait_problem(torch, name)

        def replan(dt, p=to_dev(torch, prob, dev, f32)):
            return solve(p, xs0.to(dev, dt), us0.to(dev, dt), st,
                         device=dev)
        reset_counts()
        sol = replan(f32)
        torch.cuda.synchronize()
        got = b1_launches(ck)
        need(all(v > 0 for v in got.values()), f"{name}: launches {got}")
        need(not any(plain_calls()), f"{name}: plain versions ran")
        need(bool(torch.isfinite(sol.cost)), f"{name}: non-finite cost")
        # one timed run, not the median of 3: the script's time limit
        times[name] = cuda_time(torch, lambda: replan(f32), runs=1,
                                warmup=False)
        log(f"[gaits] f32 {name} T={prob.T} cold replan: {times[name]:.2f} ms "
            f"(one run), launches {got}, cost {float(sol.cost):.6e}, "
            f"steplength {float(sol.steplength)}, xreg "
            f"{float(sol.xreg):.1e}  ({card})")
        if name in GAITS_F64:
            p64 = to_dev(torch, prob, dev, f64)
            k64 = replan(f64, p64)
            with plain_path():
                r64 = replan(f64, p64)
            same(f"{name} f64 replan", k64, r64,
                 ("iter", "steplength", "is_feasible"))
            rc = float((k64.cost - r64.cost).abs() / r64.cost.abs())
            log(f"[gaits] f64 {name} replan kernel vs plain: iter "
                f"{int(k64.iter)}, steplength {float(k64.steplength)}, "
                f"feasible {bool(k64.is_feasible)} in both, cost rtol "
                f"{rc:.3e}")
            need(rc <= 1e-8, f"{name} f64 replan: cost rtol {rc:.3e}")
    # __graft_entry__.py:14-27: the programmatic walk at step_knots=2,
    # support_knots=1, built in float32, two initial states
    m = robots.quadruped(dtype=f32)
    q0 = robots.quadruped_standing_q(m, dtype=f32)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=f32)])
    prob = QuadrupedGaitFactory(m, FEET, default_q=q0).walking_problem(
        x0, 0.1, 0.05, 1e-2, step_knots=2, support_knots=1)
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)
    x0s = x0[None].repeat(2, 1)
    x0s[1, m.nq] += 0.01
    reset_counts()
    sol = solve_batch(prob, x0s.to(dev), xs_init=xs0.to(dev),
                      us_init=us0.to(dev), settings=SolverSettings(
                          maxiter=1, record_trace=False,
                          parallel_linesearch=False), device=dev)
    torch.cuda.synchronize()
    got = {"node": ck.node_calc_both.launches,
           "riccati": ck.riccati_backward.launches,
           "rollout": ck.trial_rollout.launches}
    log(f"[gaits] f32 graft-entry walk T={prob.T} solve_batch B=2: launches "
        f"{got}, costs {sol.cost.tolist()}")
    need(all(v > 0 for v in got.values()), f"graft entry: launches {got}")
    need(not any(plain_calls()), "graft entry: plain versions ran")
    need(sol.cost.dtype == f32 and bool(torch.isfinite(sol.cost).all()),
         "graft entry: costs")
    return times


def run_goldens(torch, dev):
    """Phase 9b: the two quadruped anchors of tests/golden.json solved on
    the card in float64, with the bar of tests/test_examples_golden.py:51-60
    (``converged`` equal, iterations within 1, cost rtol 1e-5)."""
    from crocoddyl_tpu_torch import SolverSettings, box_fddp_settings, solve
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)
    f64 = torch.float64

    def build(m, height, step_knots):
        q0 = robots.quadruped_standing_q(m, height=height)
        x0 = torch.cat([q0, torch.zeros(m.nv, dtype=f64)])
        prob = QuadrupedGaitFactory(m, FEET, default_q=q0).walking_problem(
            x0, 0.25, 0.15, 1e-2, step_knots=step_knots, support_knots=1)
        xs0 = x0[None].expand(prob.T + 1, -1).clone()
        return to_dev(torch, prob, dev, f64), xs0, prob.quasi_static(xs0)

    # tests/golden_configs.py:191-210 and
    # examples/quadrupedal_walk_ubound.py:22-37 at step_knots=6
    walk = build(robots.anymal(), 0.48, 3)
    quad = robots.quadruped()
    lim = quad.effort_limit[6:]
    ubound = build(quad, 0.5, 6)
    cases = {
        "quadrupedal_walking_fast": (walk, SolverSettings(
            maxiter=40, fused_scans=True), {}),
        "quadrupedal_walk_ubound_fast": (ubound, box_fddp_settings(
            maxiter=40), dict(u_lb=-lim, u_ub=lim))}
    for name, ((p, xs0, us0), st, kw) in cases.items():
        t0 = time.perf_counter()
        sol = solve(p, xs0.to(dev), us0.to(dev), st, device=dev, **kw)
        secs = time.perf_counter() - t0
        g = golden[name]
        rc = abs(float(sol.cost) - g["cost"]) / abs(g["cost"])
        log(f"[golden] f64 {name} T={p.T} on the card: converged "
            f"{bool(sol.converged)} in {int(sol.iter)} iterations, cost "
            f"{float(sol.cost)!r}; golden {g['converged']}, {g['iters']}, "
            f"{g['cost']!r}: cost rtol {rc:.3e} (tol 1e-5); {secs:.1f} s")
        need(bool(sol.converged) == g["converged"]
             and abs(int(sol.iter) - g["iters"]) <= 1 and rc <= 1e-5,
             f"golden {name}")


def mpc_loop(torch, ck, dev, card, prob, xs0, us0, p64, xs_conv, us_conv):
    """Phase 9c, examples/mpc_receding_horizon.py:40-94 --quadruped on the
    T=108 walk: a float32 plan (maxiter=60, sequential line search), one
    warm-up tick and MPC_TICKS ticks, each the horizon rotation, the
    shifted warm start and a maxiter=1 replan through kernels 1, 4 and 5,
    with the plant step ``node0.calc(x0, us[0])`` timed on its own outside
    the tick; the descriptors' share of the tick; then MPC_F64_TICKS
    float64 ticks from the converged float64 plan, kernel path against
    plain path.  Returns {wrapper name: launches per tick}."""
    from crocoddyl_tpu_torch import (SolverSettings, circular_append,
                                     shift_warm_start, solve)
    from crocoddyl_tpu_torch.utils.struct import tree_map
    f32 = torch.float32
    seq = dict(parallel_linesearch=False, record_trace=False,
               fused_scans=True)
    tick_st = SolverSettings(maxiter=1, **seq)

    def plant(p, us):
        return tree_map(lambda l: l[0], p.running).calc(p.x0, us[0])[0]

    def tick(p, xs, us, x_next):
        p = circular_append(p, new_x0=x_next)
        xs, us = shift_warm_start(xs, us, x_next)
        return p, solve(p, xs, us, tick_st, device=dev)

    def synced(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    p = to_dev(torch, prob, dev, f32)
    plan = solve(p, xs0.to(dev, f32), us0.to(dev, f32),
                 SolverSettings(maxiter=60, **seq), device=dev)
    log(f"[mpc] f32 T={p.T} plan: converged {bool(plan.converged)}, "
        f"diverged {bool(plan.diverged)} in {int(plan.iter)} iterations, "
        f"cost {float(plan.cost):.6e}")
    xs, us = plan.xs, plan.us
    x_next = plant(p, us)
    p, s = tick(p, xs, us, x_next)          # warm-up tick
    xs, us = s.xs, s.us
    reset_counts()
    lat, plant_ms, costs = [], [], []
    for _ in range(MPC_TICKS):
        x_next, ms = synced(lambda: plant(p, us))
        plant_ms.append(ms)
        (p, s), ms = synced(lambda: tick(p, xs, us, x_next))
        lat.append(ms)
        need(not bool(s.diverged) and bool(torch.isfinite(s.cost)),
             f"MPC tick {len(lat)} diverged")
        xs, us = s.xs, s.us
        costs.append(float(s.cost))
    per_tick = {w.__name__: w.launches / MPC_TICKS for w in ck.WRAPPERS}
    need(not any(plain_calls()), "MPC: plain versions ran")
    need(all(per_tick[n] > 0 for n in ("node_calc_both",
                                       "riccati_backward_b1",
                                       "trial_rollout_b1")),
         f"MPC: launches {per_tick}")
    # the two descriptors a tick builds, on a fresh rotated problem: the
    # T+1 knots (kernel 1) and the T running knots (kernel 5)
    rot = circular_append(p, new_x0=x_next)
    knots, knots_ms = synced(lambda: rot.knots)
    _, desc_ms = synced(lambda: (ck.descriptor(knots, dev, f32),
                                 ck.descriptor(rot.running, dev, f32)))
    p50, p90 = np.percentile(lat, 50), np.percentile(lat, 90)
    log(f"[mpc] f32 T={p.T}, {MPC_TICKS} ticks: tick p50 {p50:.2f} ms, p90 "
        f"{p90:.2f} ms; plant step p50 {np.median(plant_ms):.2f} ms (outside "
        f"the tick); descriptors of a rotated problem {desc_ms:.2f} ms "
        f"({100 * desc_ms / p50:.1f} % of p50), its knots {knots_ms:.2f} ms; "
        f"launches per tick {per_tick}; cost {costs[0]:.4e} -> "
        f"{costs[-1]:.4e}, no tick diverged  ({card})")

    def ticks():
        p, xs, us, rows = p64, xs_conv.to(dev), us_conv.to(dev), []
        for _ in range(MPC_F64_TICKS):
            p, s = tick(p, xs, us, plant(p, us))
            rows.append((s, p.x0))
            xs, us = s.xs, s.us
        return rows
    k_rows = ticks()
    with plain_path():
        p_rows = ticks()
    for i, ((k, kx), (r, rx)) in enumerate(zip(k_rows, p_rows)):
        same(f"MPC f64 tick {i}", k, r, ("iter", "steplength", "is_feasible",
                                         "diverged"))
        rc = float((k.cost - r.cost).abs() / r.cost.abs())
        rx0 = rel_err(rx, kx)
        log(f"[mpc] f64 tick {i} kernel vs plain: steplength "
            f"{float(k.steplength)}, feasible {bool(k.is_feasible)} in both, "
            f"cost rtol {rc:.3e}, x0 rel {rx0:.3e}")
        need(rc <= 1e-8 and rx0 <= 1e-8, f"MPC f64 tick {i}")
    return per_tick


# ---------------------------------------------------------------------------
# Phase 10: the generic rigid-body node
# ---------------------------------------------------------------------------

_ACTUATION = []
# the double pendulum's solve, capped: its golden is printed, not held
DP_MAXITER = 5


def second_joint_actuation():
    """examples/double_pendulum.py:33-43 as a port ``Actuation``: only the
    second joint is actuated, and the class defines only ``nu`` and
    ``calc`` (built once: a class is a pytree type)."""
    if not _ACTUATION:
        import torch
        from crocoddyl_tpu_torch.models.multibody.actuations import Actuation

        class SecondJointActuation(Actuation):
            @property
            def nu(self) -> int:
                return 1

            def calc(self, x, u):
                return torch.cat([u.new_zeros(1), u])
        _ACTUATION.append(SecondJointActuation)
    return _ACTUATION[0]


def arm_problem(torch, T=250, dt=1e-3):
    """examples/arm_manipulation.py:29-56 from the port's modules: robot
    arm7, gripper FramePlacement to (0, 0, 0.4) with weight 1, state and
    control regularization 1e-4, armature 0.1 on joints 1-6, the same node
    as the dt=0 terminal.  Returns (problem, warm xs, quasi-static us),
    float64 on the CPU."""
    from crocoddyl_tpu_torch import (CostFramePlacement, CostStack,
                                     RigidBodyNode, ShootingProblem, arm7,
                                     stack_models)
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad)
    from crocoddyl_tpu_torch.models.multibody.actuations import (
        FullActuation)
    from crocoddyl_tpu_torch.models.multibody.costs import (CostControl,
                                                            CostState)
    f64 = torch.float64
    m = arm7()
    st = StateMultibody(model=m)
    q0 = torch.tensor([0.5, 0.6, -0.8, 1.2, 0.4, 0.3, 0.0], dtype=f64)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=f64)])

    def w(v):
        return torch.tensor(v, dtype=f64)

    def node(dt_):
        costs = CostStack(items=(
            CostFramePlacement(fid=m.frame_id("gripper"),
                               ref_R=torch.eye(3, dtype=f64),
                               ref_p=w([0.0, 0.0, 0.4]),
                               activation=ActivationQuad(), weight=w(1.0),
                               active=w(1.0)),
            CostState(xref=x0, activation=ActivationQuad(), weight=w(1e-4),
                      active=w(1.0)),
            CostControl(uref=torch.zeros(m.nv, dtype=f64),
                        activation=ActivationQuad(), weight=w(1e-4),
                        active=w(1.0))))
        return RigidBodyNode(state_=st, actuation=FullActuation(nv=m.nv),
                             costs=costs, armature=w([0.1] * 6 + [0.0]),
                             dt=w(dt_))

    prob = ShootingProblem(x0=x0, running=stack_models([node(dt)] * T),
                           terminal=node(0.0))
    xs0 = x0[None].expand(T + 1, -1).clone()
    return prob, xs0, prob.quasi_static(xs0)


def double_pendulum_problem(torch, T=100, dt=1e-2):
    """examples/double_pendulum.py:46-76 from the port's modules: robot
    double_pendulum from rest, upright target (π, 0) with weights (1, 1,
    0.1, 0.1) scaled 0.1 on the running knots and 1e4 on the dt=0
    terminal, control 1e-4."""
    from crocoddyl_tpu_torch import (CostStack, RigidBodyNode,
                                     ShootingProblem, double_pendulum,
                                     stack_models)
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad, ActivationWeightedQuad)
    from crocoddyl_tpu_torch.models.multibody.costs import (CostControl,
                                                            CostState)
    f64 = torch.float64
    m = double_pendulum()
    st = StateMultibody(model=m)
    act = second_joint_actuation()(nv=m.nv)

    def w(v):
        return torch.tensor(v, dtype=f64)

    def node(w_goal, dt_):
        costs = CostStack(items=(
            CostState(xref=w([np.pi, 0.0, 0.0, 0.0]),
                      activation=ActivationWeightedQuad(
                          weights=w([1.0, 1.0, 0.1, 0.1])),
                      weight=w(w_goal), active=w(1.0)),
            CostControl(uref=torch.zeros(1, dtype=f64),
                        activation=ActivationQuad(), weight=w(1e-4),
                        active=w(1.0))))
        return RigidBodyNode(state_=st, actuation=act, costs=costs,
                             dt=w(dt_))

    return ShootingProblem(x0=torch.zeros(4, dtype=f64),
                           running=stack_models([node(1e-1, dt)] * T),
                           terminal=node(1e4, 0.0))


def all_launches(ck):
    return {w.__name__: w.launches for w in ck.WRAPPERS}


def generic_anchors(torch, ck, dev, card):
    """Phase 10's two anchors (see the module docstring), float64 solves
    held to their golden records and to the CPU.  Returns {anchor:
    {wrapper: launches}}."""
    from crocoddyl_tpu_torch import SolverSettings, ddp_settings, solve
    f64 = torch.float64
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)
    launches = {}

    def generic_solve(name, prob, st, xs=None, us=None):
        """One float64 solve on the card with every count zeroed first:
        (solution, seconds); kernels 1, 4 and 5 and the plain versions
        must not run."""
        p = to_dev(torch, prob, dev, f64)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve(p, None if xs is None else xs.to(dev),
                    None if us is None else us.to(dev), st, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = all_launches(ck)
        need(not any(launches[name].values()),
             f"{name}: kernels launched {launches[name]}")
        need(not any(plain_calls()), f"{name}: plain versions ran")
        need(bool(torch.isfinite(sol.cost)), f"{name}: non-finite cost")
        return sol, secs

    def vs_golden(name, sol, secs):
        g = golden[name]
        rc = abs(float(sol.cost) - g["cost"]) / abs(g["cost"])
        ok = (bool(sol.converged) == g["converged"]
              and abs(int(sol.iter) - g["iters"]) <= 1 and rc <= 1e-5)
        log(f"[generic] f64 {name} on the card: converged "
            f"{bool(sol.converged)} in {int(sol.iter)} iterations, cost "
            f"{float(sol.cost)!r}; golden {g['converged']}, {g['iters']}, "
            f"{g['cost']!r}: cost rtol {rc:.3e}, bar of "
            f"tests/test_examples_golden.py {'met' if ok else 'not met'}; "
            f"{secs:.1f} s; launches {launches[name]}  ({card})")
        return ok

    # -- the arm anchor, held to its golden ---------------------------------
    sol, secs = generic_solve("arm_manipulation", arm_problem(torch)[0],
                              ddp_settings(maxiter=100))
    need(vs_golden("arm_manipulation", sol, secs), "arm_manipulation golden")

    # -- the double pendulum: first iteration held to the CPU; the solve
    # capped at DP_MAXITER (its golden is not rounding-stable, and the
    # uncapped solve, ~65 s, does not fit the script's time with phase 11)
    dp = double_pendulum_problem(torch)
    sol, secs = generic_solve("double_pendulum", dp,
                              SolverSettings(maxiter=DP_MAXITER))
    vs_golden("double_pendulum", sol, secs)
    one = SolverSettings(maxiter=1)
    k1 = solve(to_dev(torch, dp, dev, f64), settings=one, device=dev)
    c1 = solve(dp, settings=one, device="cpu")
    same("double_pendulum first iteration, card vs CPU", k1, c1,
         ("iter", "steplength", "xreg", "is_feasible"))
    rc = float((k1.cost.cpu() - c1.cost).abs() / c1.cost.abs())
    log(f"[generic] f64 double_pendulum first iteration on the card vs the "
        f"CPU: steplength {float(k1.steplength)}, xreg {float(k1.xreg):.1e} "
        f"in both, cost rtol {rc:.3e} (tol 1e-9)")
    need(rc <= 1e-9, f"double_pendulum first iteration: cost rtol {rc:.3e}")
    return launches


def run_generic(torch, ck, dev, card, walk64, walk_replan, launches_b1,
                small):
    """Phase 10 but its two anchors (``generic_anchors``): the dispatch by
    structure, the mixed problem, the generic node against kernel 1 and
    the float32 numbers.  ``walk64``: the T=108 walk in float64 on the
    card; ``walk_replan()``: phase 5's float32 cold replan of it, whose
    launches were ``launches_b1``; ``small``: the reduced walk (CPU)."""
    from crocoddyl_tpu_torch import (CostFramePlacement, CostStack,
                                     SolverSettings, ddp_settings, solve)
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad)
    from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
    f32, f64 = torch.float32, torch.float64
    arm, arm_xs0, arm_us0 = arm_problem(torch)

    # -- dispatch by structure: the walk's replan launches what phase 5 did -
    reset_counts()
    walk_replan()
    torch.cuda.synchronize()
    got = b1_launches(ck)
    log(f"[generic] f32 T={walk64.T} walk cold replan (fused_scans=True) "
        f"again: launches {got}, phase 5 {launches_b1}")
    need(got["node"] == launches_b1["node"] == 1
         and got["riccati_b1"] > 0 and got["rollout_b1"] > 0,
         f"walk replan launches {got}, phase 5 {launches_b1}")

    # -- a mixed problem: kernel 1 on the running knots, generic terminal --
    term = small.terminal
    place = CostFramePlacement(
        fid=term.contacts.contacts[1].fid,
        ref_R=torch.eye(3, dtype=f64),
        ref_p=torch.tensor([0.3, 0.2, 0.0], dtype=f64),
        activation=ActivationQuad(), weight=torch.tensor(10.0, dtype=f64),
        active=torch.tensor(1.0, dtype=f64))
    mixed = small.replace(terminal=term.replace(costs=CostStack(
        items=term.costs.items + (place,))))
    need(not mixed.on_lanes, "mixed problem: terminal admitted")
    mixed64 = to_dev(torch, mixed, dev, f64)
    n_lin = [0]
    orig = tfddp._calc_diff

    def counted(*a, **k):
        n_lin[0] += 1
        return orig(*a, **k)
    st = SolverSettings(maxiter=3)
    tfddp._calc_diff = counted
    try:
        reset_counts()
        km = solve(mixed64, settings=st, device=dev)
        torch.cuda.synchronize()
        got = b1_launches(ck)
    finally:
        tfddp._calc_diff = orig
    with plain_path():
        pm = solve(mixed64, settings=st, device=dev)
    same("mixed problem f64", km, pm, ("iter", "steplength", "is_feasible"))
    rc = float((km.cost - pm.cost).abs() / pm.cost.abs())
    log(f"[generic] f64 reduced walk T={mixed.T} + FramePlacement terminal, "
        f"maxiter=3: launches {got} over {n_lin[0]} linearizations; kernel "
        f"vs plain path: iter {int(km.iter)}, steplength "
        f"{float(km.steplength)}, feasible {bool(km.is_feasible)} in both, "
        f"cost rtol {rc:.3e} (tol 1e-8)")
    need(got == {"node": n_lin[0], "riccati_b1": 0, "rollout_b1": 0},
         f"mixed problem: launches {got}, {n_lin[0]} linearizations")
    need(rc <= 1e-8, f"mixed problem: cost rtol {rc:.3e}")

    # -- the generic node against kernel 1 on the walk's knots, float64 ----
    inp = kernel_inputs(torch, walk64, 1, dev, f64, seed=10)
    knots, x_n, u_n = inp["knots"], inp["x_n"], inp["u_n"]
    kd, kx, kc = ck.node_calc_both(knots, x_n, u_n)
    gd, gx, gc = torch.func.vmap(lambda m, x, u: m.calc_both(x, u))(
        knots, x_n.T, u_n.T)
    errs = {f: rel_err(getattr(kd, f).movedim(-1, 0), getattr(gd, f))
            for f in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")}
    errs.update(xnext=rel_err(kx.T, gx), cost=rel_err(kc, gc))
    log(f"[generic] f64 generic calc_both (vmap) vs kernel 1 over the "
        f"{x_n.shape[-1]} knots of the T={walk64.T} walk, max-abs error "
        f"over max-abs value: " + ", ".join(f"{k} {v:.2e}"
                                            for k, v in errs.items()))
    need(max(errs.values()) <= TOL_F64, f"generic vs kernel 1: {errs}")

    # -- first float32 numbers of the generic path ---------------------------
    arm32 = to_dev(torch, arm, dev, f32)
    replan_st = ddp_settings(maxiter=1)

    def replan():
        return solve(arm32, arm_xs0.to(dev, f32), arm_us0.to(dev, f32),
                     replan_st, device=dev)
    # one run, counted and timed (not the median of 3): the script's time
    # limit
    reset_counts()
    out = []
    wall, split = host_split(torch, lambda: out.append(replan()))
    s32 = out[0]
    got = all_launches(ck)
    need(not any(got.values()), f"arm f32 replan: launches {got}")
    need(bool(torch.isfinite(s32.cost)), "arm f32 replan: cost")
    rest = wall - sum(split.values())
    log(f"[generic] time f32 arm T={arm.T} DDP replan (maxiter=1, from the "
        f"quasi-static controls): {wall:.2f} ms (one run), steplength "
        f"{float(s32.steplength)}, launches {got}; host clock between "
        f"syncs: wall {wall:.1f} ms = calc_diff {split['_calc_diff']:.1f} "
        f"+ backward passes {split['_backward_pass']:.1f} + trial rollouts "
        f"{split['_forward_pass']:.1f} + rest {rest:.1f}  ({card})")
    knots32 = arm32.knots
    X = arm_xs0.to(dev, f32)
    U = torch.cat([arm_us0, arm_us0.new_zeros((1, arm.nu))]).to(dev, f32)

    def vcalc():
        return torch.func.vmap(lambda m, x, u: m.calc_both(x, u))(
            knots32, X, U)
    vms = cuda_time(torch, vcalc, runs=3)
    log(f"[generic] time f32 vmapped generic calc_both over the arm's "
        f"{arm.T + 1} knots: {vms:.2f} ms (median of 3)  ({card})")


# ---------------------------------------------------------------------------
# Phase 11: the biped, the humanoid and the quadrotor
# ---------------------------------------------------------------------------

# examples/bipedal_walk_cop.py:34,68: the RH5 sole box and the biped's soles
FOOT_BOX = (0.2, 0.08)
SOLES = ["right_sole", "left_sole"]
_COP_FACTORY = []


def cop_factory():
    """examples/bipedal_walk_cop.py:38-43 on the port: the biped gait
    factory with a CoP support cost (weight 1e3) on every supporting foot
    (built once)."""
    if not _COP_FACTORY:
        from crocoddyl_tpu_torch.apps.gaits import BipedGaitFactory

        class CoPBipedGaitFactory(BipedGaitFactory):
            cop_box = FOOT_BOX
            w_cop = 1e3
        _COP_FACTORY.append(CoPBipedGaitFactory)
    return _COP_FACTORY[0]


def cop_walk_problem(torch, step_knots=20, support_knots=9,
                     pseudo_impulse=True):
    """examples/bipedal_walk_cop.py:64-76 from the port's modules: the CoP
    walk of the biped from ``biped_standing_q`` (T = 2·support_knots +
    2·(step_knots + 1)), with the state tiled from x0 and the quasi-static
    controls; true impulse switch knots (``--impulse``) when
    ``pseudo_impulse`` is False.  Returns (problem, xs0, us0), float64 on
    the CPU."""
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.biped()
    q0 = robots.biped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    prob = cop_factory()(m, SOLES, default_q=q0).walking_problem(
        x0, 0.6, 0.1, 0.03, step_knots=step_knots,
        support_knots=support_knots, pseudo_impulse=pseudo_impulse)
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    return prob, xs0, prob.quasi_static(xs0)


def cop_in_support(problem, sol):
    """The most negative CoP-barrier residual A·f over the supporting feet
    along the solution (examples/bipedal_walk_cop.py:46-61): ≥ 0 is inside
    every support rectangle."""
    from crocoddyl_tpu_torch.models.multibody.costs import CostContactCoP
    from crocoddyl_tpu_torch.utils.struct import tree_map
    worst = 0.0
    for t in range(problem.T):
        m = tree_map(lambda l: l[t], problem.running)
        x, u = sol.xs[t], sol.us[t]
        _, cache = m._dynamics(x, u)
        for c in m.costs.items:
            if isinstance(c, CostContactCoP) and float(c.active) > 0:
                worst = min(worst, float(c.residual(m.state, cache, x,
                                                    u).min()))
    return worst


def taichi_problem(torch, T_phase=15, dt=2e-2):
    """examples/humanoid_taichi.py:30-98 from the port's modules: the
    humanoid shifts its CoM over the right sole in double support, then
    balances on it while the left gripper reaches two targets; 6D sole
    contacts with gains (0, 50) at the standing placements.  Float64 on
    the CPU; T = 3·T_phase."""
    from crocoddyl_tpu_torch import (CostFramePlacement, CostStack,
                                     RigidBodyNode, ShootingProblem,
                                     stack_models)
    from crocoddyl_tpu_torch.dynamics import algorithms as algo
    from crocoddyl_tpu_torch.dynamics import robots
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad, ActivationWeightedQuad)
    from crocoddyl_tpu_torch.models.multibody.actuations import (
        FloatingBaseActuation)
    from crocoddyl_tpu_torch.models.multibody.contacts import (Contact6D,
                                                               ContactSet)
    from crocoddyl_tpu_torch.models.multibody.costs import (CostCoM,
                                                            CostControl,
                                                            CostState)
    f64 = torch.float64
    m = robots.humanoid()
    st = StateMultibody(model=m)
    q0 = robots.humanoid_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=f64)])
    gid = m.frame_id("left_gripper")
    oMi, _ = algo.forward_kinematics(m, q0)
    place = {f: algo.frame_placement(m, oMi, m.frame_id(f)) for f in SOLES}
    com_ref = place["right_sole"].p.clone()
    com_ref[2] = algo.center_of_mass(m, q0)[2]
    sw = np.full(2 * m.nv, 0.01)
    sw[:6] = 10.0
    sw[m.nv:] = 1.0
    targets = ([0.4, 0.1, 0.9], [0.3, 0.3, 1.2], [0.5, 0.0, 1.1])

    def w(v):
        return torch.tensor(v, dtype=f64)

    def node(target, w_goal, support, dt_):
        contacts = tuple(Contact6D(
            fid=m.frame_id(f), ref_R=place[f].R, ref_p=place[f].p,
            gains=w([0.0, 50.0]), active=w(1.0 if f in support else 0.0))
            for f in SOLES)
        costs = CostStack(items=(
            CostFramePlacement(fid=gid, ref_R=torch.eye(3, dtype=f64),
                               ref_p=w(target), activation=ActivationQuad(),
                               weight=w(w_goal), active=w(1.0)),
            CostCoM(cref=com_ref, activation=ActivationQuad(),
                    weight=w(1e4), active=w(1.0)),
            CostState(xref=x0, activation=ActivationWeightedQuad(
                weights=w(sw)), weight=w(1e1), active=w(1.0)),
            CostControl(uref=torch.zeros(m.nv - 6, dtype=f64),
                        activation=ActivationQuad(), weight=w(1e-3),
                        active=w(1.0))))
        return RigidBodyNode(state_=st,
                             actuation=FloatingBaseActuation(nv=m.nv),
                             costs=costs, contacts=ContactSet(contacts),
                             dt=w(dt_))

    right = ("right_sole",)
    models = ([node(targets[0], 1e1, SOLES, dt) for _ in range(T_phase)]
              + [node(targets[1], 1e2, right, dt) for _ in range(T_phase)]
              + [node(targets[2], 1e2, right, dt) for _ in range(T_phase)])
    return ShootingProblem(x0=x0, running=stack_models(models),
                           terminal=node(targets[2], 1e4, right, 0.0))


def quadrotor_problem(torch, T=33, dt=3e-2, target=(0.0, 0.0, 1.0),
                      ubound=False):
    """examples/quadrotor.py:32-72 from the port's modules: the quadrotor
    flies from rest to a base placement at ``target``; four rotors through
    ``MultiCopterBaseActuation``, squashed into [0.1, 5] by
    ``SmoothSatSquashing`` with ``ubound``.  Float64 on the CPU."""
    from crocoddyl_tpu_torch import (CostFramePlacement, CostStack,
                                     RigidBodyNode, ShootingProblem,
                                     stack_models)
    from crocoddyl_tpu_torch.dynamics import robots
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad, ActivationWeightedQuad)
    from crocoddyl_tpu_torch.models.multibody.actuations import (
        MultiCopterBaseActuation, SmoothSatSquashing, SquashingActuation)
    from crocoddyl_tpu_torch.models.multibody.costs import (CostControl,
                                                            CostState)
    f64 = torch.float64
    m = robots.quadrotor()
    st = StateMultibody(model=m)
    x0 = torch.cat([m.neutral(), torch.zeros(m.nv, dtype=f64)])
    act = MultiCopterBaseActuation(nv=m.nv, tau_f=robots.quadrotor_tau_f())
    if ubound:
        act = SquashingActuation(nv=m.nv, actuation=act,
                                 squashing=SmoothSatSquashing(
                                     s_lb=torch.full((4,), 0.1, dtype=f64),
                                     s_ub=torch.full((4,), 5.0, dtype=f64),
                                     smooth=torch.tensor(0.1, dtype=f64)))

    def w(v):
        return torch.tensor(v, dtype=f64)

    def node(w_goal, dt_):
        costs = CostStack(items=(
            CostFramePlacement(fid=m.frame_id("base_link"),
                               ref_R=torch.eye(3, dtype=f64),
                               ref_p=w(target), activation=ActivationQuad(),
                               weight=w(w_goal), active=w(1.0)),
            CostState(xref=x0, activation=ActivationWeightedQuad(
                weights=w([0.1] * 3 + [1000.0] * 3 + [1000.0] * m.nv)),
                weight=w(1e-6), active=w(1.0)),
            CostControl(uref=torch.zeros(act.nu, dtype=f64),
                        activation=ActivationQuad(), weight=w(1e-6),
                        active=w(1.0))))
        return RigidBodyNode(state_=st, actuation=act, costs=costs,
                             dt=w(dt_))

    return ShootingProblem(x0=x0, running=stack_models([node(1e-3, dt)] * T),
                           terminal=node(3.0, 0.0))


# tests/golden.json records of phase 11 whose iteration count is not
# rounding-stable: the JAX package's own solve, from x0 and from x0 moved
# by 1e-15 to 1e-11, takes 42 to 57 iterations to the golden's cost (35 in
# the record), within 2.5e-11 (golden_sensitivity.py).  Its first iteration
# on the card is held to the CPU's, ``converged`` and the cost (rtol 1e-5)
# to the record, and the bar of the iterations is printed.
ZOO_UNSTABLE = ("bipedal_walk_cop_fast",)


def zoo_helpers(torch, ck, dev, launches):
    """(zoo_solve, card_vs_cpu): phase 11's solves on the card, each one's
    launches kept in ``launches`` under its name."""
    from crocoddyl_tpu_torch import solve
    f64 = torch.float64

    def zoo_solve(name, prob, st, xs, us, dt=f64):
        """One solve on the card with every count zeroed first: (problem
        on the card, solution, seconds); no kernel and no plain version
        may run."""
        p = to_dev(torch, prob, dev, dt)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = solve(p, None if xs is None else xs.to(dev, dt),
                    None if us is None else us.to(dev, dt), st, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = all_launches(ck)
        need(not any(launches[name].values()),
             f"{name}: kernels launched {launches[name]}")
        need(not any(plain_calls()), f"{name}: plain versions ran")
        need(bool(torch.isfinite(sol.cost)), f"{name}: non-finite cost")
        return p, sol, secs

    def card_vs_cpu(tag, p, prob, xs, us, st):
        """The same solve on the card and on the CPU in float64: the same
        decisions, cost rtol 1e-10 or SENS_FACTOR times the card's own
        cost change under a DERIV_EPS change of its node derivatives
        (``cost_tol``), whichever is larger."""
        def run():
            return solve(p, None if xs is None else xs.to(dev),
                         None if us is None else us.to(dev), st, device=dev)
        k = run()
        c = solve(prob, xs, us, st, device="cpu")
        same(tag, k, c, ("iter", "steplength", "xreg", "is_feasible"))
        rc = float((k.cost.cpu() - c.cost).abs() / c.cost.abs())
        tol, sens = cost_tol(torch, run, k.cost, floor=1e-10)
        log(f"[zoo] f64 {tag}: iter {int(k.iter)}, steplength "
            f"{float(k.steplength)}, xreg {float(k.xreg):.1e}, feasible "
            f"{bool(k.is_feasible)} on the card and the CPU, cost rtol "
            f"{rc:.3e} (tol {tol:.1e}; the card's cost moves {sens:.3e} "
            f"under a {DERIV_EPS:.0e} change of its node derivatives)")
        need(rc <= tol, f"{tag}: cost rtol {rc:.3e}")
    return zoo_solve, card_vs_cpu


def run_zoo(torch, ck, dev, card):
    """Phase 11 (a) (see the module docstring): the CoP walk's replans.
    Returns {case: {wrapper: launches}}."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    f32 = torch.float32
    launches = {}
    zoo_solve, card_vs_cpu = zoo_helpers(torch, ck, dev, launches)

    # -- (a) the thesis's CoP walk at the example's size, T=60 --------------
    walk, xs0, us0 = cop_walk_problem(torch)
    need(walk.T == 60 and not walk.on_lanes, f"CoP walk T={walk.T}")
    one = SolverSettings(maxiter=1)
    p32, s32, _ = zoo_solve("cop_walk_replan", walk, one, xs0, us0, f32)

    def replan():
        return solve(p32, xs0.to(dev, f32), us0.to(dev, f32), one,
                     device=dev)
    # one timed run, not the median of 3: the script's time limit
    wall, split = host_split(torch, replan)
    rest = wall - sum(split.values())
    log(f"[zoo] time f32 CoP walk T={walk.T} cold replan (FDDP maxiter=1 "
        f"from the quasi-static controls): {wall:.2f} ms (one run), cost "
        f"{float(s32.cost):.6e}, steplength {float(s32.steplength)}, "
        f"launches {launches['cop_walk_replan']}; host clock between "
        f"syncs: wall {wall:.1f} ms = calc_diff {split['_calc_diff']:.1f} "
        f"+ backward passes {split['_backward_pass']:.1f} + trial rollouts "
        f"{split['_forward_pass']:.1f} + rest {rest:.1f}  ({card})")
    p64, _, _ = zoo_solve("cop_walk_replan_f64", walk, one, xs0, us0)
    card_vs_cpu(f"CoP walk T={walk.T} replan", p64, walk, xs0, us0, one)
    return launches


def zoo_anchors(torch, ck, dev, card):
    """Phase 11 (b) (see the module docstring): the goldens and the CoP
    walk of tests/test_gaits.py.  Returns {anchor: {wrapper: launches}}."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.apps import rh5
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)
    launches = {}
    zoo_solve, card_vs_cpu = zoo_helpers(torch, ck, dev, launches)
    walk = cop_walk_problem(torch)[0]

    # -- (b) the goldens --------------------------------------------------
    def warm(prob):
        xs = prob.x0[None].expand(prob.T + 1, -1).clone()
        return prob, xs, prob.quasi_static(xs)
    cases = {
        "bipedal_walk_cop_fast": (cop_walk_problem(torch, 6, 3),
                                  SolverSettings(maxiter=150)),
        "humanoid_taichi_fast": (warm(taichi_problem(torch, T_phase=4)),
                                 SolverSettings(maxiter=40)),
        "quadrotor": ((quadrotor_problem(torch), None, None),
                      SolverSettings(maxiter=200)),
        "quadrotor_ubound": ((quadrotor_problem(torch, ubound=True), None,
                              None), SolverSettings(maxiter=200))}
    for name, ((prob, xs, us), st) in cases.items():
        p, sol, secs = zoo_solve(name, prob, st, xs, us)
        g = golden[name]
        rc = abs(float(sol.cost) - g["cost"]) / abs(g["cost"])
        ok = (bool(sol.converged) == g["converged"]
              and abs(int(sol.iter) - g["iters"]) <= 1 and rc <= 1e-5)
        log(f"[zoo] f64 {name} T={p.T} on the card: converged "
            f"{bool(sol.converged)} in {int(sol.iter)} iterations, cost "
            f"{float(sol.cost)!r}; golden {g['converged']}, {g['iters']}, "
            f"{g['cost']!r}: cost rtol {rc:.3e}, bar of "
            f"tests/test_examples_golden.py {'met' if ok else 'not met'}"
            f"{' (printed, not held)' if name in ZOO_UNSTABLE else ''}; "
            f"{secs:.1f} s; launches {launches[name]}  ({card})")
        if name in ZOO_UNSTABLE:
            card_vs_cpu(f"{name} first iteration", p, prob, xs, us,
                        SolverSettings(maxiter=1))
            need(bool(sol.converged) == g["converged"] and rc <= 1e-5,
                 f"golden {name}: converged or cost")
        else:
            need(ok, f"golden {name}")
        if name == "bipedal_walk_cop_fast":
            worst = cop_in_support(p, sol)
            cops = rh5.calc_cops(p, sol)
            zmps = rh5.calc_zmps(p, sol)
            path = rh5.log_solution_csv(p, sol, os.path.join(
                OUT, f"{name}.csv"))
            with open(path) as f:
                rows = sum(1 for _ in f)
            cop_xy = np.stack([r["cop"][:2] for r in cops])
            # printed, not held: at these 0.6 m steps the CoP leaves its
            # box in the JAX package's solve as well (PERF.md, PR 8); the
            # bar is held on the walk of tests/test_gaits.py below
            log(f"[zoo] {name}: worst CoP-barrier residual {worst:.3e} "
                f"(printed, not held); calc_cops {len(cops)} "
                f"(knot, foot) pairs, |CoP| <= {np.abs(cop_xy).max():.4f} m; "
                f"calc_zmps (T, 3) = {zmps.shape}, |ZMP_xy| <= "
                f"{np.abs(zmps[:, :2]).max():.4f} m; log_solution_csv "
                f"{rows} rows ({path})")
            need(len(cops) > 0 and np.isfinite(cop_xy).all()
                 and zmps.shape == (p.T, 3) and np.isfinite(zmps).all()
                 and rows == p.T + 1, f"{name}: RH5 analysis")
    # the CoP check of tests/test_gaits.py:121-150: 0.3 m steps, 0.05 m high
    m = walk.state.model
    q0 = walk.x0[:m.nq]
    short = cop_factory()(m, SOLES, default_q=q0).walking_problem(
        walk.x0, 0.3, 0.05, 0.03, step_knots=6, support_knots=3)
    short, xs, us = warm(short)
    p, sol, secs = zoo_solve("cop_walk_short", short, SolverSettings(
        maxiter=150, record_trace=False), xs, us)
    worst = cop_in_support(p, sol)
    log(f"[zoo] f64 CoP walk of tests/test_gaits.py:121-150 T={p.T}: "
        f"converged {bool(sol.converged)} in {int(sol.iter)} iterations, "
        f"cost {float(sol.cost):.6e}, worst CoP-barrier residual "
        f"{worst:.3e} (bar > -0.5); {secs:.1f} s")
    need(bool(sol.converged) and worst > -0.5, "CoP inside the support")
    return launches


# ---------------------------------------------------------------------------
# Phase 12: segmented problems and the true impulse switch knot
# ---------------------------------------------------------------------------

SEG_TICKS = 1       # 10, 4, 2 until phases 13, 14, 15: the time limit
SEG_F64_TICKS = 1   # 2 until phase 14's float64 node kinds
SEG_MAXITER = 60     # tests/test_gaits.py:113-116


def impulse_walk_small(torch):
    """The true-impulse walk of tests/test_gaits.py:104-118 on the
    programmatic quadruped: 8 segments, T=22; (problem, xs0, us0) from the
    quasi-static warm start, float64 on the CPU."""
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    prob = QuadrupedGaitFactory(m, FEET, default_q=q0).walking_problem(
        x0, 0.1, 0.05, 1e-2, step_knots=4, support_knots=1,
        pseudo_impulse=False)
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    return prob, xs0, prob.quasi_static(xs0)


def segment_kinds(prob):
    """(segment type names, knots of each kind)."""
    kinds = [type(s).__name__ for s in prob.segments]
    knots = {}
    for k, n in zip(kinds, prob.seg_lengths):
        knots[k] = knots.get(k, 0) + n
    return kinds, knots


def run_segments(torch, ck, dev, card, walk64, walk_ms):
    """Phase 12 (see the module docstring).  ``walk64``: the one-segment
    T=108 walk (float64, on the card); ``walk_ms``: its quasi-static warm
    start (xs0, us0).  Returns {anchor: {wrapper: launches}}."""
    from crocoddyl_tpu_torch import (SolverSettings, replicate_model,
                                     rotate_segmented, shift_warm_start,
                                     solve)
    from crocoddyl_tpu_torch.core.problem import ShootingProblem
    from crocoddyl_tpu_torch.core.solvers import fddp as tfddp
    from crocoddyl_tpu_torch.core.solvers import kkt
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    from crocoddyl_tpu_torch.utils.numdiff import numdiff_fxlx
    from crocoddyl_tpu_torch.utils.struct import tree_map
    f32, f64 = torch.float32, torch.float64
    one = SolverSettings(maxiter=1)
    launches = {}

    def counted(name, fn):
        """``fn()`` with every count zeroed just before and read just
        after; no plain version may run."""
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[name] = all_launches(ck)
        need(not any(plain_calls()), f"{name}: plain versions ran")
        return out

    def kernel_vs_plain(tag, run, floor=1e-8):
        """``run()`` (float64) on the kernel path and on the plain path:
        the same decisions, cost within ``floor`` or, above it, within
        ``cost_tol`` (the plain path's sensitivity is measured only then:
        below the floor the bar holds whatever it is)."""
        k = run()
        with plain_path():
            r = run()
        same(tag, k, r, ("iter", "steplength", "is_feasible", "xreg"))
        rc = float((k.cost - r.cost).abs() / r.cost.abs())
        tol, note = floor, "not measured: within the floor"
        if rc > floor:
            tol, sens = cost_tol(torch, run, r.cost, floor=floor)
            note = (f"the plain path's cost moves {sens:.3e} under a "
                    f"{DERIV_EPS:.0e} change of its node derivatives")
        log(f"[seg] f64 {tag} kernel vs plain: iter {int(k.iter)}, "
            f"steplength {float(k.steplength)}, xreg {float(k.xreg):.1e}, "
            f"feasible {bool(k.is_feasible)} in both, cost rtol {rc:.3e} "
            f"(tol {tol:.1e}; {note})")
        need(rc <= tol, f"{tag}: cost rtol {rc:.3e}")
        return k

    def card_vs_cpu(tag, prob, xs, us, st, rtol):
        """The same float64 solve on the card and on the CPU: the same
        decisions and convergence, cost within ``rtol``."""
        k = solve(prob, None if xs is None else xs.to(dev),
                  None if us is None else us.to(dev), st, device=dev)
        c = solve(prob, xs, us, st, device="cpu")
        same(tag, k, c, ("iter", "steplength", "is_feasible", "converged"))
        rc = float((k.cost.cpu() - c.cost).abs() / c.cost.abs())
        log(f"[seg] f64 {tag} on the card: converged {bool(k.converged)} "
            f"in {int(k.iter)} iterations, cost {float(k.cost)!r}, rtol "
            f"{rc:.3e} to the CPU (bar {rtol:.0e})")
        need(rc <= rtol, f"{tag}: cost rtol {rc:.3e}")
        return k, c

    # -- (a) the true-impulse ANYmal walk at bench size ---------------------
    walk, xs0, us0 = build_walk(torch, 25, 2, pseudo_impulse=False)
    kinds, knots = segment_kinds(walk)
    log(f"[seg] true-impulse ANYmal walk: T={walk.T}, {len(kinds)} "
        f"segments {walk.seg_lengths}, knots {knots}, groups "
        f"{walk._seg_groups}, terminal {type(walk.terminal).__name__}")
    need(walk.T == 108 and len(kinds) == 8 and knots == {
        "RigidBodyNode": 104, "ImpulseNode": 4}, "true-impulse walk shape")
    p32 = to_dev(torch, walk, dev, f32)

    def replan32():
        return solve(p32, xs0.to(dev, f32), us0.to(dev, f32), one,
                     device=dev)
    # one run, counted and on the host clock to a device sync (not the
    # median of 3): the script's time limit
    out = []
    wall, split = host_split(torch, lambda: out.append(
        counted("seg_walk_replan", replan32)))
    s32 = out[0]
    got = launches["seg_walk_replan"]
    need(got["node_calc_both"] > 0 and not any(
        v for n, v in got.items() if n != "node_calc_both"),
        f"true-impulse walk: launches {got}")
    need(bool(torch.isfinite(s32.cost)), "true-impulse walk: cost")
    rest = wall - sum(split.values())
    log(f"[seg] time f32 true-impulse walk T={walk.T} cold replan "
        f"(SolverSettings(maxiter=1) from the quasi-static controls): "
        f"{wall:.2f} ms (one run), cost {float(s32.cost):.6e}, steplength "
        f"{float(s32.steplength)}, launches {got}; host clock between syncs:"
        f" wall {wall:.1f} ms = linearization (kernel 1 on the 104 rigid "
        f"knots, the impulse knots and terminal) {split['_calc_diff']:.1f} "
        f"+ backward passes {split['_backward_pass']:.1f} + trial rollouts "
        f"{split['_forward_pass']:.1f} + rest {rest:.1f}  ({card})")
    p64 = to_dev(torch, walk, dev, f64)
    kernel_vs_plain(f"true-impulse walk T={walk.T} replan", lambda: solve(
        p64, xs0.to(dev), us0.to(dev), one, device=dev))

    # -- (b) the reduced true-impulse walk, solved --------------------------
    small, xs_s, us_s = impulse_walk_small(torch)
    need(small.T == 22 and len(small.segments) == 8, "reduced walk shape")
    full = SolverSettings(maxiter=SEG_MAXITER, record_trace=False)
    t0 = time.perf_counter()
    k, c = card_vs_cpu(f"reduced true-impulse walk T={small.T} "
                       f"(maxiter={SEG_MAXITER})", small, xs_s, us_s, full,
                       1e-8)
    need(bool(k.converged), "reduced true-impulse walk: not converged")
    log(f"[seg] reduced walk solve on the card and the CPU: "
        f"{time.perf_counter() - t0:.1f} s")

    # -- (c) the true-impulse CoP walk (examples/bipedal_walk_cop.py
    # --impulse) at phase 11's knots ------------------------------------
    cop, cxs, cus = cop_walk_problem(torch, pseudo_impulse=False)
    kinds, knots = segment_kinds(cop)
    need(cop.T == 60 and "ImpulseNode" in kinds, "true-impulse CoP walk")
    c32 = to_dev(torch, cop, dev, f32)

    def cop32():
        return solve(c32, cxs.to(dev, f32), cus.to(dev, f32), one,
                     device=dev)
    sc = counted("seg_cop_replan", cop32)
    need(not any(launches["seg_cop_replan"].values()),
         f"CoP walk: kernels launched {launches['seg_cop_replan']}")
    need(bool(torch.isfinite(sc.cost)), "true-impulse CoP walk: cost")
    cms = cuda_time(torch, cop32, runs=1, warmup=False)
    log(f"[seg] time f32 true-impulse CoP walk T={cop.T} ({len(kinds)} "
        f"segments, knots {knots}) cold replan: {cms:.2f} ms (one run), "
        f"cost {float(sc.cost):.6e}, steplength {float(sc.steplength)}  "
        f"({card})")
    c64 = to_dev(torch, cop, dev, f64)

    def cop64():
        return solve(c64, cxs.to(dev), cus.to(dev), one, device=dev)
    kc = cop64()
    cc = solve(cop, cxs, cus, one, device="cpu")
    same("true-impulse CoP walk replan", kc, cc,
         ("iter", "steplength", "xreg", "is_feasible"))
    rc = float((kc.cost.cpu() - cc.cost).abs() / cc.cost.abs())
    tol, sens = cost_tol(torch, cop64, kc.cost, floor=1e-10)
    log(f"[seg] f64 true-impulse CoP walk replan: steplength "
        f"{float(kc.steplength)} on the card and the CPU, cost rtol {rc:.3e} "
        f"(tol {tol:.1e}; the card's cost moves {sens:.3e} under a "
        f"{DERIV_EPS:.0e} change of its node derivatives)")
    need(rc <= tol, f"true-impulse CoP walk: cost rtol {rc:.3e}")

    # -- (d) MPC on the reduced segmented walk -------------------------------
    tick_st = SolverSettings(maxiter=1, parallel_linesearch=False,
                             record_trace=False)

    def plant(p, us):
        return tree_map(lambda l: l[0], p.segments[0]).calc(p.x0, us[0])[0]

    def tick(p, xs, us, x_next):
        p = rotate_segmented(p, new_x0=x_next)
        xs, us = shift_warm_start(xs, us, x_next)
        return p, solve(p, xs, us, tick_st, device=dev)

    p = to_dev(torch, small, dev, f32)
    xs, us = k.xs.to(f32), k.us.to(f32)
    reset_counts()
    lat = []
    for _ in range(SEG_TICKS):
        x_next = plant(p, us)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s = tick(p, xs, us, x_next)
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        need(not bool(s.diverged) and bool(torch.isfinite(s.cost)),
             f"segmented MPC tick {len(lat)} diverged")
        xs, us = s.xs, s.us
    launches["seg_mpc_tick"] = {n: v / SEG_TICKS
                                for n, v in all_launches(ck).items()}
    need(not any(plain_calls()), "segmented MPC: plain versions ran")
    # one tick is one sample: its time, not percentiles
    lat_txt = (f"{lat[0]:.2f} ms" if len(lat) == 1 else
               f"p50 {np.percentile(lat, 50):.2f} ms, p90 "
               f"{np.percentile(lat, 90):.2f} ms")
    log(f"[seg] f32 MPC on the reduced true-impulse walk, {SEG_TICKS} "
        f"tick(s) of rotate_segmented + shift_warm_start + replan: "
        f"{lat_txt}; segments after the last tick {p.seg_lengths}; launches "
        f"per tick {launches['seg_mpc_tick']}  ({card})")

    def ticks64():
        p, xs, us, rows = to_dev(torch, small, dev, f64), k.xs, k.us, []
        for _ in range(SEG_F64_TICKS):
            p, s = tick(p, xs, us, plant(p, us))
            rows.append(s)
            xs, us = s.xs, s.us
        return rows
    k_rows = ticks64()
    with plain_path():
        p_rows = ticks64()
    for i, (a, b) in enumerate(zip(k_rows, p_rows)):
        same(f"segmented MPC f64 tick {i}", a, b,
             ("iter", "steplength", "is_feasible", "diverged"))
        rc = float((a.cost - b.cost).abs() / b.cost.abs())
        log(f"[seg] f64 MPC tick {i} kernel vs plain: steplength "
            f"{float(a.steplength)} in both, cost rtol {rc:.3e}")
        need(rc <= 1e-8, f"segmented MPC f64 tick {i}")

    # -- (e) the other settings ------------------------------------------
    um = UnicycleModel()
    for tag, st, T_u, bar in (
            ("ms_chunk=8", SolverSettings(maxiter=60, record_trace=False,
                                          ms_chunk=8, th_stop=1e-3,
                                          th_gaptol=1e-4), 40, 1e-8),
            ("parallel_riccati", SolverSettings(
                maxiter=50, record_trace=False, parallel_riccati=True), 20,
             1e-9)):
        m = um if T_u == 20 else UnicycleModel(
            dt=torch.tensor(0.1, dtype=f64),
            cost_weights=torch.tensor([10.0, 1.0], dtype=f64))
        uni = ShootingProblem(x0=torch.tensor([-1.0, -1.0, 1.0], dtype=f64),
                              running=replicate_model(m, T_u), terminal=m)
        kk, _ = card_vs_cpu(f"unicycle T={T_u} {tag}", uni, None, None, st,
                            bar)
        need(bool(kk.converged), f"unicycle {tag}: not converged")
        if tag == "parallel_riccati":
            need(int(kk.iter) == 9 and abs(float(kk.cost) - 249.56089793082)
                 < 1e-6, f"unicycle anchor: {float(kk.cost)!r}")
    walk_xs, walk_us = walk_ms
    w32 = to_dev(torch, walk64, dev, f32)
    others = {
        "ms_chunk=12": SolverSettings(maxiter=1, ms_chunk=12),
        "fused_scans+parallel_riccati": SolverSettings(
            maxiter=1, fused_scans=True, parallel_riccati=True)}
    for tag, st in others.items():
        def run(p=w32, dt=f32, st=st):
            return solve(p, walk_xs.to(dev, dt), walk_us.to(dev, dt), st,
                         device=dev)
        out = []
        wall, split = host_split(torch, lambda: out.append(
            counted(f"walk_{tag}", run)))
        so, got = out[0], launches[f"walk_{tag}"]
        if tag.startswith("ms"):
            need(got["node_calc_both"] > 0 and got["riccati_backward_b1"] == 0
                 and got["trial_rollout_b1"] == 0, f"{tag}: launches {got}")
        else:
            need(got["node_calc_both"] > 0 and got["trial_rollout_b1"] > 0
                 and got["riccati_backward_b1"] == 0,
                 f"{tag}: launches {got}")
        need(bool(torch.isfinite(so.cost)), f"{tag}: cost")
        log(f"[seg] time f32 one-segment walk T={walk64.T} replan "
            f"SolverSettings({tag}, maxiter=1): {wall:.2f} ms (one run; "
            f"linearization {split['_calc_diff']:.1f}, backward passes "
            f"{split['_backward_pass'] + split['backward_pass_parallel']:.1f}"
            f", trial rollouts {split['_forward_pass'] + split['_forward_pass_ms']:.1f}), "
            f"cost {float(so.cost):.6e}, steplength {float(so.steplength)}, "
            f"launches {got}  ({card})")
        kernel_vs_plain(f"one-segment walk {tag} replan",
                        lambda st=st: solve(walk64, walk_xs.to(dev),
                                            walk_us.to(dev), st, device=dev))

    # -- (f) the oracles on the card --------------------------------------
    s64 = to_dev(torch, small, dev, f64)
    i = next(i for (i, _), n in zip(s64._seg_slices(), s64.segments)
             if type(n).__name__ == "ImpulseNode")
    seg = next(n for n in s64.segments if type(n).__name__ == "ImpulseNode")
    node = tree_map(lambda l: l[0], seg)
    # a perturbed state near the knot's solution (tests/test_torch_segments
    # .py's points): at the solution itself the residuals nearly vanish,
    # and a forward difference's error (h·Lxx, weights up to 1e7) is not
    # small against Lx
    rng = np.random.default_rng(3)
    x = k.xs[i] + torch.tensor(0.01 * rng.standard_normal(k.xs.shape[1]),
                               dtype=f64, device=dev)
    x[3:7] = x[3:7] / torch.linalg.norm(x[3:7])
    u = k.us[i]
    d = node.calc_diff(x, u)
    worst = 0.0
    for name, fd in zip(("Fx", "Fu", "Lx", "Lu"), numdiff_fxlx(node, x, u)):
        err = float((getattr(d, name) - fd).abs().max()
                    / (1 + fd.abs().max()))
        worst = max(worst, err)
    log(f"[seg] f64 ImpulseNode (knot {i}, near the solution) derivatives "
        f"against numdiff_fxlx on the card: {worst:.3e} of 1 + max-abs (bar "
        f"5e-5)")
    need(worst < 5e-5, "ImpulseNode against numdiff")
    xs_k = s64.x0[None].repeat(s64.T + 1, 1)
    rng = np.random.default_rng(21)
    xs_k[1:, s64.state.nq:] += torch.tensor(
        0.01 * rng.standard_normal((s64.T, s64.state.nv)), dtype=f64,
        device=dev)
    us_k = us_s.to(dev)
    dxs, dus = kkt.newton_step(s64, xs_k, us_k, ureg=1e-9)[:2]
    derivs, dterm, fs, _ = tfddp._calc_diff(s64, xs_k, us_k, False)
    res = tfddp._backward_pass(derivs, dterm, fs, 0.0, 1e-9)
    kv, Kv, failed = res[3], res[4], res[-1]
    need(not bool(failed), "KKT check: the Riccati pass failed")
    dx, err = fs[0], 0.0
    for t in range(s64.T):
        du = -kv[t] - Kv[t] @ dx
        err = max(err, float((dus[t] - du).abs().max() / dus.abs().max()))
        dx = derivs.Fx[t] @ dx + derivs.Fu[t] @ du + fs[t + 1]
        err = max(err, float((dxs[t + 1] - dx).abs().max()
                             / dxs.abs().max()))
    log(f"[seg] f64 one dense KKT step on the reduced true-impulse walk "
        f"(8 segments) on the card against the Riccati step (no state "
        f"regularization, ureg 1e-9 in both): {err:.3e} of the steps' "
        f"max-abs (bar 1e-6)")
    need(err < 1e-6, "KKT step against the Riccati step")
    return launches


# ---------------------------------------------------------------------------
# Phase 13: the fleet (parallel/mesh.py), display and aot
# ---------------------------------------------------------------------------

FLEET_RANKS = 2
DECISIONS = ("iter", "steplength", "is_feasible", "converged", "diverged")


def fleet_rank(rank, x0s, xs0, us0):
    """One rank of phase 13's split (spawned by ``parallel.spawn``): the
    T=108 walk built anew, this rank's slice of ``x0s`` through
    ``solve_batch(maxiter=1)`` in float64 (launch counts zeroed before,
    read after; the gathered batch and the fleet metrics), then in
    float32 once untimed and once timed between two barriers of the
    ranks."""
    import torch
    import torch.distributed as tdist
    from crocoddyl_tpu_torch import SolverSettings, solve_batch
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.parallel import mesh as pmesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    mesh = pmesh.data_mesh(FLEET_RANKS)
    dev = mesh.device
    prob = build_walk(torch, 25, 2)[0]
    settings = SolverSettings(maxiter=1, record_trace=False,
                              parallel_linesearch=False)
    out = {"rank": mesh.rank, "backend": mesh.backend, "device": str(dev),
           "slice": pmesh.host_local_batch(len(x0s))}
    for dt in (torch.float64, torch.float32):
        p = to_dev(torch, prob, dev, dt)
        run = pmesh.sharded_solve_x0(
            lambda p_, xs: solve_batch(
                p_, xs, xs_init=torch.as_tensor(xs0).to(dev, dt),
                us_init=torch.as_tensor(us0).to(dev, dt), settings=settings,
                device=dev), p, mesh, batched=True)
        x0s_t = torch.tensor(x0s, dtype=dt)
        if dt == torch.float64:
            reset_counts()
            sol = run(x0s_t)
            torch.cuda.synchronize()
            out["launches"] = all_launches(ck)
            out["plain_calls"] = plain_calls()
            whole = pmesh.gather(sol, mesh)
            out["f64"] = {f: getattr(whole, f) for f in ("cost",)
                          + DECISIONS}
            out["metrics"] = pmesh.fleet_metrics(sol, mesh)
        else:
            run(x0s_t)
            torch.cuda.synchronize()
            tdist.barrier()
            t0 = time.perf_counter()
            sol = run(x0s_t)
            torch.cuda.synchronize()
            tdist.barrier()
            out["f32_ms"] = (time.perf_counter() - t0) * 1e3
            out["f32_finite"] = bool(torch.isfinite(sol.cost).all())
    return out


class count_builds:
    """Within the block, count kernel-library compiles and kernel
    descriptors built."""

    def __init__(self, ck):
        self.ck, self.n = ck, {"compile": 0, "descriptor": 0}

    def __enter__(self):
        ck, n = self.ck, self.n
        self.saved = ck._compile, ck._Descriptor

        def compile_(*a):
            n["compile"] += 1
            return self.saved[0](*a)

        def descriptor_(*a):
            n["descriptor"] += 1
            return self.saved[1](*a)
        ck._compile, ck._Descriptor = compile_, descriptor_
        return self.n

    def __exit__(self, *exc):
        self.ck._compile, self.ck._Descriptor = self.saved


def run_fleet(torch, ck, dev, card, prob, x0s, xs0, us0, batch64):
    """Phase 13 (see the module docstring).  ``prob``: the T=108 walk
    (float64, CPU); ``x0s``, ``xs0``, ``us0``: phase 4's B=256 initial
    states and warm start; ``batch64``: phase 4's one-process float64
    ``solve_batch`` through the kernels.  Returns {anchor: {wrapper:
    launches}}."""
    import tempfile

    from crocoddyl_tpu_torch import SolverSettings, solve_batch
    from crocoddyl_tpu_torch.io.display import export_html, skeleton
    from crocoddyl_tpu_torch.parallel import (dryrun_multichip,
                                              fleet_metrics, spawn)
    from crocoddyl_tpu_torch.utils import aot
    f32, f64 = torch.float32, torch.float64
    launches = {}
    n_cards = torch.cuda.device_count()

    # -- (1) the B=256 walk over two ranks, float64, against one process --
    t0 = time.perf_counter()
    reports = spawn(fleet_rank, FLEET_RANKS,
                    args=(x0s, xs0.numpy(), us0.numpy()), timeout=400)
    spawn_s = time.perf_counter() - t0
    want = {f: getattr(batch64, f).cpu().numpy() for f in ("cost",)
            + DECISIONS}
    want_m = {k: float(v) for k, v in fleet_metrics(batch64).items()}
    for r in reports:
        tag = f"rank {r['rank']} of {FLEET_RANKS}"
        launches[f"fleet_rank{r['rank']}"] = r["launches"]
        log(f"[fleet] {tag}: {r['backend']} on {r['device']}, problems "
            f"{r['slice'][0]}..{sum(r['slice']) - 1}, f64 launches "
            f"{r['launches']}, plain calls {r['plain_calls']}")
        if n_cards == 1:
            need(r["backend"] == "gloo" and r["device"] == "cuda:0",
                 f"{tag}: {r['backend']} on {r['device']}")
        need(all(r["launches"][WRAPPER[k]] > 0
                 for k in ("node", "riccati", "rollout")),
             f"{tag}: kernels 1-3 not all launched {r['launches']}")
        need(not any(r["plain_calls"]), f"{tag}: plain versions ran")
        got = r["f64"]
        need(got["cost"].shape == (B_BENCH,), f"{tag}: gathered costs of "
             f"shape {got['cost'].shape}")
        for f in DECISIONS:
            need(np.array_equal(got[f], want[f]),
                 f"{tag}: {f} differs from the one-process solve")
        rc = float(np.max(np.abs(got["cost"] - want["cost"])
                          / np.abs(want["cost"])))
        m = r["metrics"]
        rm = abs(float(m["mean_cost"]) - want_m["mean_cost"]) / abs(
            want_m["mean_cost"])
        log(f"[fleet] {tag}: the gathered f64 B={B_BENCH} split makes the "
            f"one-process solve's decisions ({', '.join(DECISIONS)}), cost "
            f"rtol {rc:.3e}; fleet metrics {m}, mean cost rtol {rm:.3e} to "
            f"the one process's")
        need(rc <= 1e-12, f"{tag}: cost rtol {rc:.3e}")
        need(rm <= 1e-14, f"{tag}: fleet mean cost rtol {rm:.3e}")
        for k in ("mean_iters", "converged_frac", "diverged_frac"):
            need(float(m[k]) == want_m[k], f"{tag}: fleet {k} {m[k]} vs "
                 f"{want_m[k]}")
        need(r["f32_finite"], f"{tag}: non-finite f32 cost")

    # -- (2) the float32 split timed once, and the one-process step ------
    p32 = to_dev(torch, prob, dev, f32)
    settings = SolverSettings(maxiter=1, record_trace=False,
                              parallel_linesearch=False)

    def step():
        return solve_batch(p32, torch.tensor(x0s, dtype=f32, device=dev),
                           xs_init=xs0.to(dev, f32), us_init=us0.to(dev, f32),
                           settings=settings, device=dev)
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    fleet_ms = max(r["f32_ms"] for r in reports)
    log(f"[fleet] time f32 B={B_BENCH} T={prob.T} solve_batch maxiter=1: "
        f"{FLEET_RANKS} ranks of {B_BENCH // FLEET_RANKS} "
        f"({reports[0]['backend']}, both on one card) {fleet_ms:.2f} ms "
        f"(ranks {[round(r['f32_ms'], 2) for r in reports]}), one process "
        f"{one_ms:.2f} ms (host clock, one run each): what the layer costs "
        f"on one card, not a scaling figure; spawning the ranks and their "
        f"whole run {spawn_s:.1f} s  ({card})")

    # -- (3) the multi-GPU dry run: one NCCL rank per card ----------------
    t0 = time.perf_counter()
    dry = dryrun_multichip(n_cards, timeout=300)
    for r in dry:
        need(r["backend"] == "nccl", f"dry run rank {r['rank']}: backend "
             f"{r['backend']}")
        launches[f"dryrun_rank{r['rank']}"] = r["launches"]
    log(f"[fleet] dryrun_multichip({n_cards}): {[r['backend'] for r in dry]}"
        f" on {[r['device'] for r in dry]}, costs {dry[0]['costs'].tolist()},"
        f" fleet metrics {dry[0]['metrics']} (all_reduce on CUDA tensors), "
        f"launches {[r['launches'] for r in dry]}, "
        f"{time.perf_counter() - t0:.1f} s  ({card})")

    # -- (4) skeleton on the card against the CPU, and the HTML player ---
    model = prob.state.model
    xs_card = batch64.xs[0]
    t0 = time.perf_counter()
    j_card, f_card, _ = skeleton(model, xs_card, FEET)
    sk_ms = (time.perf_counter() - t0) * 1e3
    j_cpu, f_cpu, _ = skeleton(model, xs_card.cpu(), FEET)
    err = max(float(np.abs(j_card - j_cpu).max()),
              float(np.abs(f_card - f_cpu).max()))
    need(j_card.shape == (prob.T + 1, model.njoints, 3)
         and err <= 1e-12, f"skeleton on the card: {err:.3e}")
    with tempfile.TemporaryDirectory() as tmp:
        path = export_html(model, xs_card, os.path.join(tmp, "walk.html"),
                           FEET, dt=0.01)
        html = open(path).read()
    data = json.loads(html.split("const DATA = ", 1)[1].split(";\n", 1)[0])
    need(len(data["joints"]) == prob.T + 1 and len(data["frames"][0]) == 4,
         "export_html payload")
    log(f"[fleet] skeleton of the f64 walk solution (T={prob.T}) on the "
        f"card: {sk_ms:.2f} ms (first call), joints and feet within "
        f"{err:.3e} of the CPU's; export_html payload {len(html)} B, "
        f"{len(data['joints'])} frames  ({card})")

    # -- (5) aot.precompile of a solve_batch call -------------------------
    p_aot = to_dev(torch, prob, dev, f32)
    x0s_aot = torch.tensor(x0s[:8], dtype=f32, device=dev)
    seen = []

    def solve8(xs):
        sol = solve_batch(p_aot, xs, xs_init=xs0.to(dev, f32),
                          us_init=us0.to(dev, f32), settings=settings,
                          device=dev)
        seen.append(sol.cost)
        return sol
    with count_builds(ck) as first:
        t0 = time.perf_counter()
        ready = aot.precompile(solve8, x0s_aot)
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
    with count_builds(ck) as second:
        t0 = time.perf_counter()
        ready(x0s_aot)
        torch.cuda.synchronize()
        run_ms = (time.perf_counter() - t0) * 1e3
    need(second == {"compile": 0, "descriptor": 0},
         f"precompiled call built {second}")
    need(torch.equal(seen[0], seen[1]), "precompiled call: another result")
    log(f"[fleet] aot.precompile of solve_batch (B=8, f32): {pre_ms:.1f} ms "
        f"building {first}; the next call {run_ms:.1f} ms building "
        f"{second}, the same costs  ({card})")
    return launches


# ---------------------------------------------------------------------------
# Phase 14: whole solves on the device, exported
# ---------------------------------------------------------------------------

# the solution fields an exported solve returns; the decisions among them
EXPORT_FIELDS = ("cost", "iter", "steplength", "is_feasible", "converged",
                 "diverged", "xreg", "stop", "xs", "us", "K")
EXPORT_DECISIONS = ("iter", "steplength", "is_feasible", "converged",
                    "diverged", "xreg")
# stream syncs of one float32 cold replan and one batch step in phase 8
# when the ladder and the line search decided on the host (PERF.md §5)
HOST_DECIDED_SYNCS = {"replan": 194, "batch": 189}
# phase 14's float64 solves over nodes outside kernel 1
NODE_KINDS = ("cop_walk", "impulse_walk", "arm_box_ddp")


def bench_x0s(prob):
    """Phase 4's B_BENCH initial states: x0 with velocity perturbations
    0.01·N(0, 1) from seed 0 (bench.py:52-99)."""
    rng = np.random.default_rng(0)
    x0s = np.tile(prob.x0.numpy()[None], (B_BENCH, 1))
    x0s[:, prob.state.nq:] += 0.01 * rng.standard_normal(
        (B_BENCH, prob.state.nv))
    return x0s


def export_programs(torch, dev, p32, p64, xs0, us0, x0s):
    """{key: (fn, args)} of every function phase 14 exports: "replan f64",
    "replan f32", "batch f64", "batch f32" on the one-segment T=108 walk
    (``p32``/``p64`` on the card, the quasi-static warm start ``xs0``,
    ``us0`` and phase 4's ``x0s``), and, in float64, NODE_KINDS: the
    CoP walk (T=60) and the true-impulse walk (T=108) replans from their
    quasi-static warm starts, and the arm's Box-DDP
    (examples/boxfddp_vs_boxddp.py:21-29: T=60, dt=2e-3, from x0 tiled and
    zero controls, bounds ±0.15 × the effort limits).  Every fn returns
    EXPORT_FIELDS of its solution."""
    from crocoddyl_tpu_torch import (SolverSettings, arm7, box_ddp_settings,
                                     solve, solve_batch)
    f32, f64 = torch.float32, torch.float64
    replan_st = SolverSettings(maxiter=1, fused_scans=True)
    batch_st = SolverSettings(maxiter=1, record_trace=False,
                              parallel_linesearch=False)

    def fields(sol):
        return tuple(getattr(sol, f) for f in EXPORT_FIELDS)

    def replan(p):
        return lambda xs, us: fields(solve(p, xs, us, replan_st, device=dev))

    def batch(p):
        return lambda x0s_, xs, us: fields(solve_batch(
            p, x0s_, xs, us, batch_st, device=dev))
    out = {}
    for dt, p, tag in ((f64, p64, "f64"), (f32, p32, "f32")):
        out[f"replan {tag}"] = (replan(p), (xs0.to(dev, dt),
                                            us0.to(dev, dt)))
        out[f"batch {tag}"] = (batch(p), (
            torch.tensor(x0s, dtype=dt, device=dev), xs0.to(dev, dt),
            us0.to(dev, dt)))
    one = SolverSettings(maxiter=1)
    cop, cxs, cus = cop_walk_problem(torch)
    need(cop.T == 60 and not cop.on_lanes, f"CoP walk T={cop.T}")
    imp, ixs, ius = build_walk(torch, 25, 2, pseudo_impulse=False)
    kinds, knots = segment_kinds(imp)
    need(imp.T == 108 and len(kinds) == 8 and knots == {
        "RigidBodyNode": 104, "ImpulseNode": 4}, "true-impulse walk shape")
    arm = arm_problem(torch, T=60, dt=2e-3)[0]
    lim = (0.15 * arm7().effort_limit).to(dev, f64)
    for name, prob, xs, us, st, kw in (
            ("cop_walk", cop, cxs, cus, one, {}),
            ("impulse_walk", imp, ixs, ius, one, {}),
            ("arm_box_ddp", arm, arm.x0[None].expand(arm.T + 1, -1),
             torch.zeros(arm.T, arm.nu, dtype=f64),
             box_ddp_settings(maxiter=100), dict(u_lb=-lim, u_ub=lim))):
        p = to_dev(torch, prob, dev, f64)

        def fn(xs_, us_, p=p, st=st, kw=kw):
            return fields(solve(p, xs_, us_, st, device=dev, **kw))
        out[name] = (fn, (xs.to(dev, f64).contiguous(), us.to(dev, f64)))
    return out


def exports_worker(device):
    """Phase 14's programs on ``device`` (the card), each run once eagerly
    and then exported with ``aot.export_bytes``: the eager run builds
    what a solve caches (the kernels' descriptors, the knot list, the
    stacked knots), which the export then reads as the eager solve does,
    instead of recording its build.  Then phase 10's two anchors
    (``generic_anchors``).  Runs in a process of its own beside phases 3-5
    (``start_worker``), with ``goldens_worker``; the exports are host
    work, seconds to a minute each, and the two processes' shares are
    about even.  Returns ({key: (bytes, export seconds)}, phase 10's
    {anchor: {wrapper: launches}})."""
    import torch
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.utils import aot
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev, card = torch.device(device), card_line()
    prob, xs0, us0 = build_walk(torch, 25, 2)
    progs = export_programs(
        torch, dev, to_dev(torch, prob, dev, torch.float32),
        to_dev(torch, prob, dev, torch.float64), xs0, us0, bench_x0s(prob))
    out = {}
    for key, (fn, args) in progs.items():
        fn(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data = aot.export_bytes(fn, *args)
        out[key] = (data, time.perf_counter() - t0)
    return out, generic_anchors(torch, ck, dev, card)


def goldens_worker(device):
    """Phase 9b (``run_goldens``) and phase 11 (b) (``zoo_anchors``) in a
    process of their own (``start_worker``), beside phases 3-5: float64
    solves held to golden records, the CPU and the CoP bar, host-bound,
    whose times are not metrics.  Returns phase 11's {anchor: {wrapper:
    launches}}."""
    import torch
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(device)
    run_goldens(torch, dev)
    return zoo_anchors(torch, ck, dev, card_line())


def _worker(queue, target, device):
    try:
        queue.put(("ok", target(device)))
    except BaseException:
        import traceback
        queue.put(("failed", traceback.format_exc()))


def start_worker(target, device=DEVICE):
    """``target(device)`` in a spawned process (a daemon: it ends with this
    one); returns the handle that ``finish_worker`` reads."""
    import multiprocessing
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_worker, args=(queue, target, device),
                       daemon=True, name=f"chip_smoke {target.__name__}")
    proc.start()
    return proc, queue, target.__name__


def finish_worker(handle, timeout=900):
    """The value of the worker's target, once its process has ended; a
    failed check if it raised or did not answer within ``timeout``
    seconds."""
    import queue as queue_mod
    proc, queue, name = handle
    try:
        status, value = queue.get(timeout=timeout)
    except queue_mod.Empty:
        proc.kill()
        status, value = "failed", f"no answer after {timeout} s"
    proc.join(timeout=60)
    need(status == "ok", f"{name} failed:\n{value}")
    return value


# ---------------------------------------------------------------------------
# Phase 15: batched solves (vmap_solve)
# ---------------------------------------------------------------------------

VMAP_MAXITER = 3     # the six walks' float64 solves, batched and single
VMAP_ARM_X0S = 4     # the arm's initial states, the example's own first
VMAP_DECISIONS = DECISIONS + ("xreg",)


def vmap_walks(torch):
    """The six walks of examples/baumgarte_grid_search.py (the ported
    example's grid, T=30), float64 on the CPU: (problems, their batch,
    xs0, us0)."""
    from crocoddyl_tpu_torch.examples.baumgarte_grid_search import (
        grid_problems)
    return grid_problems()


def vmap_same(torch, tag, batch, singles, rerun=None, cost_rtol=1e-8,
              us_atol=1e-6):
    """Each problem of the batched solution against its single solve: the
    decisions equal, controls within ``us_atol`` and cost within
    ``cost_rtol``, or, where a problem's cost misses it and ``rerun(i)``
    re-solves problem i alone, within SENS_FACTOR times that solve's own
    cost change under a DERIV_EPS change of its node derivatives (as
    ``cost_tol``: the batch's products round otherwise than one
    problem's).  Returns the worst (cost rtol, us max abs) and the cost's
    tolerance."""
    rcs, du = [], 0.0
    for i, one in enumerate(singles):
        for fld in VMAP_DECISIONS:
            x, y = getattr(batch, fld)[i].cpu(), getattr(one, fld).cpu()
            need(x.equal(y), f"{tag}: problem {i}: {fld} {x.tolist()} vs "
                 f"{y.tolist()}")
        rcs.append(float((batch.cost[i] - one.cost).abs() / one.cost.abs()))
        du = max(du, float((batch.us[i] - one.us).abs().max()))
    rc, tol = max(rcs), cost_rtol
    if rc > cost_rtol and rerun is not None:
        i = rcs.index(rc)
        with perturbed_derivs(torch, DERIV_EPS):
            pert = rerun(i)
        sens = float((pert.cost - singles[i].cost).abs()
                     / singles[i].cost.abs())
        tol = max(cost_rtol, SENS_FACTOR * sens)
        log(f"  [{tag}] problem {i}'s single solve moves its cost "
            f"{sens:.3e} under a {DERIV_EPS:.0e} change of its node "
            f"derivatives: cost tolerance {tol:.3e}")
    need(rc <= tol and du <= us_atol,
         f"{tag}: cost rtol {rc:.3e} (tol {tol:.1e}), us max abs {du:.3e}")
    return rc, du, tol


def _bits(t):
    """A float tensor's bits (NaN equal to the same NaN)."""
    import torch
    if not t.is_floating_point():
        return t
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def vmap_kernels_p(torch, ck, fsc, batch, probs, xs, us, dt, tag):
    """Kernels 4 and 5 over the P problems of ``batch`` at (xs, us): one
    launch each, bitwise against P single-problem launches on the same
    inputs, and against their plain versions at phase 3's bars (float64:
    ``_agree``), with a forced failure (problem P-1's gaps × 1e35) flagged
    by kernel and plain alike.  Returns ({kernel: max abs against plain},
    the launches' inputs)."""
    from crocoddyl_tpu_torch.core.solvers.fddp import _calc_diff
    from crocoddyl_tpu_torch.utils.struct import tree_map
    P, T = xs.shape[0], xs.shape[1] - 1
    dev = xs.device
    derivs, dterm, fs, _ = _calc_diff(batch, xs, us, False)
    # a regularization a problem, from phase 3's up (float32's Riccati
    # pass needs REG_F32)
    base = 1e-9 if dt == torch.float64 else REG_F32
    reg = torch.tensor([base * 10.0 ** p for p in range(P)], dtype=dt,
                       device=dev)
    ric_in = (derivs, dterm, fs, reg, reg)
    kr = ck.riccati_backward_b1(*ric_in)
    k, K = kr[3], kr[4]
    alpha = torch.tensor([0.5 ** p for p in range(P)], dtype=dt, device=dev)
    ro_in = (batch.segment_knots, batch.x0, xs, us, k, K, fs, alpha)
    ko = fsc.trial_rollout_fused(*ro_in)
    fs_bad = fs.clone()
    fs_bad[-1] *= 1e35
    kf = fsc.trial_rollout_fused(*ro_in[:6], fs_bad, alpha)[-1]
    torch.cuda.synchronize()
    for p in range(P):
        def at(tree, p=p):
            return tree_map(lambda a: a[p], tree)
        one = ck.riccati_backward_b1(at(derivs), at(dterm), fs[p], reg[p],
                                     reg[p])
        need(all(torch.equal(_bits(a[p]), _bits(b)) for a, b in zip(kr, one)),
             f"{tag}: kernel 4 at P={P}, problem {p}, differs from its "
             f"single launch")
        one = fsc.trial_rollout_fused(probs[p].segments[0], batch.x0[p],
                                      xs[p], us[p], k[p], K[p], fs[p],
                                      alpha[p])
        need(all(torch.equal(_bits(a[p]), _bits(b)) for a, b in zip(ko, one)),
             f"{tag}: kernel 5 at P={P}, problem {p}, differs from its "
             f"single launch")
    log(f"  [{tag}] kernels 4 and 5 at P={P}: every output bitwise equal "
        f"to {P} single-problem launches")
    errs = {}
    if dt == torch.float64:
        pr = fsc.riccati_backward_fused_plain(*ric_in)
        need(torch.equal(kr[-1], pr[-1]) and not bool(pr[-1].any()),
             f"{tag}: Riccati failure flags {kr[-1].tolist()} vs "
             f"{pr[-1].tolist()}")
        errs["riccati_b1"] = _agree(tag, "riccati P", ("Vx", "Vxx", "Qu",
                                                       "k", "K", "Quuk"),
                                    kr[:-1], pr[:-1], None)
        po = fsc.trial_rollout_fused_plain(*ro_in)
        pf = fsc.trial_rollout_fused_plain(*ro_in[:6], fs_bad, alpha)[-1]
        need(torch.equal(ko[-1], po[-1]) and not bool(po[-1].any()),
             f"{tag}: rollout failure flags {ko[-1].tolist()}")
        need(torch.equal(kf, pf) and kf.tolist() == [False] * (P - 1)
             + [True], f"{tag}: forced failure of problem {P - 1}: kernel "
             f"{kf.tolist()}, plain {pf.tolist()}")
        errs["rollout_b1"] = _agree(tag, "rollout P", ("xs_try", "us_try",
                                                       "x_last", "cost"),
                                    ko[:-1], po[:-1], None)
        log(f"  [{tag}] rollout P={P}: forced failure of problem {P - 1} "
            f"flagged by kernel and plain, the others not")
    return errs, (ric_in, ro_in)


def run_vmap_checks(torch, ck, dev, card):
    """Phase 15 (a)-(c) (see the module docstring).  Returns ({case:
    {wrapper: launches}}, {kernel: max abs against plain at P=6})."""
    from crocoddyl_tpu_torch import (SolverSettings, arm7, box_ddp_settings,
                                     solve, vmap_solve)
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    from crocoddyl_tpu_torch.parallel import data_mesh, sharded_solve_x0
    f64 = torch.float64
    probs, batch, xs0, us0 = vmap_walks(torch)
    P, T = len(probs), probs[0].T
    probs = [to_dev(torch, p, dev, f64) for p in probs]
    batch = to_dev(torch, batch, dev, f64)
    xs_d, us_d = xs0.to(dev, f64), us0.to(dev, f64)

    def counted(fn):
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        need(not any(plain_calls()), "vmap: plain versions ran")
        return out, all_launches(ck)
    launches = {}
    for tag, st in (("default", SolverSettings(maxiter=VMAP_MAXITER)),
                    ("fused_scans", SolverSettings(maxiter=VMAP_MAXITER,
                                                   fused_scans=True))):
        def run(p, st=st):
            return solve(p, xs_d, us_d, st, device=dev)
        t0 = time.perf_counter()
        singles, each = zip(*(counted(lambda p=p: run(p)) for p in probs))
        t1 = time.perf_counter()
        sol, got = counted(lambda: vmap_solve(run)(batch))
        t2 = time.perf_counter()
        name = f"walks_{tag}"
        rc, du, tol = vmap_same(torch, f"vmap {name}", sol, singles,
                                lambda i: run(probs[i]))
        launches[name] = got
        node = got["node_calc_both"]
        # one kernel-1 launch a batched linearization: one an iteration
        # and the direction at the returned trajectory (maxiter > 1)
        need(node == int(sol.iter.max()) + (VMAP_MAXITER > 1)
             and node == max(e["node_calc_both"] for e in each),
             f"vmap {name}: kernel 1 launches {node}, iterations "
             f"{sol.iter.tolist()}")
        for w in ("riccati_backward_b1", "trial_rollout_b1"):
            n, ns = got[w], [e[w] for e in each]
            if tag == "default":
                need(n == 0 and not any(ns), f"vmap {name}: {w} {n}")
            else:
                need(max(ns) <= n < sum(ns),
                     f"vmap {name}: {w} {n}, single solves {ns}")
        need(got["riccati_backward"] == got["trial_rollout"] == 0,
             f"vmap {name}: kernels 2, 3 launched {got}")
        log(f"[vmap] f64 Baumgarte walks T={T}, P={P}, {tag}, "
            f"maxiter={VMAP_MAXITER}: iterations {sol.iter.tolist()}, "
            f"converged {sol.converged.tolist()}; each problem's decisions "
            f"({', '.join(VMAP_DECISIONS)}) equal to its single solve's, "
            f"cost rtol {rc:.3e} (tol {tol:.1e}), us max abs {du:.3e}; "
            f"launches batched "
            f"{got}, single solves {[tuple(e.values()) for e in each]}; no "
            f"plain call; host clock: batched {t2 - t1:.1f} s, six single "
            f"solves {t1 - t0:.1f} s (not metrics)")
    xs = xs_d.expand(P, -1, -1).contiguous()
    us = us_d.expand(P, -1, -1).contiguous()
    errs, _ = vmap_kernels_p(torch, ck, fsc, batch, probs, xs, us, f64,
                             "f64 P=6")
    # (c) the arm's Box-DDP over four initial states on a one-rank mesh
    arm, _, _ = arm_problem(torch, T=60, dt=2e-3)
    lim = (0.15 * arm7().effort_limit).to(dev, f64)
    rng = np.random.default_rng(0)
    x0s = arm.x0[None].repeat(VMAP_ARM_X0S, 1)
    x0s[1:, :7] += torch.tensor(0.05 * rng.standard_normal(
        (VMAP_ARM_X0S - 1, 7)))
    arm = to_dev(torch, arm, dev, f64)
    x0s = x0s.to(dev)

    def arm_solve(p):
        return solve(p, settings=box_ddp_settings(maxiter=100), u_lb=-lim,
                     u_ub=lim, device=dev)
    sol, got = counted(lambda: sharded_solve_x0(
        arm_solve, arm, data_mesh(device=dev))(x0s))
    launches["arm_box_ddp"] = got
    need(not any(got.values()), f"vmap arm: kernels launched {got}")
    singles = [arm_solve(arm.replace(x0=x)) for x in x0s[1:]]
    rc, du, _ = vmap_same(torch, "vmap arm", _first(sol, 1), singles)
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)["boxfddp_vs_boxddp"]
    rg = abs(float(sol.cost[0]) - golden["cost"]) / abs(golden["cost"])
    need(bool(sol.converged[0]) == golden["converged"]
         and abs(int(sol.iter[0]) - golden["iters"]) <= 1 and rg <= 1e-5,
         f"vmap arm: problem 0 misses the golden: {int(sol.iter[0])} "
         f"iterations, cost {float(sol.cost[0])!r}")
    log(f"[vmap] f64 arm Box-DDP T=60 over {VMAP_ARM_X0S} initial states "
        f"(sharded_solve_x0, one rank): problem 0 (the example's x0) "
        f"converged {bool(sol.converged[0])} in {int(sol.iter[0])} "
        f"iterations, cost {float(sol.cost[0])!r}, golden "
        f"{golden['iters']}, {golden['cost']!r}: rtol {rg:.3e} (tol 1e-5, "
        f"iterations within 1); problems 1-3 ({sol.iter[1:].tolist()} "
        f"iterations) against their single solves: decisions equal, cost "
        f"rtol {rc:.3e}, us max abs {du:.3e}; launches {got}  ({card})")
    return launches, errs


def _tables(d):
    """A kernel descriptor's tables (what a kernel reads of its knots)."""
    return d.meta, d.robot, d.par


def _first(sol, start):
    """The Solution's problems ``start:``."""
    import dataclasses
    return dataclasses.replace(sol, **{
        f: getattr(sol, f)[start:] for f in ("cost", "us", "iter",
                                             "steplength", "is_feasible",
                                             "converged", "diverged",
                                             "xreg")})


def vmap_worker(device):
    """Phase 15 (a)-(c) (``run_vmap_checks``) in a process of its own
    (``start_worker``), beside phases 3-5: float64 checks, host-bound,
    whose times are not metrics."""
    import torch
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return run_vmap_checks(torch, ck, torch.device(device), card_line())


def run_vmap_times(torch, ck, dev, card, launches):
    """Phase 15 (d): the six walks' float32 ``maxiter=1`` replans, batched
    against the six in series (default settings and ``fused_scans``), one
    CUDA-event time each after a warm-up; kernels 4 and 5 at P=6 timed
    beside their plain versions (one run) and their bound.  Adds the
    batched replans' launches to ``launches``; returns {kernel: {ms_p6,
    plain_ms_p6, bound_ms_p6, bound_by_p6}}."""
    from crocoddyl_tpu_torch import SolverSettings, solve, vmap_solve
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    f32 = torch.float32
    probs, batch, xs0, us0 = vmap_walks(torch)
    P, T = len(probs), probs[0].T
    cpu_prob = probs[0]
    probs = [to_dev(torch, p, dev, f32) for p in probs]
    batch = to_dev(torch, batch, dev, f32)
    xs_d, us_d = xs0.to(dev, f32), us0.to(dev, f32)
    for tag, st in (("default", SolverSettings(maxiter=1)),
                    ("fused_scans", SolverSettings(maxiter=1,
                                                   fused_scans=True))):
        def batched(st=st):
            return vmap_solve(lambda p: solve(p, xs_d, us_d, st,
                                              device=dev))(batch)

        def series(st=st):
            return [solve(p, xs_d, us_d, st, device=dev) for p in probs]
        reset_counts()
        sol = batched()     # the warm-up, counted
        torch.cuda.synchronize()
        launches[f"replan_{tag}_f32"] = all_launches(ck)
        need(not any(plain_calls()) and bool(torch.isfinite(sol.cost).all()),
             f"vmap f32 {tag}: plain calls or a non-finite cost")
        b_ms = cuda_time(torch, batched, runs=1, warmup=False)
        solve(probs[0], xs_d, us_d, st, device=dev)   # the series' warm-up
        s_ms = cuda_time(torch, series, runs=1, warmup=False)
        log(f"[vmap] time f32 six Baumgarte walks T={T}, {tag} replan "
            f"(maxiter=1): batched {b_ms:.2f} ms, six single replans in "
            f"series {s_ms:.2f} ms ({s_ms / b_ms:.2f} x); batched launches "
            f"{launches[f'replan_{tag}_f32']}  ({card})")
    xs = xs_d.expand(P, -1, -1).contiguous()
    us = us_d.expand(P, -1, -1).contiguous()
    _, (ric_in, ro_in) = vmap_kernels_p(torch, ck, fsc, batch, probs, xs,
                                        us, f32, "f32 P=6")
    ops = op_counts(torch, cpu_prob)
    out = {}
    for name, kfn, pfn, ins, n_ops in (
            ("riccati_b1", lambda: ck.riccati_backward_b1(*ric_in),
             lambda: fsc.riccati_backward_fused_plain(*ric_in),
             (ric_in[0], ric_in[1].Lx, ric_in[1].Lxx, *ric_in[2:]),
             (ops["riccati_term"] + T * ops["riccati_step"]) * P),
            ("rollout_b1", lambda: fsc.trial_rollout_fused(*ro_in),
             lambda: fsc.trial_rollout_fused_plain(*ro_in),
             (ro_in[1], ro_in[2][:, :T], *ro_in[3:6], ro_in[6][:, :T],
              ro_in[7], _tables(ck.descriptor(ro_in[0], dev, f32))),
             ops["rollout_step"] * T * P)):
        ms = cuda_time(torch, kfn)
        pms = cuda_time(torch, pfn, runs=1, warmup=False)
        n_bytes = nbytes(torch, ins, kfn())
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"[time] {name} kernel at P={P} (T={T}) {ms:.3f} ms, plain "
            f"{pms:.3f} ms, bound {b_ms:.6f} ms by {b_by} ({n_bytes} B, "
            f"{n_ops} operations)  ({card})")
        out[name] = dict(ms_p6=ms, plain_ms_p6=pms, bound_ms_p6=b_ms,
                         bound_by_p6=b_by)
    return out


def run_export(torch, ck, dev, card, p32, p64, xs0, us0, x0s, data):
    """Phase 14: the programs of ``export_programs``, exported by
    ``exports_worker`` (``data``: {key: (bytes, export seconds)}) and
    loaded here with ``aot.import_bytes``.  The
    T=108 walk's replan ``solve(maxiter=1, fused_scans=True)`` and phase
    4's batch step ``solve_batch(maxiter=1)`` at B=256: the float64
    programs against the eager port solves on the card (the same
    decisions, lane by lane; cost rtol 1e-12), the float32 programs'
    kernel launches (the counts zeroed before each run), the program's
    size and export time, CUDA-event medians of the eager solve and of the
    loaded program, and the stream syncs and device-to-host copies of one
    run of each under ``torch.profiler``; then NODE_KINDS
    (``export_node_kinds``).  Returns {case: {wrapper: launches}}."""
    from crocoddyl_tpu_torch.utils import aot
    f32, f64 = torch.float32, torch.float64
    T = p64.T
    progs = export_programs(torch, dev, p32, p64, xs0, us0, x0s)
    cases = {"replan": ("node", "riccati_b1", "rollout_b1"),
             "batch": ("node", "riccati", "rollout")}
    TAG = {f64: "f64", f32: "f32"}
    launches = {}
    for name, keys in cases.items():
        loaded = {}
        for dt in (f64, f32):
            key = f"{name} {TAG[dt]}"
            fn, args = progs[key]
            fn(*args)
            blob, t_exp = data[key]
            t0 = time.perf_counter()
            prog = aot.import_bytes(blob)
            prog(*args)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            log(f"[export] {name} {TAG[dt]} T={T}: program {len(blob)} "
                f"bytes, export {t_exp:.1f} s (in a worker beside phases 3-5), load "
                f"and first run {t_load:.1f} s")
            loaded[dt] = (fn, prog, args)
        fn, prog, args = loaded[f64]
        want, got = fn(*args), prog(*args)
        for fld, a, b in zip(EXPORT_FIELDS, got, want):
            need(a.shape == b.shape and a.dtype == b.dtype,
                 f"export {name}: {fld} shape or dtype")
            if fld in EXPORT_DECISIONS:
                need(torch.equal(a, b), f"export {name} f64: {fld} differs")
        rc = float(((got[0] - want[0]).abs() / want[0].abs()).max())
        du = float((got[9] - want[9]).abs().max())
        log(f"[export] {name} f64 T={T}: the loaded program against the "
            f"eager solve on the card: {', '.join(EXPORT_DECISIONS)} "
            f"equal, cost rtol {rc:.3e}, us max abs {du:.3e}")
        need(rc <= 1e-12, f"export {name}: cost rtol {rc:.3e}")
        fn, prog, args = loaded[f32]
        reset_counts()
        out = prog(*args)
        torch.cuda.synchronize()
        launches[name] = {w.__name__: w.launches for w in ck.WRAPPERS}
        got_l = {k: launches[name][WRAPPER[k]] for k in keys}
        log(f"[export] {name} f32 loaded program: launches {got_l}, plain "
            f"calls {plain_calls()}, cost "
            + (f"{float(out[0]):.6e}" if out[0].dim() == 0 else
               f"median {float(out[0].median()):.6e}"))
        need(all(v > 0 for v in got_l.values()),
             f"export {name}: kernels not launched {got_l}")
        need(not any(plain_calls()), f"export {name}: plain versions ran")
        need(bool(torch.isfinite(out[0]).all()), f"export {name}: cost")
        eager_ms = cuda_time(torch, lambda: fn(*args))
        prog_ms = cuda_time(torch, lambda: prog(*args))
        log(f"[export] time f32 T={T} {name}: eager {eager_ms:.2f} ms, "
            f"loaded program {prog_ms:.2f} ms (CUDA events, median of 5)  "
            f"({card})")
        for tag, f in (("eager", fn), ("loaded program", prog)):
            prof = profile_step(torch, lambda: f(*args), keys)
            if prof is None:
                log(f"[export] {name} {tag}: no device time in the trace: "
                    f"syncs not measured")
                continue
            log(f"[export] syncs f32 {name} {tag}: {prof['stream_syncs']} "
                f"stream syncs, {prof['d2h_copies']} device-to-host and "
                f"{prof['h2d_copies']} host-to-device copies, idle "
                f"{100 * prof['idle_share']:.1f} % of {prof['wall_ms']:.1f}"
                f" ms (host-decided solver: {HOST_DECIDED_SYNCS[name]} "
                f"syncs)  ({card})")
    launches.update(export_node_kinds(torch, ck, card, progs, data))
    log(f"[export] custom-op launches of the programs: {launches}")
    return launches


def export_node_kinds(torch, ck, card, progs, data):
    """Phase 14's float64 NODE_KINDS (see the module docstring): each
    program of ``data`` (key: (bytes, export seconds)) loaded and held to
    the eager solve of ``progs`` (key: (fn, args)) on the card.  Returns
    {case: {wrapper: launches}} of the programs."""
    from crocoddyl_tpu_torch.utils import aot
    with open(os.path.join(HERE, "tests", "golden.json")) as f:
        golden = json.load(f)["boxfddp_vs_boxddp"]
    launches = {}
    for name in NODE_KINDS:
        fn, args = progs[name]
        blob, t_exp = data[name]
        tag = f"{name} f64 T={args[1].shape[0]}"

        def counted(f):
            """``f(*args)`` with the counts zeroed just before and read just
            after; no plain version may run."""
            reset_counts()
            out = f(*args)
            torch.cuda.synchronize()
            need(not any(plain_calls()), f"export {tag}: plain versions ran")
            return out, all_launches(ck)
        # each counted run is also the warm-up of the timed run after it
        want, eager_l = counted(fn)
        eager_ms = cuda_time(torch, lambda: fn(*args), runs=1, warmup=False)
        prog = aot.import_bytes(blob)
        got, prog_l = counted(prog)
        prog_ms = cuda_time(torch, lambda: prog(*args), runs=1, warmup=False)
        node = prog_l["node_calc_both"]
        need(prog_l == eager_l and (node > 0) == (name == "impulse_walk"),
             f"export {tag}: launches {prog_l}, eager {eager_l}")
        launches[name] = prog_l
        for fld, a, b in zip(EXPORT_FIELDS, got, want):
            need(a.shape == b.shape and a.dtype == b.dtype,
                 f"export {tag}: {fld} shape or dtype")
            if fld in EXPORT_DECISIONS:
                need(torch.equal(a, b), f"export {tag}: {fld} differs")
        rc = float((got[0] - want[0]).abs() / want[0].abs())
        du = float((got[9] - want[9]).abs().max())
        log(f"[export] {tag}: program {len(blob)} bytes, export "
            f"{t_exp:.1f} s (in a worker beside phases 3-5); against the eager solve "
            f"on the card: {', '.join(EXPORT_DECISIONS)} equal, cost rtol "
            f"{rc:.3e}, us max abs {du:.3e}; launches {prog_l} (eager "
            f"{eager_l}), no plain call; iter {int(got[1])}, cost "
            f"{float(got[0])!r}")
        need(rc <= 1e-12, f"export {tag}: cost rtol {rc:.3e}")
        log(f"[export] time f64 {tag}: eager {eager_ms:.2f} ms, loaded "
            f"program {prog_ms:.2f} ms (CUDA events, one run after a "
            f"warm-up)  ({card})")
        if name != "arm_box_ddp":
            continue
        for what, out in (("eager", want), ("loaded program", got)):
            rg = abs(float(out[0]) - golden["cost"]) / abs(golden["cost"])
            ok = (bool(out[4]) == golden["converged"]
                  and abs(int(out[1]) - golden["iters"]) <= 1 and rg <= 1e-5)
            log(f"[export] {tag} {what} against the golden "
                f"boxfddp_vs_boxddp: converged {bool(out[4])} in "
                f"{int(out[1])} iterations, cost {float(out[0])!r}; golden "
                f"{golden['converged']}, {golden['iters']}, "
                f"{golden['cost']!r}: cost rtol {rg:.3e} (tol 1e-5, "
                f"iterations within 1)")
            need(ok, f"export {tag}: {what} misses the golden")
    return launches


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    try:
        import crocoddyl_tpu_torch  # noqa: F401
        from crocoddyl_tpu_torch.ops import cuda_kernels as ck
        from crocoddyl_tpu_torch.ops import fused_node as fn
        from crocoddyl_tpu_torch.ops import fused_scans as fsc
        from crocoddyl_tpu_torch import SolverSettings, solve, solve_batch
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)
    t_phase = [time.perf_counter()]
    t_start = t_phase[0]

    def phase_done(name):
        t = time.perf_counter()
        log(f"[{name}] phase took {t - t_phase[0]:.1f} s; {t - t_start:.1f} "
            f"s since the start")
        t_phase[0] = t

    # ---- 1. card --------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)
    f32, f64 = torch.float32, torch.float64

    # ---- 2. build -------------------------------------------------------
    secs = ck.build(verbose=True)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        f.write(ck.build_log())
    log(f"[build] {secs:.1f} s  ({card})")
    for line in ptxas_lines(ck.build_log(), (
            "node_kernel", "riccati_kernel", "riccati_b1_kernel",
            "rollout_kernel", "rollout_b1_kernel")):
        log(f"[build] {line}")
    phase_done("build")

    # phase 14's exports and the anchors of phases 9b, 10 and 11b run in
    # two processes beside phases 3-5, which time nothing, and end before
    # phase 6
    exports_run = start_worker(exports_worker)
    goldens_run = start_worker(goldens_worker)
    vmap_run = start_worker(vmap_worker)

    # ---- 3. kernels against their plain versions -------------------------
    small, xs0_s, us0_s = build_walk(torch, 3, 1)
    check_kernels(torch, to_dev(torch, small, dev, f64), 3, dev, f64,
                  "f64 reduced")
    check_b1_kernels(torch, to_dev(torch, small, dev, f64), dev, f64,
                     "f64 b=1 reduced")
    prob, xs0, us0 = build_walk(torch, 25, 2)
    T, nx, nu = prob.T, prob.state.nx, prob.nu
    p64 = to_dev(torch, prob, dev, f64)
    p32 = to_dev(torch, prob, dev, f32)
    log_launch_shapes(torch, ck, prob, dev)
    errs64 = check_kernels(torch, p64, B_BENCH, dev, f64, "f64 bench")[0]
    errs, inp, derivs_l, dterm_l, xreg, k_l, K_l = check_kernels(
        torch, p32, B_BENCH, dev, f32, "f32 bench", warm=(xs0, us0),
        reg=REG_F32)
    errs64.update(check_b1_kernels(torch, p64, dev, f64, "f64 b=1")[0])
    errs_b1, b1_in = check_b1_kernels(torch, p32, dev, f32, "f32 b=1",
                                      warm=(xs0, us0), reg=REG_F32)
    errs.update(errs_b1)
    phase_done("kernels")

    # ---- 4. batch lane --------------------------------------------------
    x0s = bench_x0s(prob)
    settings = SolverSettings(maxiter=1, record_trace=False,
                              parallel_linesearch=False)

    def step(p, dt):
        return solve_batch(p, torch.tensor(x0s, dtype=dt, device=dev),
                           xs_init=xs0.to(dev, dt), us_init=us0.to(dev, dt),
                           settings=settings, device=dev)

    reset_counts()
    sol = step(p32, f32)
    torch.cuda.synchronize()
    launches = {"node": ck.node_calc_both.launches,
                "riccati": ck.riccati_backward.launches,
                "rollout": ck.trial_rollout.launches}
    log(f"[batch] f32 B={B_BENCH} T={T}: launches {launches}, plain calls "
        f"{plain_calls()}")
    need(all(v > 0 for v in launches.values()), f"launches {launches}")
    need(not any(plain_calls()), "plain versions ran")
    need(sol.cost.shape == (B_BENCH,) and sol.us.shape == (B_BENCH, T, nu),
         "solution shapes")
    need(bool(torch.isfinite(sol.cost).all()), "non-finite cost")
    log(f"[batch] f32 cost median {float(sol.cost.median()):.6e}, steps "
        f"{sorted(set(sol.steplength.tolist()))}")

    # float64: kernel path vs plain path
    k64 = step(p64, f64)
    with plain_path():
        t0 = time.perf_counter()
        ref64 = step(p64, f64)
        torch.cuda.synchronize()
        plain64_s = time.perf_counter() - t0
    need(torch.equal(k64.iter, ref64.iter), "iter differs")
    need(torch.equal(k64.steplength, ref64.steplength),
         "steplength differs")
    rc = float(((k64.cost - ref64.cost).abs() / ref64.cost.abs()).max())
    du = float((k64.us - ref64.us).abs().max())
    log(f"[batch] f64 kernel vs plain: same iter/steplength, cost rtol "
        f"{rc:.3e}, us max abs {du:.3e} (plain f64 solve {plain64_s:.1f} s)")
    need(rc <= 1e-8, f"cost rtol {rc:.3e}")
    batch64 = k64
    phase_done("batch")

    # ---- 5. b=1 lane ----------------------------------------------------
    def replan(p, dt, xs_w=xs0, us_w=us0, maxiter=1):
        return solve(p, xs_w.to(dev, dt), us_w.to(dev, dt),
                     SolverSettings(maxiter=maxiter, record_trace=False,
                                    parallel_linesearch=False,
                                    fused_scans=True), device=dev)

    reset_counts()
    sol1 = replan(p32, f32)
    torch.cuda.synchronize()
    launches_b1 = b1_launches(ck)
    log(f"[b=1] f32 T={T} cold replan: launches {launches_b1}, plain calls "
        f"{plain_calls()}")
    need(all(v > 0 for v in launches_b1.values()),
         f"b=1 launches {launches_b1}")
    need(not any(plain_calls()), "plain versions ran")
    need(sol1.xs.shape == (T + 1, nx) and sol1.us.shape == (T, nu)
         and sol1.K.shape == (T, nu, prob.state.ndx), "b=1 solution shapes")
    need(bool(torch.isfinite(sol1.cost)), "non-finite b=1 cost")
    log(f"[b=1] f32 cold replan: cost {float(sol1.cost):.6e}, steplength "
        f"{float(sol1.steplength)}, xreg {float(sol1.xreg):.1e}")

    k64 = replan(p64, f64)
    with plain_path():
        t0 = time.perf_counter()
        ref64 = replan(p64, f64)
        torch.cuda.synchronize()
        plain_b1_s = time.perf_counter() - t0
    same("b=1 f64 replan", k64, ref64, ("iter", "steplength", "is_feasible"))
    rc = float((k64.cost - ref64.cost).abs() / ref64.cost.abs())
    log(f"[b=1] f64 replan kernel vs plain: iter {int(k64.iter)}, steplength"
        f" {float(k64.steplength)}, feasible {bool(k64.is_feasible)} in "
        f"both, cost rtol {rc:.3e}, us max abs "
        f"{float((k64.us - ref64.us).abs().max()):.3e} (plain f64 replan "
        f"{plain_b1_s:.1f} s)")
    need(rc <= 1e-8, f"b=1 cost rtol {rc:.3e}")

    s64 = to_dev(torch, small, dev, f64)
    km = replan(s64, f64, xs0_s, us0_s, maxiter=20)
    with plain_path():
        pm = replan(s64, f64, xs0_s, us0_s, maxiter=20)
    same("b=1 f64 maxiter=20 (reduced walk)", km, pm,
         ("iter", "converged", "steplength", "xreg", "is_feasible",
          "diverged"))
    log(f"[b=1] f64 maxiter=20, reduced walk T={small.T}: iter "
        f"{int(km.iter)}, converged {bool(km.converged)}, steplength "
        f"{float(km.steplength)}, xreg {float(km.xreg):.1e} in both, cost "
        f"rtol {float((km.cost - pm.cost).abs() / pm.cost.abs()):.3e}")

    conv = replan(p64, f64, maxiter=50)
    need(bool(conv.converged), f"f64 maxiter=50 did not converge at T={T} "
         f"(iter {int(conv.iter)}, stop {float(conv.stop):.3e})")
    log(f"[b=1] f64 maxiter=50 at T={T}: converged in {int(conv.iter)} "
        f"iterations, cost {float(conv.cost):.6e}: the steady-state warm "
        f"start")
    xs_w, us_w = conv.xs.cpu(), conv.us.cpu()
    phase_done("b=1")

    # the workers end before the timed phases start
    exports, generic = finish_worker(exports_run)
    zoo_anchor_launches = finish_worker(goldens_run)
    vmap_launches, errs_p6 = finish_worker(vmap_run)
    phase_done("workers (14's exports, 9b, 10's anchors, 11b, 15 (a)-(c), "
               "beside phases 3-5)")

    # ---- 6. solver surface ----------------------------------------------
    # Box-FDDP with the URDF's effort limits from the rollout of the
    # quasi-static controls (feasible: the box gains apply once the
    # candidate is), the default settings (the generic passes, as in JAX),
    # DDP and the fused-scans settings from the quasi-static warm start
    from crocoddyl_tpu_torch import (box_fddp_settings, ddp_settings,
                                     replicate_model)
    from crocoddyl_tpu_torch.core.problem import ShootingProblem
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    lim = prob.state.model.effort_limit[6:]
    xs_feas = prob.rollout(us0)
    surface = {
        "box": (box_fddp_settings(maxiter=1), xs_feas, us0,
                dict(is_feasible=True, u_lb=-lim, u_ub=lim)),
        "default": (SolverSettings(maxiter=1), xs0, us0, {}),
        "ddp": (ddp_settings(maxiter=1, parallel_linesearch=False,
                             record_trace=False, fused_scans=True), xs0,
                us0, {}),
        "fused_scans": (SolverSettings(maxiter=1, fused_scans=True), xs0,
                        us0, {})}

    def run_surface(name, p, dt, table=surface):
        st, xs_s, us_s, kw = table[name]
        return solve(p, xs_s.to(dev, dt), us_s.to(dev, dt), st, device=dev,
                     **kw)

    launches_surface, surface_ms = {}, {}
    for name in surface:
        reset_counts()
        with record_qp() as qp:
            if name == "box":
                # this first run gives phase 8 its host-clock split too: a
                # second box replan (~16 s) would not fit the time limit
                out = []
                surface_ms[name], box_split = host_split(
                    torch, lambda: out.append(run_surface(name, p32, f32)))
                sol_s = out[0]
            else:
                t0 = time.perf_counter()
                sol_s = run_surface(name, p32, f32)
                torch.cuda.synchronize()
                surface_ms[name] = (time.perf_counter() - t0) * 1e3
        got = b1_launches(ck)
        launches_surface[name] = {w.__name__: w.launches
                                  for w in ck.WRAPPERS}
        log(f"[surface] f32 T={T} {name} replan: launches {got}, plain "
            f"calls {plain_calls()}, cost {float(sol_s.cost):.6e}, "
            f"steplength {float(sol_s.steplength)}, xreg "
            f"{float(sol_s.xreg):.1e}, feasible {bool(sol_s.is_feasible)}")
        need(got["node"] > 0, f"{name}: node kernel not launched")
        if name in ("box", "default"):
            need(got["riccati_b1"] == 0 and got["rollout_b1"] == 0,
                 f"{name}: kernels 4/5 launched {got}")
        else:
            need(got["riccati_b1"] > 0 and got["rollout_b1"] > 0,
                 f"{name}: kernels 4/5 not launched {got}")
        need(not any(plain_calls()), f"{name}: plain versions ran")
        need(bool(torch.isfinite(sol_s.cost)) and sol_s.us.shape == (T, nu),
             f"{name}: solution")
        need((sol_s.trace is not None) == (name != "ddp"), f"{name}: trace")
        if name == "box":
            n_qp, it_sum, it_mean, it_max, clamped = qp.summary(torch, T)
            lim_d = lim.to(dev, f32)
            on_b = int(((sol_s.us == lim_d) | (sol_s.us == -lim_d)).sum())
            over = int((us0.abs() > lim).sum())
            log(f"[surface] f32 box replan: {n_qp} BoxQP solves, "
                f"{it_sum} iterations (mean {it_mean:.2f}, max {it_max}); "
                f"{clamped} of {T * nu} controls clamped by the final "
                f"pass's QPs, {on_b} returned controls on a bound, "
                f"{over} quasi-static controls beyond the limits "
                f"(|u| <= {float(lim.max()):.1f} N m)")
    for name in surface:
        k64s = run_surface(name, p64, f64)
        with plain_path():
            t0 = time.perf_counter()
            r64s = run_surface(name, p64, f64)
            torch.cuda.synchronize()
            plain_s = time.perf_counter() - t0
        same(f"surface f64 {name}", k64s, r64s,
             ("iter", "steplength", "is_feasible"))
        rc = float((k64s.cost - r64s.cost).abs() / r64s.cost.abs())
        tol, sens = 1e-8, None
        if name == "box":
            tol, sens = cost_tol(
                torch, lambda: run_surface(name, p64, f64), r64s.cost)
        log(f"[surface] f64 T={T} {name} replan kernel vs plain: iter "
            f"{int(k64s.iter)}, steplength {float(k64s.steplength)}, "
            f"feasible {bool(k64s.is_feasible)} in both, cost rtol "
            f"{rc:.3e} (tol {tol:.1e}"
            + ("" if sens is None else f"; plain path's cost moves "
               f"{sens:.3e} under a {DERIV_EPS:.0e} change of its node "
               f"derivatives") + f"; plain path {plain_s:.1f} s)")
        need(rc <= tol, f"surface {name}: cost rtol {rc:.3e}")
    # Box-FDDP on the reduced walk with bounds that bind: 0.15 x the URDF
    # limits, as examples/boxfddp_vs_boxddp.py scales them, from the
    # rollout of the quasi-static controls clamped to them
    lim_s = 0.15 * small.state.model.effort_limit[6:]
    us_t = torch.clamp(us0_s, -lim_s, lim_s)
    tight = {"box": (box_fddp_settings(maxiter=1), small.rollout(us_t),
                     us_t, dict(is_feasible=True, u_lb=-lim_s,
                                u_ub=lim_s))}
    with record_qp() as qp:
        kb = run_surface("box", s64, f64, tight)
    with plain_path():
        pb = run_surface("box", s64, f64, tight)
    same("surface f64 tight box (reduced walk)", kb, pb,
         ("iter", "steplength", "is_feasible"))
    n_qp, it_sum, _, it_max, clamped = qp.summary(torch, small.T)
    rc = float((kb.cost - pb.cost).abs() / pb.cost.abs())
    tol, sens = cost_tol(torch, lambda: run_surface(
        "box", s64, f64, tight), pb.cost)
    log(f"[surface] f64 Box-FDDP, reduced walk T={small.T}, |u| <= "
        f"{float(lim_s.max()):.1f} N m: iter {int(kb.iter)}, steplength "
        f"{float(kb.steplength)}, feasible {bool(kb.is_feasible)} in kernel "
        f"and plain path, cost rtol {rc:.3e} (tol {tol:.1e}; sensitivity "
        f"{sens:.3e}); {n_qp} BoxQP solves, {it_sum} iterations (max "
        f"{it_max}), {clamped} controls clamped")
    on_b = int((kb.us.abs() == lim_s.to(dev)).sum())
    log(f"[surface] f64 tight box: {on_b} of {small.T * nu} returned "
        f"controls on a bound")
    need(rc <= tol, f"tight box: cost rtol {rc:.3e}")
    need(clamped > 0 and on_b > 0, "tight box: no control on a bound")
    # the unicycle anchor (T=20) on the card, FDDP and Box-FDDP |u| <= 1,
    # against the same solves on the CPU
    um = UnicycleModel()
    uni = ShootingProblem(x0=torch.tensor([-1.0, -1.0, 1.0],
                                          dtype=torch.float64),
                          running=replicate_model(um, 20), terminal=um)
    for tag, st, kw in (
            ("FDDP", SolverSettings(maxiter=50), {}),
            ("Box-FDDP |u| <= 1", box_fddp_settings(maxiter=50),
             dict(u_lb=-torch.ones(2), u_ub=torch.ones(2)))):
        on_card = solve(uni, settings=st, device=dev, **kw)
        on_cpu = solve(uni, settings=st, device="cpu", **kw)
        same(f"unicycle {tag}", on_card, on_cpu,
             ("iter", "converged", "steplength", "is_feasible"))
        rc = float((on_card.cost.cpu() - on_cpu.cost).abs()
                   / on_cpu.cost.abs())
        log(f"[surface] f64 unicycle T=20 {tag} on the card: converged "
            f"{bool(on_card.converged)} in {int(on_card.iter)} iterations, "
            f"cost {float(on_card.cost):.11f}, rtol {rc:.3e} to the CPU")
        need(bool(on_card.converged) and rc <= 1e-9, f"unicycle {tag}")
        if tag == "FDDP":
            # the anchor of the verify notes: 9 iterations, 249.56089793…
            need(int(on_card.iter) == 9
                 and abs(float(on_card.cost) - 249.56089793082) < 1e-8,
                 f"unicycle anchor: {float(on_card.cost)!r}")
    for name in surface:
        # each replan ran above: no warm-up run; the two host-bound replans
        # of the generic passes (seconds each) timed in that first run (host
        # clock to a device sync), the others median of 3
        runs = 1 if name in ("box", "default") else 3
        if runs == 3:
            surface_ms[name] = cuda_time(torch, lambda: run_surface(
                name, p32, f32), runs=runs, warmup=False)
        log(f"[surface] time f32 T={T} {name} replan: {surface_ms[name]:.2f}"
            f" ms ({'the first run' if runs == 1 else 'median of 3'})  "
            f"({card})")
    phase_done("surface")

    # ---- 7. timing ------------------------------------------------------
    kern32_ms = cuda_time(torch, lambda: step(p32, f32))
    # the float32 plain step (~26 s) is not timed, for the script's time
    # limit; each kernel's plain version is, below
    log(f"[time] solve_batch maxiter=1 B={B_BENCH} T={T} f32: kernel path "
        f"{kern32_ms:.2f} ms ({B_BENCH / kern32_ms * 1e3:.1f} solves/s)  "
        f"({card})")
    reset_counts()
    warm1 = replan(p32, f32, xs_w, us_w)
    torch.cuda.synchronize()
    warm_trials = ck.trial_rollout_b1.launches
    cold_ms = cuda_time(torch, lambda: replan(p32, f32))
    warm_ms = cuda_time(torch, lambda: replan(p32, f32, xs_w, us_w))
    log(f"[time] b=1 replan T={T} f32: cold (quasi-static warm start) "
        f"{cold_ms:.2f} ms, {launches_b1['rollout_b1']} trials; steady "
        f"state (converged warm start) {warm_ms:.2f} ms, {warm_trials} "
        f"trials, steplength {float(warm1.steplength)}  ({card})")

    ops = op_counts(torch, prob)
    log(f"[bound] operations counted on the plain versions: node "
        f"{ops['node']}, Riccati step {ops['riccati_step']} (terminal "
        f"{ops['riccati_term']}), rollout step {ops['rollout_step']}")
    xr, ur = xreg, xreg.clone()
    ro_args = (p32.running, inp["xs_l"][0], inp["xs_l"][:-1].contiguous(),
               inp["us_l"], k_l.contiguous(), K_l.contiguous(),
               inp["fs"][:-1].contiguous())
    ric_b1, ro_b1 = b1_in["riccati_b1"], b1_in["rollout_b1"]
    N_lane, N_b1 = inp["x_n"].shape[-1], b1_in["node_b1"][1].shape[-1]

    def tables(seg):
        return _tables(ck.descriptor(seg, dev, f32))

    # the step length and the regularization as the solvers pass them: 0-d
    # tensors on the card
    alpha_d = torch.full((), 0.5, dtype=f32, device=dev)
    reg_d = torch.full((), REG_F32, dtype=f32, device=dev)
    rows = [
        ("node", "crocoddyl_tpu_torch/csrc/node_kernel.cu",
         "crocoddyl_tpu/ops/fused_node.py:1477",
         lambda: ck.node_calc_both(inp["knots"], inp["x_n"], inp["u_n"]),
         lambda: fn.calc_both_lanes_plain(inp["knots"], inp["x_n"],
                                          inp["u_n"]),
         (inp["x_n"], inp["u_n"], tables(inp["knots"])),
         ops["node"] * N_lane, launches["node"]),
        ("riccati", "crocoddyl_tpu_torch/csrc/riccati_kernel.cu",
         "crocoddyl_tpu/ops/fused_scans.py:536",
         lambda: ck.riccati_backward(derivs_l, dterm_l, inp["fs"], xr, ur),
         lambda: fsc.riccati_backward_lanes_plain(derivs_l, dterm_l,
                                                  inp["fs"], xr, ur),
         (derivs_l, dterm_l.Lx, dterm_l.Lxx, inp["fs"], xr, ur),
         (ops["riccati_term"] + T * ops["riccati_step"]) * B_BENCH,
         launches["riccati"]),
        ("rollout", "crocoddyl_tpu_torch/csrc/rollout_kernel.cu",
         "crocoddyl_tpu/ops/fused_scans.py:708",
         lambda: ck.trial_rollout(*ro_args, alpha_d),
         lambda: fsc.trial_rollout_lanes_plain(*ro_args, inp["fs"][-1],
                                               alpha_d),
         (ro_args[1:], tables(p32.running)),
         ops["rollout_step"] * T * B_BENCH, launches["rollout"]),
        ("riccati_b1", "crocoddyl_tpu_torch/csrc/riccati_fused_kernel.cu",
         "crocoddyl_tpu/ops/fused_scans.py:215",
         lambda: ck.riccati_backward_b1(*ric_b1, reg_d, reg_d),
         lambda: fsc.riccati_backward_fused_plain(*ric_b1, reg_d, reg_d),
         (ric_b1[0], ric_b1[1].Lx, ric_b1[1].Lxx, ric_b1[2]),
         ops["riccati_term"] + T * ops["riccati_step"],
         launches_b1["riccati_b1"]),
        ("rollout_b1", "crocoddyl_tpu_torch/csrc/rollout_fused_kernel.cu",
         "crocoddyl_tpu/ops/fused_scans.py:327",
         lambda: ck.trial_rollout_b1(*ro_b1, alpha_d),
         lambda: fsc.trial_rollout_fused_plain(*ro_b1, alpha_d),
         (ro_b1[1:], tables(p32.running)), ops["rollout_step"] * T,
         launches_b1["rollout_b1"]),
    ]
    kernels = []
    for name, src, rep, kfn, pfn, ins, n_ops, n_launch in rows:
        # the plain versions once: a plain rollout takes seconds
        ms, pms = (cuda_time(torch, kfn),
                   cuda_time(torch, pfn, runs=1, warmup=False))
        n_bytes = nbytes(torch, ins, kfn())
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        log(f"[time] {name} kernel {ms:.3f} ms, plain {pms:.3f} ms, bound "
            f"{b_ms:.6f} ms by {b_by} ({n_bytes} B, {n_ops} operations; "
            f"{100 * b_ms / ms:.3f} % of bound) (f32, main-path shapes)  "
            f"({card})")
        fname = WRAPPER[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": n_launch,
                        "launches_surface": {
                            k: v[fname] for k, v in launches_surface.items()},
                        "max_abs_err": errs[name],
                        "max_abs_err_f64": errs64[name], "ms": ms,
                        "plain_ms": pms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None, "library_note": LIBRARY_NONE})
    # kernel 1 on the b=1 lane: the T+1 nodes of one problem
    node_b1 = b1_in["node_b1"]
    ms = cuda_time(torch, lambda: ck.node_calc_both(*node_b1))
    pms = cuda_time(torch, lambda: fn.calc_both_lanes_plain(*node_b1))
    b_ms, b_by = bound_ms(nbytes(torch, node_b1[1:], tables(node_b1[0]),
                                 ck.node_calc_both(*node_b1)),
                          ops["node"] * N_b1)
    log(f"[time] node kernel at N={N_b1} (b=1) {ms:.3f} ms, plain "
        f"{pms:.3f} ms, bound {b_ms:.6f} ms by {b_by}  ({card})")
    kernels[0].update(launches_b1=launches_b1["node"], ms_b1=ms,
                      plain_ms_b1=pms, bound_ms_b1=b_ms, bound_by_b1=b_by,
                      max_abs_err_b1=errs["node_b1"])
    phase_done("timing")

    # ---- 8. profile -----------------------------------------------------
    for tag, fname, fn_step, keys in (
            ("batch step", "profile.json", lambda: step(p32, f32),
             ("node", "riccati", "rollout")),
            ("b=1 cold replan", "profile_b1.json", lambda: replan(p32, f32),
             ("node", "riccati_b1", "rollout_b1"))):
        prof = profile_step(torch, fn_step, keys)
        if prof is None:
            log(f"[profile] {tag}: the trace holds no device time: not "
                f"measured ({card})")
            continue
        prof["card"] = card
        with open(os.path.join(OUT, fname), "w") as f:
            json.dump(prof, f, indent=1)
        kms = ", ".join(f"{k} {v:.3f} ms" for k, v in
                        prof["kernel_ms"].items())
        log(f"[profile] one f32 {tag}: {kms}, glue {prof['glue_ms']:.3f} ms "
            f"({prof['glue_events']} device events), device "
            f"{prof['device_ms']:.3f} ms of wall {prof['wall_ms']:.3f} ms, "
            f"idle {prof['idle_ms']:.3f} ms "
            f"({100 * prof['idle_share']:.1f} %), {prof['stream_syncs']} "
            f"stream syncs, {prof['h2d_copies']} H2D copies  ({card})")
    # the f32 box replan: the host clock's split into linearization,
    # backward passes and trials, from its first run in phase 6 (its
    # profile, ~3M device events, took 1-2 min a run: not measured, for the
    # script's time limit)
    wall, split = surface_ms["box"], box_split
    rest = wall - sum(split.values())
    log(f"[profile] one f32 box replan, host clock between syncs: wall "
        f"{wall:.1f} ms; linearization (kernel 1, gaps) "
        f"{split['_calc_diff']:.1f} ms, backward passes with BoxQP "
        f"{split['_backward_pass']:.1f} ms, trial rollouts "
        f"{split['_forward_pass']:.1f} ms, rest {rest:.1f} ms  ({card})")
    phase_done("profile")

    # ---- 9. gaits and MPC -----------------------------------------------
    run_gaits(torch, ck, dev, card)
    phase_done("gaits")
    per_tick = mpc_loop(torch, ck, dev, card, prob, xs0, us0, p64, xs_w,
                        us_w)
    phase_done("mpc")

    # ---- 10. generic nodes --------------------------------------------------
    run_generic(torch, ck, dev, card, p64, lambda: replan(p32, f32),
                launches_b1, small)
    phase_done("generic")

    # ---- 11. the biped, the humanoid and the quadrotor ---------------------
    zoo = run_zoo(torch, ck, dev, card)
    zoo.update(zoo_anchor_launches)
    phase_done("zoo")

    # ---- 12. segmented problems and the true impulse switch knot ----------
    seg = run_segments(torch, ck, dev, card, p64, (xs0, us0))
    phase_done("segments")

    # ---- 13. the fleet over ranks, display and aot ------------------------
    fleet = run_fleet(torch, ck, dev, card, prob, x0s, xs0, us0, batch64)
    phase_done("fleet")

    # ---- 14. whole solves on the device, exported ------------------------
    exported = run_export(torch, ck, dev, card, p32, p64, xs0, us0, x0s,
                          exports)
    phase_done("export")

    # ---- 15. batched solves (vmap_solve) ---------------------------------
    # (a)-(c) ran in vmap_worker beside phases 3-5; (d) here
    times_p6 = run_vmap_times(torch, ck, dev, card, vmap_launches)
    phase_done("vmap")
    for k in kernels:
        k["launches_mpc"] = per_tick[WRAPPER[k["name"]]]
        k["launches_generic"] = {a: n[WRAPPER[k["name"]]]
                                 for a, n in generic.items()}
        k["launches_zoo"] = {a: n[WRAPPER[k["name"]]]
                             for a, n in zoo.items()}
        k["launches_seg"] = {a: n[WRAPPER[k["name"]]]
                             for a, n in seg.items()}
        k["launches_fleet"] = {a: n[WRAPPER[k["name"]]]
                               for a, n in fleet.items()}
        k["launches_export"] = {a: n[WRAPPER[k["name"]]]
                                for a, n in exported.items()}
        k["launches_vmap"] = {a: n[WRAPPER[k["name"]]]
                              for a, n in vmap_launches.items()}
        if k["name"] in times_p6:
            k.update(times_p6[k["name"]],
                     max_abs_err_p6_f64=errs_p6[k["name"]])
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
