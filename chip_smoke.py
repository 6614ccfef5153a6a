#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

Phases (any failure exits non-zero):

1. card: CUDA present, card name and power limit, TF32 off;
2. build: compile the three CUDA kernels of crocoddyl_tpu_torch/csrc for
   sm_90a;
3. kernels: each kernel against its plain PyTorch version on the card, in
   float64 at the reduced walk and at bench size, and in float32 at bench
   size;
4. main path: ``solve_batch(maxiter=1)`` on the ANYmal walk (T=108, B=256)
   through the kernels in float32 (launch counts, finite costs), then the
   float64 kernel path against the float64 plain path (same decisions);
5. timing: CUDA events, one warm-up, median of 5 runs;
6. profile: one float32 step under ``torch.profiler``: each kernel's device
   time, the rest of the device time (ATen glue), and the idle share of the
   step's wall time (also written to chiprun_out/chip_smoke/profile.json).

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


def build_walk(torch, step_knots, support_knots):
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.anymal(dtype=torch.float64)
    q0 = robots.anymal_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    prob = fac.walking_problem(x0, 0.25, 0.15, 1e-2, step_knots=step_knots,
                               support_knots=support_knots)
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
    # rollout at alpha = 0.5 with the plain gains
    ureg[0] = reg
    _, _, _, k_l, K_l, _, _ = fsc.riccati_backward_lanes_plain(*ric_in)
    args = (prob.running, inp["xs_l"][0], inp["xs_l"][:-1].contiguous(),
            inp["us_l"], k_l.contiguous(), K_l.contiguous(),
            inp["fs"][:-1].contiguous())
    ko = ck.trial_rollout(*args, 0.5)
    po = fsc.trial_rollout_lanes_plain(*args, inp["fs"][-1], 0.5)
    ro = (fsc.trial_rollout_lanes_plain(*up(args + (inp["fs"][-1],)), 0.5)
          if f32 else None)
    torch.cuda.synchronize()
    need(bool((ko[-1] == po[-1]).all()), f"rollout failure flags ({tag})")
    ok = ~po[-1]
    log(f"  [{tag}] rollout: {int(ok.sum())}/{B} lanes without failure")
    names = ("xs_try", "us_try", "x_last", "cost")
    errs["rollout"] = _agree(tag, "rollout", names, ko[:-1], po[:-1],
                             None if ro is None else ro[:-1], ok)
    return errs, inp, derivs_l, dterm_l, xreg, k_l, K_l


def cuda_time(torch, fn, runs=5):
    """Median milliseconds of ``fn`` over ``runs`` runs after one warm-up."""
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


def profile_step(torch, step):
    """Device-time breakdown of one ``step()`` under torch.profiler: ms per
    kernel of the path, the other device time (glue), the device total, the
    wall time and its idle share; None if the trace holds no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {"node": 0.0, "riccati": 0.0, "rollout": 0.0}
    total, glue_n, syncs, h2d = 0.0, 0, 0, 0
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            syncs += e.name == "cudaStreamSynchronize"
            continue
        if getattr(e, "is_user_annotation", False):
            continue
        ms = e.time_range.elapsed_us() / 1e3
        total += ms
        h2d += "HtoD" in e.name
        for k in kern:
            if f"{k}_kernel" in e.name:
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
            "stream_syncs": syncs, "h2d_copies": h2d}


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
        from crocoddyl_tpu_torch import SolverSettings, solve_batch
    except ImportError as e:
        print(f"chip_smoke: the port is not next to this script ({e})",
              file=sys.stderr)
        return 1
    os.makedirs(OUT, exist_ok=True)

    # ---- 1. card --------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device(DEVICE)

    # ---- 2. build -------------------------------------------------------
    secs = ck.build(verbose=True)
    with open(os.path.join(OUT, "ptxas.txt"), "w") as f:
        f.write(ck.build_log())
    log(f"[build] {secs:.1f} s  ({card})")

    # ---- 3. kernels against their plain versions -------------------------
    small, xs0_s, us0_s = build_walk(torch, 3, 1)
    check_kernels(torch, to_dev(torch, small, dev, torch.float64), 3, dev,
                  torch.float64, "f64 reduced")
    prob, xs0, us0 = build_walk(torch, 25, 2)
    T = prob.T
    p64 = to_dev(torch, prob, dev, torch.float64)
    p32 = to_dev(torch, prob, dev, torch.float32)
    errs64 = check_kernels(torch, p64, B_BENCH, dev, torch.float64,
                           "f64 bench")[0]
    errs, inp, derivs_l, dterm_l, xreg, k_l, K_l = check_kernels(
        torch, p32, B_BENCH, dev, torch.float32, "f32 bench",
        warm=(xs0, us0), reg=REG_F32)

    # ---- 4. main path ---------------------------------------------------
    rng = np.random.default_rng(0)
    x0 = prob.x0.numpy()
    x0s = np.tile(x0[None], (B_BENCH, 1))
    x0s[:, prob.state.nq:] += 0.01 * rng.standard_normal(
        (B_BENCH, prob.state.nv))
    settings = SolverSettings(maxiter=1, record_trace=False,
                              parallel_linesearch=False)

    def solve(p, dt):
        return solve_batch(p, torch.tensor(x0s, dtype=dt, device=dev),
                           xs_init=xs0.to(dev, dt), us_init=us0.to(dev, dt),
                           settings=settings)

    plain_calls = (fn.calc_both_lanes_plain, fsc.riccati_backward_lanes_plain,
                   fsc.trial_rollout_lanes_plain)
    for f in plain_calls:
        f.calls = 0
    ck.reset_counts()
    sol = solve(p32, torch.float32)
    torch.cuda.synchronize()
    launches = {"node": ck.node_calc_both.launches,
                "riccati": ck.riccati_backward.launches,
                "rollout": ck.trial_rollout.launches}
    log(f"[main] f32 B={B_BENCH} T={T}: launches {launches}, plain calls "
        f"{[f.calls for f in plain_calls]}")
    need(all(v > 0 for v in launches.values()), f"launches {launches}")
    need(all(f.calls == 0 for f in plain_calls), "plain versions ran")
    need(sol.cost.shape == (B_BENCH,) and sol.us.shape == (B_BENCH, T, 12),
         "solution shapes")
    need(bool(torch.isfinite(sol.cost).all()), "non-finite cost")
    log(f"[main] f32 cost median {float(sol.cost.median()):.6e}, steps "
        f"{sorted(set(sol.steplength.tolist()))}")

    # float64: kernel path vs plain path (the plain path is the same solver
    # with the plain versions, selected here by calling them directly)
    k64 = solve(p64, torch.float64)
    saved = (fn.calc_both_lanes, fsc.riccati_backward_lanes,
             fsc.trial_rollout_lanes)
    fn.calc_both_lanes = fn.calc_both_lanes_plain
    fsc.riccati_backward_lanes = fsc.riccati_backward_lanes_plain
    fsc.trial_rollout_lanes = fsc.trial_rollout_lanes_plain
    try:
        t0 = time.perf_counter()
        ref64 = solve(p64, torch.float64)
        torch.cuda.synchronize()
        plain64_s = time.perf_counter() - t0
        plain32_ms = cuda_time(torch, lambda: solve(p32, torch.float32))
    finally:
        (fn.calc_both_lanes, fsc.riccati_backward_lanes,
         fsc.trial_rollout_lanes) = saved
    need(torch.equal(k64.iter, ref64.iter), "iter differs")
    need(torch.equal(k64.steplength, ref64.steplength),
         "steplength differs")
    rc = float(((k64.cost - ref64.cost).abs() / ref64.cost.abs()).max())
    du = float((k64.us - ref64.us).abs().max())
    log(f"[main] f64 kernel vs plain: same iter/steplength, cost rtol "
        f"{rc:.3e}, us max abs {du:.3e} (plain f64 solve {plain64_s:.1f} s)")
    need(rc <= 1e-8, f"cost rtol {rc:.3e}")

    # ---- 5. timing ------------------------------------------------------
    kern32_ms = cuda_time(torch, lambda: solve(p32, torch.float32))
    log(f"[time] solve_batch maxiter=1 B={B_BENCH} T={T} f32: kernel path "
        f"{kern32_ms:.2f} ms ({B_BENCH / kern32_ms * 1e3:.1f} solves/s), "
        f"plain path {plain32_ms:.2f} ms ({B_BENCH / plain32_ms * 1e3:.1f} "
        f"solves/s)  ({card})")
    xr = xreg
    ur = xreg.clone()
    args = (p32.running, inp["xs_l"][0], inp["xs_l"][:-1].contiguous(),
            inp["us_l"], k_l.contiguous(), K_l.contiguous(),
            inp["fs"][:-1].contiguous())
    rows = [
        ("node", "cuda", "crocoddyl_tpu_torch/csrc/node_kernel.cu",
         "crocoddyl_tpu/ops/fused_node.py:1477",
         lambda: ck.node_calc_both(inp["knots"], inp["x_n"], inp["u_n"]),
         lambda: fn.calc_both_lanes_plain(inp["knots"], inp["x_n"],
                                          inp["u_n"])),
        ("riccati", "cuda", "crocoddyl_tpu_torch/csrc/riccati_kernel.cu",
         "crocoddyl_tpu/ops/fused_scans.py:536",
         lambda: ck.riccati_backward(derivs_l, dterm_l, inp["fs"], xr, ur),
         lambda: fsc.riccati_backward_lanes_plain(derivs_l, dterm_l,
                                                  inp["fs"], xr, ur)),
        ("rollout", "cuda", "crocoddyl_tpu_torch/csrc/rollout_kernel.cu",
         "crocoddyl_tpu/ops/fused_scans.py:708",
         lambda: ck.trial_rollout(*args, 0.5),
         lambda: fsc.trial_rollout_lanes_plain(*args, inp["fs"][-1], 0.5)),
    ]
    kernels = []
    for name, route, src, rep, kfn, pfn in rows:
        ms, pms = cuda_time(torch, kfn), cuda_time(torch, pfn)
        log(f"[time] {name} kernel {ms:.3f} ms, plain {pms:.3f} ms "
            f"(f32, main-path shapes)  ({card})")
        kernels.append({"name": name, "route": route, "source": src,
                        "replaces": rep, "launches": launches[name],
                        "max_abs_err": errs[name],
                        "max_abs_err_f64": errs64[name], "ms": ms,
                        "plain_ms": pms})

    # ---- 6. profile -----------------------------------------------------
    prof = profile_step(torch, lambda: solve(p32, torch.float32))
    if prof is None:
        log(f"[profile] the trace holds no device time: not measured "
            f"({card})")
    else:
        prof["card"] = card
        with open(os.path.join(OUT, "profile.json"), "w") as f:
            json.dump(prof, f, indent=1)
        k = prof["kernel_ms"]
        log(f"[profile] one f32 step: node {k['node']:.3f} ms, riccati "
            f"{k['riccati']:.3f} ms, rollout {k['rollout']:.3f} ms, glue "
            f"{prof['glue_ms']:.3f} ms ({prof['glue_events']} device events),"
            f" device {prof['device_ms']:.3f} ms of wall "
            f"{prof['wall_ms']:.3f} ms, idle {prof['idle_ms']:.3f} ms "
            f"({100 * prof['idle_share']:.1f} %), {prof['stream_syncs']} "
            f"stream syncs, {prof['h2d_copies']} H2D copies  ({card})")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
