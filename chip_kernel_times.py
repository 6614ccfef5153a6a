#!/usr/bin/env python3
"""Time the five CUDA kernels of one checkout of the port on one NVIDIA
GPU, at each lane's main-path shapes.

Usage: ``python3 chip_kernel_times.py [--root DIR] [--dtype float64]``.  It
imports ``crocoddyl_tpu_torch`` from DIR (default: this script's
directory), builds that checkout's kernels, and times in float32 (or the
given dtype) on the T=108 ANYmal walk, with the inputs ``chip_smoke.py``
times them on (the warm start with 1e-3 noise, gains of the plain Riccati
pass at regularization 1):

- kernel 1 (node) at B=256 (N=27,904 nodes) and at the N=109 nodes of one
  problem;
- kernel 2 (batch Riccati pass) at B=256 and kernel 4 (single-problem
  Riccati pass), on the plain node derivatives at regularization 1;
- kernel 3 (batch rollout) at B=256, α=0.5;
- kernel 5 (single-problem rollout), α=0.5.

CUDA events, one warm-up, median of 5.  The last line of standard output
is one JSON object with the times, the checkout and the card's name and
power limit.  To compare two checkouts on one card, run it in turns in one
call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout to import crocoddyl_tpu_torch from")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "float64"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, HERE)
    sys.path.insert(0, root)
    import chip_smoke as cs
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.ops import fused_node as fn
    from crocoddyl_tpu_torch.ops import fused_scans as fsc
    from crocoddyl_tpu_torch.utils.struct import tree_map
    if not ck.__file__.startswith(root):
        print(f"chip_kernel_times: imported {ck.__file__}, not from {root}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev, dt = torch.device("cuda:0"), getattr(torch, args.dtype)
    card = cs.card_line()
    build_s = ck.build()
    prob, xs0, us0 = cs.build_walk(torch, 25, 2)
    p = cs.to_dev(torch, prob, dev, dt)
    T, B = prob.T, cs.B_BENCH
    out = {"root": os.path.relpath(root, HERE), "dtype": args.dtype,
           "card": card, "build_s": build_s}

    # batch lane: node kernel at N = (T+1)·B, rollout kernel at B
    inp = cs.kernel_inputs(torch, p, B, dev, dt, 0, warm=(xs0, us0))
    pd = fn.calc_both_lanes_plain(inp["knots"], inp["x_n"], inp["u_n"])[0]
    d_l, dT_l = cs.split_derivs(torch, pd, T, B)
    reg = torch.full((B,), cs.REG_F32, dtype=dt, device=dev)
    _, _, _, k_l, K_l, _, _ = fsc.riccati_backward_lanes_plain(
        d_l, dT_l, inp["fs"], reg, reg)
    ro = (p.running, inp["xs_l"][0], inp["xs_l"][:-1].contiguous(),
          inp["us_l"], k_l.contiguous(), K_l.contiguous(),
          inp["fs"][:-1].contiguous())
    out["node_ms"] = cs.cuda_time(torch, lambda: ck.node_calc_both(
        inp["knots"], inp["x_n"], inp["u_n"]))
    out["riccati_ms"] = cs.cuda_time(torch, lambda: ck.riccati_backward(
        d_l, dT_l, inp["fs"], reg, reg))
    out["rollout_ms"] = cs.cuda_time(torch, lambda: ck.trial_rollout(
        *ro, 0.5))

    # b=1 lane: node kernel at N = T+1, single-problem rollout kernel
    inp1 = cs.kernel_inputs(torch, p, 1, dev, dt, 0, warm=(xs0, us0))
    pd1 = fn.calc_both_lanes_plain(inp1["knots"], inp1["x_n"],
                                   inp1["u_n"])[0]
    d1, dT1 = cs.split_derivs(torch, pd1, T, 1)

    def one(tree):
        return tree_map(lambda a: a[..., 0].contiguous(), tree)
    fs1 = inp1["fs"][..., 0].contiguous()
    ric = fsc.riccati_backward_fused_plain(one(d1), one(dT1), fs1,
                                           cs.REG_F32, cs.REG_F32)
    ro1 = (p.running, inp1["xs_l"][0, :, 0].contiguous(),
           inp1["xs_l"][:-1, :, 0].contiguous(),
           inp1["us_l"][..., 0].contiguous(), ric[3], ric[4],
           fs1[:-1].contiguous())
    out["node_b1_ms"] = cs.cuda_time(torch, lambda: ck.node_calc_both(
        inp1["knots"], inp1["x_n"], inp1["u_n"]))
    out["riccati_b1_ms"] = cs.cuda_time(torch, lambda: ck.riccati_backward_b1(
        one(d1), one(dT1), fs1, cs.REG_F32, cs.REG_F32))
    out["rollout_b1_ms"] = cs.cuda_time(torch, lambda: ck.trial_rollout_b1(
        *ro1, 0.5))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
