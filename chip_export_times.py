#!/usr/bin/env python3
"""Time phase 14's float32 programs of ``chip_smoke.py`` against their eager
solves on one NVIDIA GPU, in interleaved pairs.

Usage: ``python3 chip_export_times.py [--pairs N]`` from the repository
root.  It builds the kernels and, on the T=108 ANYmal walk, the two float32
functions phase 14 exports (``chip_smoke.export_programs``): the replan
``solve(maxiter=1, fused_scans=True)`` and the batch step
``solve_batch(maxiter=1)`` at B=256.  Each is run once eagerly, exported
with ``aot.export_bytes`` and loaded with ``aot.import_bytes``; after one
warm-up run of each, N pairs of runs follow, eager first in the even pairs
and the program first in the odd ones, each run timed with CUDA events
(and the host clock), first with Python's garbage collector on, then with
it off during the timed runs.  Per function and setting it prints the
medians and quartiles of both, the program's share of pairs won and the
ratio of the medians.  The last line of standard output is one JSON object
with those numbers and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time


def timed(torch, f):
    """(CUDA-event ms, host-clock ms) of one run of ``f``."""
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    f()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b), (time.perf_counter() - t0) * 1e3


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return q[0], statistics.median(xs), q[2]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=10)
    n = ap.parse_args().pairs
    try:
        import torch
    except ImportError:
        print("chip_export_times: PyTorch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_export_times: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.utils import aot
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    card, dev = cs.card_line(), torch.device(cs.DEVICE)
    ck.build()
    prob, xs0, us0 = cs.build_walk(torch, 25, 2)
    progs = cs.export_programs(
        torch, dev, cs.to_dev(torch, prob, dev, torch.float32),
        cs.to_dev(torch, prob, dev, torch.float64), xs0, us0,
        cs.bench_x0s(prob))
    result = {"card": card, "pairs": n}
    for key in ("replan f32", "batch f32"):
        fn, args = progs[key]
        fn(*args)
        torch.cuda.synchronize()
        prog = aot.import_bytes(aot.export_bytes(fn, *args))
        runs = {"eager": lambda: fn(*args), "program": lambda: prog(*args)}
        for f in runs.values():
            f()
        for gc_on in (True, False):
            ms = {k: [] for k in runs}
            host = {k: [] for k in runs}
            wins = 0
            if not gc_on:
                gc.collect()
                gc.disable()
            try:
                for i in range(n):
                    order = ("eager", "program") if i % 2 == 0 else (
                        "program", "eager")
                    for k in order:
                        d, h = timed(torch, runs[k])
                        ms[k].append(d)
                        host[k].append(h)
                    wins += ms["program"][-1] < ms["eager"][-1]
            finally:
                gc.enable()
            row = {k: {"ms_q1_median_q3": quartiles(ms[k]),
                       "host_ms_median": statistics.median(host[k])}
                   for k in runs}
            ratio = (row["program"]["ms_q1_median_q3"][1]
                     / row["eager"]["ms_q1_median_q3"][1])
            row.update(program_wins=wins, ratio=ratio)
            tag = f"{key} gc {'on' if gc_on else 'off'}"
            result[tag] = row
            e, p = (row[k]["ms_q1_median_q3"] for k in ("eager", "program"))
            print(f"[export times] {tag}: eager {e[1]:.2f} ms (quartiles "
                  f"{e[0]:.2f}-{e[2]:.2f}), program {p[1]:.2f} ms "
                  f"({p[0]:.2f}-{p[2]:.2f}), program/eager {ratio:.3f}, "
                  f"program faster in {wins} of {n} pairs (CUDA events)  "
                  f"({card})", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
