"""Iteration diagnostics, logging, persistence and plots (port of
crocoddyl_tpu/utils/callbacks.py).

Reference: core/utils/callbacks.hpp:19-29 + src/core/utils/callbacks.cpp
(CallbackVerbose's 8-column table), bindings __init__.py:356-381
(CallbackLogger) and :463-492 (saveOCSolution / saveLogfile).  The solver
records per-iteration diagnostics into the Trace of its Solution
(``SolverSettings(record_trace=True)``) and these helpers render and persist
them afterwards, in the reference's golden-log format.  matplotlib is
imported inside the plots.
"""

from __future__ import annotations

import pickle
from typing import Optional

import numpy as np
import torch

HEADER = "iter \t cost \t      stop \t    grad \t  xreg \t      ureg \t step \t feas"


def _np(a):
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def format_trace(trace, iters: Optional[int] = None) -> str:
    """Render a solver Trace as the CallbackVerbose table
    (callbacks.cpp print format: examples/log/quadrupedal_gaits.log:2)."""
    cols = {f: _np(getattr(trace, f)) for f in (
        "cost", "stop", "grad", "xreg", "ureg", "steplength", "feasible")}
    n = (int(iters) if iters is not None
         else int(np.sum(~np.isnan(cols["cost"]))))
    rows = [HEADER]
    for i in range(n):
        rows.append(
            "%4d  %.5e  %.5e  %.5e  %.5e  %.5e   %.4f     %d" % (
                i, float(cols["cost"][i]), float(cols["stop"][i]),
                float(cols["grad"][i]), float(cols["xreg"][i]),
                float(cols["ureg"][i]), float(cols["steplength"][i]),
                int(cols["feasible"][i])))
    return "\n".join(rows)


def print_trace(solution, title: str = "") -> None:
    """CallbackVerbose equivalent, applied after the solve."""
    if title:
        print(f"*** SOLVE {title} ***")
    if solution.trace is None:
        raise ValueError("solve() was run with record_trace=False")
    print(format_trace(solution.trace, solution.iter))


class SolverLog:
    """CallbackLogger analogue (bindings __init__.py:356-381): accumulates
    per-solve records, e.g. across MPC replans."""

    def __init__(self):
        self.xs, self.us, self.costs = [], [], []
        self.stops, self.iters, self.steps = [], [], []
        self.xregs, self.uregs = [], []

    def append(self, solution):
        self.xs.append(_np(solution.xs))
        self.us.append(_np(solution.us))
        self.costs.append(float(solution.cost))
        self.stops.append(float(solution.stop))
        self.iters.append(int(solution.iter))
        self.steps.append(float(solution.steplength))
        self.xregs.append(float(solution.xreg))
        self.uregs.append(float(solution.ureg))


def save_solution(filename: str, solution) -> None:
    """Persist xs/us/K/k (+ trace): saveOCSolution/saveLogfile analogue
    (bindings __init__.py:463-492)."""
    data = {
        "xs": _np(solution.xs), "us": _np(solution.us),
        "K": _np(solution.K), "k": _np(solution.k),
        "cost": float(solution.cost), "iter": int(solution.iter),
        "stop": float(solution.stop),
    }
    if solution.trace is not None:
        data["trace"] = {f: _np(getattr(solution.trace, f))
                         for f in ("cost", "stop", "grad", "xreg", "ureg",
                                   "steplength", "feasible")}
    with open(filename, "wb") as f:
        pickle.dump(data, f)


def load_solution(filename: str) -> dict:
    """Read back what ``save_solution`` wrote (a pickle: open only files
    this program wrote)."""
    with open(filename, "rb") as f:
        return pickle.load(f)


def save_solution_csv(prefix: str, solution, dt: Optional[float] = None
                      ) -> list:
    """RH5-style CSV logging (RH5/utils/utils.py:845 logSolution): writes
    ``<prefix>_xs.csv`` (time + state rows) and ``<prefix>_us.csv``
    (time + control rows); returns the file names."""
    names = []
    for tag, arr in (("xs", _np(solution.xs)), ("us", _np(solution.us))):
        t = (np.arange(arr.shape[0]) * (dt if dt is not None else 1.0)
             )[:, None]
        fname = f"{prefix}_{tag}.csv"
        header = "t," + ",".join(
            f"{tag[0]}{i}" for i in range(arr.shape[1]))
        np.savetxt(fname, np.concatenate([t, arr], axis=1), delimiter=",",
                   header=header, comments="")
        names.append(fname)
    return names


def plot_oc_solution(solution=None, xs=None, us=None, show: bool = True,
                     fig_index: int = 1):
    """plotOCSolution analogue (bindings __init__.py:384-424)."""
    import matplotlib.pyplot as plt
    if solution is not None:
        xs, us = solution.xs, solution.us
    plt.figure(fig_index)
    ax1 = plt.subplot(2, 1, 1)
    ax1.plot(_np(xs))
    ax1.set_ylabel("state")
    ax2 = plt.subplot(2, 1, 2)
    ax2.plot(_np(us))
    ax2.set_ylabel("control")
    ax2.set_xlabel("knots")
    if show:
        plt.show()
    return plt.gcf()


def plot_convergence(solution, show: bool = True, fig_index: int = 2):
    """plotConvergence analogue (bindings __init__.py:425-462)."""
    import matplotlib.pyplot as plt
    tr = solution.trace
    n = int(solution.iter)
    plt.figure(fig_index, figsize=(6.4, 8))
    names = ["cost", "grad", "stop", "steplength", "xreg"]
    for i, name in enumerate(names):
        ax = plt.subplot(len(names), 1, i + 1)
        data = _np(getattr(tr, name))[:n]
        if name in ("cost", "grad", "stop", "xreg"):
            ax.semilogy(np.maximum(np.abs(data), 1e-30))
        else:
            ax.plot(data)
        ax.set_ylabel(name)
    plt.xlabel("iteration")
    if show:
        plt.show()
    return plt.gcf()
