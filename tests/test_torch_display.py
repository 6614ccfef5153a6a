"""The port's display layer (crocoddyl_tpu_torch/io/display.py) and the
plots of crocoddyl_tpu_torch/utils/callbacks.py against the JAX package,
float64 on the CPU (matplotlib's Agg backend):

- ``skeleton`` of the quadruped (``robots.quadruped()``, handed to the
  port through ``io/convert``) at the standing q and 4 states of seeded
  random joint angles: JAX's joint and foot positions at atol 1e-12;
- ``export_html``: JAX's JSON payload (atol 1e-4: it is rounded to 4
  decimals), no external resource;
- ``animate_matplotlib`` writes a GIF; ``DisplayLog`` renders what it
  collected; ``CallbackDisplay`` as the port's ``solve(...,
  iter_callback=...)`` on the unicycle calls it, once per iteration (as
  tests/test_display.py:61-91);
- ``plot_oc_solution`` and ``plot_convergence``: the line data of JAX's
  plots of the same solution arrays.
"""

import json
import os
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_parity import np_, to_port

FEET = ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"]


@pytest.fixture(scope="module")
def quadruped():
    """(JAX model, port model, states (5, nx)): the standing q, then 4
    states with the joint angles moved by 0.2·N(0, 1) from a seed."""
    from crocoddyl_tpu.dynamics import robots
    jm = robots.quadruped()
    q0 = np.asarray(robots.quadruped_standing_q(jm))
    rng = np.random.default_rng(3)
    xs = np.tile(np.concatenate([q0, np.zeros(jm.nv)])[None], (5, 1))
    xs[1:, 7:jm.nq] += 0.2 * rng.standard_normal((4, jm.nq - 7))
    return jm, to_port(jm), xs


def test_skeleton_matches_jax(quadruped):
    from crocoddyl_tpu.io import display as jdisplay
    from crocoddyl_tpu_torch.io.display import skeleton
    jm, pm, xs = quadruped
    joints, frames, parents = skeleton(pm, torch.tensor(xs), FEET)
    rj, rf, rp = jdisplay.skeleton(jm, jnp.asarray(xs), FEET)
    assert joints.shape == (5, pm.njoints, 3) and frames.shape == (5, 4, 3)
    assert isinstance(joints, np.ndarray)
    np.testing.assert_allclose(joints, rj, rtol=0, atol=1e-12)
    np.testing.assert_allclose(frames, rf, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(parents, rp)
    # standing pose: feet near the ground, base above them
    assert np.all(frames[0, :, 2] < joints[0, 0, 2])
    # no frames asked for, states given as numpy
    j2, f2, _ = skeleton(pm, xs)
    np.testing.assert_array_equal(j2, joints)
    assert f2.shape == (5, 0, 3)


def _payload(path):
    html = open(path).read()
    data = html.split("const DATA = ", 1)[1].split(";\n", 1)[0]
    return html, json.loads(data)


def test_export_html_matches_jax(quadruped, tmp_path):
    from crocoddyl_tpu.io import display as jdisplay
    from crocoddyl_tpu_torch.io.display import export_html
    jm, pm, xs = quadruped
    html, got = _payload(export_html(pm, torch.tensor(xs),
                                     str(tmp_path / "port.html"), FEET,
                                     dt=0.01))
    _, want = _payload(jdisplay.export_html(jm, jnp.asarray(xs),
                                            str(tmp_path / "jax.html"),
                                            FEET, dt=0.01))
    assert "crocoddyl_tpu trajectory player" in html
    assert "http" not in html.split("<script>")[1]
    assert set(got) == set(want)
    assert got["bones"] == want["bones"]
    for k in ("joints", "frames", "widths", "mid", "rng", "dt"):
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_animate_gif(quadruped, tmp_path):
    from crocoddyl_tpu_torch.io.display import animate_matplotlib
    _, pm, xs = quadruped
    path = animate_matplotlib(pm, torch.tensor(xs[:4]),
                              str(tmp_path / "gait.gif"), FEET, fps=5)
    assert path.endswith(".gif") and os.path.getsize(path) > 1000


def test_display_log(quadruped, tmp_path):
    from crocoddyl_tpu_torch.io.display import DisplayLog
    _, pm, xs = quadruped
    log = DisplayLog(pm, FEET)
    for x in torch.tensor(xs[:3]):
        log.push(x)
    path = log.render(str(tmp_path / "mpc.html"), dt=0.02)
    _, data = _payload(path)
    assert len(data["joints"]) == 3 and data["dt"] == 0.02


def _unicycle():
    from crocoddyl_tpu_torch import ShootingProblem, replicate_model
    from crocoddyl_tpu_torch.models.unicycle import UnicycleModel
    m = UnicycleModel()
    return ShootingProblem(x0=torch.tensor([-1.0, -1.0, 1.0],
                                           dtype=torch.float64),
                           running=replicate_model(m, 20), terminal=m)


def test_iter_callback_and_callback_display(quadruped, tmp_path):
    """The port's ``solve`` calls ``iter_callback`` once per iteration;
    ``CallbackDisplay`` keeps every ``every``-th candidate and renders one
    player each."""
    from crocoddyl_tpu_torch import SolverSettings, solve
    from crocoddyl_tpu_torch.io.display import CallbackDisplay
    calls = []
    cd = CallbackDisplay(None, every=2)
    sol = solve(_unicycle(), settings=SolverSettings(
        maxiter=50, iter_callback=lambda it, cost, xs: (
            calls.append(int(it)), cd(it, cost, xs))), device="cpu")
    assert bool(sol.converged)
    assert calls == list(range(int(sol.iter)))
    assert [s[0] for s in cd.snapshots] == calls[::2]
    assert all(isinstance(s[2], np.ndarray) and s[2].shape == (21, 3)
               for s in cd.snapshots)

    _, pm, xs = quadruped
    cd = CallbackDisplay(pm, every=2)
    for it in range(4):
        cd(torch.tensor(it), torch.tensor(1.0), torch.tensor(
            np.tile(xs[0], (3, 1))))
    assert len(cd.snapshots) == 2
    outs = cd.render(str(tmp_path / "cb"))
    assert [os.path.basename(o) for o in outs] == ["cb_iter000.html",
                                                   "cb_iter002.html"]
    assert "widths" in open(outs[0]).read()


def _lines(fig):
    return [[np.asarray(ln.get_ydata(), np.float64) for ln in ax.lines]
            for ax in fig.axes]


def test_plots_match_jax():
    """plot_oc_solution and plot_convergence draw JAX's lines from the same
    solution arrays."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from crocoddyl_tpu.utils import callbacks as jcb
    from crocoddyl_tpu_torch import (SolverSettings, plot_convergence,
                                     plot_oc_solution, solve)
    sol = solve(_unicycle(), settings=SolverSettings(maxiter=50),
                device="cpu")
    tr = types.SimpleNamespace(**{f: np_(getattr(sol.trace, f)) for f in (
        "cost", "grad", "stop", "steplength", "xreg")})
    ref = types.SimpleNamespace(xs=np_(sol.xs), us=np_(sol.us),
                                iter=int(sol.iter), trace=tr)
    try:
        for port_plot, jax_plot in (
                (lambda: plot_oc_solution(sol, show=False, fig_index=11),
                 lambda: jcb.plot_oc_solution(ref, show=False,
                                              fig_index=12)),
                (lambda: plot_oc_solution(xs=sol.xs, us=sol.us, show=False,
                                          fig_index=13),
                 lambda: jcb.plot_oc_solution(xs=ref.xs, us=ref.us,
                                              show=False, fig_index=14)),
                (lambda: plot_convergence(sol, show=False, fig_index=15),
                 lambda: jcb.plot_convergence(ref, show=False,
                                              fig_index=16))):
            got, want = _lines(port_plot()), _lines(jax_plot())
            assert [len(a) for a in got] == [len(a) for a in want]
            for ga, wa in zip(got, want):
                for g, w in zip(ga, wa):
                    np.testing.assert_array_equal(g, w)
        assert len(got) == 5 and len(got[0][0]) == int(sol.iter)
    finally:
        plt.close("all")
