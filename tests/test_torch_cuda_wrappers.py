"""The port stands alone, and the Python around its CUDA kernels is right
without a card: no JAX in the package, no build at import, wrappers that
refuse CPU tensors, the node descriptor the kernels read, and the
(time, element, lane) strides the Riccati kernel takes from the solver's
views of the node kernel's outputs."""

import os
import subprocess
import sys

import pytest
import torch

from tests._torch_parity import torch_walk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import crocoddyl_tpu_torch as p
names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split('.')[0] in ('jax', 'jaxlib', 'flax', 'crocoddyl_tpu',
                                    'triton'))
assert not bad, bad
from crocoddyl_tpu_torch.ops import cuda_kernels as ck
assert ck._lib is None
assert [w.launches for w in ck.WRAPPERS] == [0] * 5
print(len(names))
"""


def test_port_imports_no_jax_and_builds_nothing():
    """A fresh process imports every module of the port: no JAX, no
    crocoddyl_tpu, no triton, no kernel library loaded."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 25


def _knots():
    prob = torch_walk()
    term = prob.terminal.replace(dt=torch.zeros_like(prob.terminal.dt))
    from crocoddyl_tpu_torch.utils.struct import tree_map
    return prob, tree_map(lambda r, t: torch.cat([r, t[None]]),
                          prob.running, term)


def test_descriptor_tables():
    from crocoddyl_tpu_torch.models.multibody.costs import cost_nr
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    prob, knots = _knots()
    desc = ck.descriptor(knots, torch.device("cpu"), torch.float64)
    assert ck.descriptor(knots, torch.device("cpu"), torch.float64) is desc
    m = prob.state.model
    meta = desc.meta.tolist()
    nj, nv, nq, ff, nframes, ncon, ncost, P, nu = meta[:9]
    assert (nj, nv, nq, ff, nu) == (m.njoints, 18, 19, 1, 12)
    assert (nframes, ncon) == (len(m.frame_parents), 4)
    assert ncost == len(knots.costs.items)
    assert tuple(desc.par.shape) == (prob.T + 1, P)
    dt_off = meta[10]
    torch.testing.assert_close(desc.par[:, dt_off], knots.dt.reshape(-1),
                               rtol=0, atol=0)
    assert desc.nr == sum(cost_nr(c, knots.state_)
                          for c in knots.costs.items)
    assert float(desc.robot[-1]) == float(knots.kkt_damping)
    # the joint-depth table the rollout kernels' sweep walks by level: the
    # base, then the 4 hips, thighs and shanks
    assert meta[14] == 4 and len(meta) == desc.nmeta
    assert meta[-nj:] == [0] + [1, 2, 3] * 4
    assert (desc.nrobot, desc.P) == (desc.robot.numel(), P)


def test_lane_strides_of_solver_views():
    """The solver hands the node kernel's (..., (T+1)·B) outputs to the
    Riccati kernel as (T, ..., B) views with no copy; the wrapper reads
    their strides, and refuses a view whose element axes do not collapse."""
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    T, B, n = 5, 3, 4
    a = torch.zeros(n, n, (T + 1) * B)
    view = a.reshape(n, n, T + 1, B).movedim(-2, 0)[:T]
    assert ck._lane_strides("r", "Fx", view, True) == (B, (T + 1) * B)
    assert ck._lane_strides("r", "LxxT", view[T - 1], False) == (
        0, (T + 1) * B)
    with pytest.raises(ValueError):
        ck._lane_strides("r", "Fx", view.transpose(1, 2), True)
    with pytest.raises(ValueError):
        ck._lane_strides("r", "Fx", view.movedim(-1, 1), True)


@pytest.mark.parametrize("ndx, nu", [(36, 17), (64, 12)])
def test_riccati_wrappers_refuse_sizes_past_the_registers(ndx, nu):
    """The Riccati kernels hold Quu's rows (nu ≤ 16) and two right-hand-side
    columns a lane (ndx + 1 ≤ 64) in registers; the wrappers refuse larger
    problems before anything is built or launched."""
    from crocoddyl_tpu_torch.core.action import NodeDerivs
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    T, B = 2, 3
    e = torch.zeros
    d = NodeDerivs(Fx=e(T, ndx, ndx, B), Fu=e(T, ndx, nu, B),
                   Lx=e(T, ndx, B), Lu=e(T, nu, B), Lxx=e(T, ndx, ndx, B),
                   Lxu=e(T, ndx, nu, B), Luu=e(T, nu, nu, B))
    dT = NodeDerivs(Fx=None, Fu=None, Lx=e(ndx, B), Lu=None,
                    Lxx=e(ndx, ndx, B), Lxu=None, Luu=None)
    with pytest.raises(ValueError, match="the kernel takes"):
        ck.riccati_backward(d, dT, e(T + 1, ndx, B), e(B), e(B))
    from crocoddyl_tpu_torch.utils.struct import tree_map
    one = tree_map(lambda a: a[..., 0], d)
    with pytest.raises(ValueError, match="the kernel takes"):
        ck.riccati_backward_b1(one, NodeDerivs(
            Fx=None, Fu=None, Lx=e(ndx), Lu=None, Lxx=e(ndx, ndx), Lxu=None,
            Luu=None), e(T + 1, ndx), 1e-9, 1e-9)
    assert (ck.riccati_backward.launches, ck.riccati_backward_b1.launches) \
        == (0, 0)
    assert ck._lib is None


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers take CUDA tensors only; on CPU tensors they raise
    before building or launching anything."""
    from crocoddyl_tpu_torch.core.action import NodeDerivs
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    prob, knots = _knots()
    T, B = prob.T, 2
    e = torch.zeros
    with pytest.raises(ValueError, match="cpu"):
        ck.node_calc_both(knots, e(37, (T + 1) * B, dtype=torch.float64),
                          e(12, (T + 1) * B, dtype=torch.float64))
    d = NodeDerivs(Fx=e(T, 36, 36, B), Fu=e(T, 36, 12, B), Lx=e(T, 36, B),
                   Lu=e(T, 12, B), Lxx=e(T, 36, 36, B), Lxu=e(T, 36, 12, B),
                   Luu=e(T, 12, 12, B))
    dT = NodeDerivs(Fx=None, Fu=None, Lx=e(36, B), Lu=None, Lxx=e(36, 36, B),
                    Lxu=None, Luu=None)
    with pytest.raises(ValueError, match="cpu"):
        ck.riccati_backward(d, dT, e(T + 1, 36, B), e(B), e(B))
    with pytest.raises(ValueError, match="cpu"):
        ck.trial_rollout(prob.running, e(37, B, dtype=torch.float64),
                         e(T, 37, B, dtype=torch.float64),
                         e(T, 12, B, dtype=torch.float64),
                         e(T, 12, B, dtype=torch.float64),
                         e(T, 12, 36, B, dtype=torch.float64),
                         e(T, 36, B, dtype=torch.float64), 0.5)
    assert (ck.node_calc_both.launches, ck.riccati_backward.launches,
            ck.trial_rollout.launches) == (0, 0, 0)
    assert ck._lib is None


def test_b1_wrappers_refuse_cpu_tensors():
    """The single-problem wrappers (kernels 4 and 5) take CUDA tensors
    only; on CPU tensors they raise before building or launching."""
    from crocoddyl_tpu_torch.core.action import NodeDerivs
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    prob = torch_walk()
    T = prob.T
    e = torch.zeros
    d = NodeDerivs(Fx=e(T, 36, 36), Fu=e(T, 36, 12), Lx=e(T, 36),
                   Lu=e(T, 12), Lxx=e(T, 36, 36), Lxu=e(T, 36, 12),
                   Luu=e(T, 12, 12))
    dT = NodeDerivs(Fx=None, Fu=None, Lx=e(36), Lu=None, Lxx=e(36, 36),
                    Lxu=None, Luu=None)
    with pytest.raises(ValueError, match="cpu"):
        ck.riccati_backward_b1(d, dT, e(T + 1, 36), 1e-9, 1e-9)
    f64 = dict(dtype=torch.float64)
    with pytest.raises(ValueError, match="cpu"):
        ck.trial_rollout_b1(prob.running, e(37, **f64), e(T, 37, **f64),
                            e(T, 12, **f64), e(T, 12, **f64),
                            e(T, 12, 36, **f64), e(T, 36, **f64), 0.5)
    assert [w.launches for w in ck.WRAPPERS] == [0] * 5
    assert ck._lib is None
