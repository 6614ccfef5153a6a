"""Riccati backward pass and trial rollout: the port's plain versions of
kernels 2 and 3 vs the JAX lane functions (``interpret=True``, whose CPU
path is the plain lax.scan), float64 on CPU, on the reduced walk's
derivatives.  Tolerance 1e-10 of each output's max-abs, except the gains k
and K: they solve Quu·k = Qu with cond(Quu) up to ~1e6 on this walk (the
dt=0 switch knots weigh the friction-cone terms against a 1e-3 control
weight), so a last-bit difference in Quu moves them by ~1e-9 of their
max-abs (measured 9e-10 at the warm start); they are held to 1e-8, the
slice's own bar for K and k.  Failure flags equal, including lanes whose
Quu is not positive definite."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import (jax_node_case, jax_walk, max_rel, np_, t64,
                                 to_port)

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")


def _lanes(a, B):
    """(..., K·B) → (K, ..., B)."""
    a = np.asarray(a)
    return np.moveaxis(a.reshape(a.shape[:-1] + (-1, B)), -2, 0)


@pytest.fixture(scope="module")
def riccati_case():
    """Derivatives (T, ..., B) + terminal, gaps, regularizations; lane 0 of
    the second regularization set has a non-PD Quu."""
    from crocoddyl_tpu.core.action import NodeDerivs as JD
    from crocoddyl_tpu_torch.core.action import NodeDerivs as TD
    _, _, _, B, (d_ref, _, _) = jax_node_case()
    d = {f: _lanes(getattr(d_ref, f), B) for f in FIELDS}
    T = d["Fx"].shape[0] - 1
    ndx = d["Fx"].shape[1]
    rng = np.random.default_rng(5)
    fs = 1e-3 * rng.standard_normal((T + 1, ndx, B))
    run = {f: v[:T] for f, v in d.items()}
    jd = (JD(**{f: jnp.asarray(v) for f, v in run.items()}),
          JD(**{f: jnp.asarray(v[T]) for f, v in d.items()}))
    td = (TD(**{f: t64(v) for f, v in run.items()}),
          TD(**{f: t64(v[T]) for f, v in d.items()}))
    return jd, td, fs, B


@pytest.mark.parametrize("nonpd", [False, True])
def test_plain_riccati_matches_jax(riccati_case, nonpd):
    from crocoddyl_tpu.ops import fused_scans as jfs
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    (jd, jterm), (td, tterm), fs, B = riccati_case
    xreg = np.full(B, 1e-9)
    ureg = xreg.copy()
    if nonpd:
        ureg[0] = -1e6
    ref = jfs.riccati_backward_lanes(jd, jterm, jnp.asarray(fs),
                                     jnp.asarray(xreg), jnp.asarray(ureg),
                                     interpret=True)
    out = tfs.riccati_backward_lanes(td, tterm, t64(fs), t64(xreg),
                                     t64(ureg))
    np.testing.assert_array_equal(np.asarray(ref[-1]), np_(out[-1]))
    assert bool(np_(out[-1])[0]) == nonpd
    ok = ~np.asarray(ref[-1])
    names = ("Vx", "Vxx", "Qu", "k", "K", "Quuk")
    for name, a, b in zip(names, ref[:-1], out[:-1]):
        tol = 1e-8 if name in ("k", "K") else 1e-10
        assert max_rel(np.asarray(a)[..., ok], np_(b)[..., ok]) < tol, name


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_plain_rollout_matches_jax(riccati_case, alpha):
    from crocoddyl_tpu.ops import fused_scans as jfs
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    (jd, jterm), (td, tterm), fs, B = riccati_case
    reg = np.full(B, 1e-9)
    _, _, _, k, K, _, _ = jfs.riccati_backward_lanes(
        jd, jterm, jnp.asarray(fs), jnp.asarray(reg), jnp.asarray(reg),
        interpret=True)
    knots, xn, un, _, _ = jax_node_case()
    prob = jax_walk()[0]
    seg = prob.segments[0]
    T = prob.T
    xs = _lanes(xn.T, B)[:T]
    us = _lanes(un.T, B)[:T]
    x0 = xs[0]
    ref = jfs.trial_rollout_lanes(
        seg, jnp.asarray(x0), jnp.asarray(xs), jnp.asarray(us), k, K,
        jnp.asarray(fs[:-1]), jnp.asarray(fs[-1]), alpha, interpret=True)
    out = tfs.trial_rollout_lanes(
        to_port(seg), t64(x0), t64(xs), t64(us), t64(k), t64(K),
        t64(fs[:-1]), t64(fs[-1]), alpha)
    np.testing.assert_array_equal(np.asarray(ref[-1]), np_(out[-1]))
    for a, b in zip(ref[:-1], out[:-1]):
        assert max_rel(a, b) < 1e-10


def test_scan_wrappers_take_plain_versions_on_cpu(riccati_case):
    from crocoddyl_tpu_torch.ops import cuda_kernels
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    _, (td, tterm), fs, B = riccati_case
    before = tfs.riccati_backward_lanes_plain.calls
    reg = torch.full((B,), 1e-9, dtype=torch.float64)
    tfs.riccati_backward_lanes(td, tterm, t64(fs), reg, reg)
    assert tfs.riccati_backward_lanes_plain.calls == before + 1
    assert cuda_kernels.riccati_backward.launches == 0
    assert cuda_kernels.trial_rollout.launches == 0


def test_b1_wrappers_take_plain_versions_on_cpu(riccati_case):
    """The single-problem wrappers send CPU tensors to their plain versions
    (kernels 4 and 5 never launch), and those equal the lane plain versions
    at B=1."""
    from crocoddyl_tpu_torch.ops import cuda_kernels
    from crocoddyl_tpu_torch.ops import fused_scans as tfs
    from crocoddyl_tpu_torch.utils.struct import tree_map
    _, (td, tterm), fs, _ = riccati_case
    one = tree_map(lambda a: a[..., 0].contiguous(), (td, tterm))
    reg = torch.full((1,), 1e-9, dtype=torch.float64)
    before = tfs.riccati_backward_fused_plain.calls
    out = tfs.riccati_backward_fused(*one, t64(fs[..., 0]), 1e-9, 1e-9)
    assert tfs.riccati_backward_fused_plain.calls == before + 1
    lane = tfs.riccati_backward_lanes_plain(
        *tree_map(lambda a: a[..., :1], (td, tterm)), t64(fs[..., :1]), reg,
        reg)
    for a, b in zip(lane, out):
        assert torch.equal(a[..., 0], b)
    prob = to_port(jax_walk()[0])
    T = prob.T
    x0 = prob.x0
    xs = x0[None].expand(T + 1, -1).contiguous()
    us = torch.zeros(T, prob.nu, dtype=torch.float64)
    before = tfs.trial_rollout_fused_plain.calls
    ro = tfs.trial_rollout_fused(prob.running, x0, xs, us, out[3], out[4],
                                 t64(fs[..., 0]), 0.5)
    assert tfs.trial_rollout_fused_plain.calls == before + 1
    assert ro[0].shape == (T, 37) and ro[3].shape == () and ro[4].dtype == \
        torch.bool
    assert cuda_kernels.riccati_backward_b1.launches == 0
    assert cuda_kernels.trial_rollout_b1.launches == 0
