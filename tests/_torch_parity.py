"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Builds the reduced ANYmal walk in the JAX package exactly as
tests/test_fddp_batch.py does, hands its numbers to the port as numpy
arrays, and compares results.  Not a test module itself.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

FEET = ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"]
B = 3


@functools.lru_cache(maxsize=None)
def jax_walk():
    """(prob, xs0, us0, x0s) of the reduced walk (step_knots=3,
    support_knots=1), B=3 velocity-perturbed initial states from a numpy
    seed — the construction of tests/test_fddp_batch.py:19-36."""
    from crocoddyl_tpu.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    m = robots.anymal(dtype=np.float64)
    q0 = robots.anymal_standing_q(m)
    x0 = jnp.concatenate([q0, jnp.zeros(m.nv)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=np.asarray(q0))
    prob = fac.walking_problem(x0, 0.25, 0.15, 1e-2,
                               step_knots=3, support_knots=1)
    xs0 = jnp.tile(prob.x0[None], (prob.T + 1, 1))
    us0 = jax.jit(prob.quasi_static)(xs0)
    dv = 0.01 * np.random.default_rng(0).standard_normal((B, m.nv))
    x0s = jnp.tile(x0[None], (B, 1)).at[:, prob.state.nq:].add(dv)
    return prob, xs0, us0, x0s


@functools.lru_cache(maxsize=None)
def torch_walk():
    """The same reduced walk built by the port's own factory."""
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.anymal(dtype=torch.float64)
    q0 = robots.anymal_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    return fac.walking_problem(x0, 0.25, 0.15, 1e-2,
                               step_knots=3, support_knots=1)


def describe(obj, path=""):
    """Structure description of a flax-dataclass pytree for
    ``crocoddyl_tpu_torch.io.convert.problem_from_numpy``."""
    if obj is None:
        return None
    if isinstance(obj, tuple):
        return {"tuple": [describe(o, f"{path}[{i}]")
                          for i, o in enumerate(obj)]}
    if dataclasses.is_dataclass(obj):
        static, fields = {}, {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.metadata.get("pytree_node", True):
                fields[f.name] = describe(v, f"{path}.{f.name}")
            else:
                static[f.name] = v
        return {"type": type(obj).__name__, "static": static,
                "fields": fields}
    return {"leaf": path}


def leaves_of(obj):
    """{pytree path: numpy array} of a JAX pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(obj)
    return {jax.tree_util.keystr(p): np.asarray(l) for p, l in flat}


def to_port(obj):
    from crocoddyl_tpu_torch.io.convert import problem_from_numpy
    return problem_from_numpy(leaves_of(obj), describe(obj))


def t64(a):
    return torch.tensor(np.array(a, np.float64))


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def max_rel(a, b):
    """max|a−b| relative to max|a| (the fields' own scale)."""
    a, b = np.asarray(np_(a), np.float64), np.asarray(np_(b), np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300)


def perturbed_nodes(prob, seed=0):
    """Perturbed (xs, us) on the T running knots — the fixture of
    tests/test_fused_node.py:27-44, drawn with numpy."""
    rng = np.random.default_rng(seed)
    T, x0 = prob.T, np.asarray(prob.x0)
    xs = np.tile(x0[None], (T, 1)) + 0.01 * rng.standard_normal((T, x0.size))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=1, keepdims=True)
    us = 0.5 * rng.standard_normal((T, prob.nu))
    return xs, us


def _nodes(rows, B, seed):
    """(K, n) knot rows → (K·B, n) node rows, k-major; lanes b > 0 perturbed."""
    rng = np.random.default_rng(seed)
    out = np.repeat(rows, B, axis=0)
    keep = (np.arange(out.shape[0]) % B != 0)[:, None]
    return out + 1e-3 * rng.standard_normal(out.shape) * keep


@functools.lru_cache(maxsize=None)
def jax_node_case(B=2):
    """The reduced walk's T running knots + the dt=0 terminal knot, B lanes
    per knot at perturbed (x, u), and the JAX lane linearization
    ``calc_both_lanes(..., "jnp")`` of those nodes.
    Returns (knots, xn (K·B, nx), un (K·B, nu), B, (derivs, xnext, cost))."""
    from crocoddyl_tpu.ops import fused_node as jfn
    prob = jax_walk()[0]
    xs, us = perturbed_nodes(prob)
    term = prob.terminal.replace(dt=jnp.zeros_like(prob.terminal.dt))
    knots = jax.tree.map(lambda r, t: jnp.concatenate([r, t[None]]),
                         prob.segments[0], term)
    xs = np.concatenate([xs, xs[-1:]])
    us = np.concatenate([us, np.zeros_like(us[-1:])])
    xn, un = _nodes(xs, B, 1), _nodes(us, B, 2)
    xn[:, 3:7] /= np.linalg.norm(xn[:, 3:7], axis=1, keepdims=True)
    seg_l = jax.tree.map(
        lambda l: jnp.repeat(jnp.moveaxis(l, 0, -1), B, axis=-1), knots)
    lanes = jax.jit(lambda s, x, u: jfn.calc_both_lanes(s, x, u, "jnp"))
    ref = lanes(seg_l, jnp.asarray(xn.T), jnp.asarray(un.T))
    return knots, xn, un, B, ref
