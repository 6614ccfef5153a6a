"""The quadruped gait factory of the port against the JAX package, float64
on CPU, at the sizes of tests/test_gaits.py:

- ``robots.quadruped()`` and ``quadruped_standing_q`` equal JAX's exactly;
- the walking, trotting, pacing, bounding, CoM and jumping problems (the
  jump in place and 0.3 m forward), each built by a fresh factory of
  either package, have the same leaves within 1e-12 (problem_from_numpy is not involved: the port builds its own);
- the knots of a jump of ANYmal B (ground, flight with every contact
  inactive, the pseudo-impulse landing and the landed phase) through the
  plain node linearization, held to the JAX lane code at 1e-10 of each
  field's max-abs (xnext and cost 1e-12): the flight knots are the first
  whose contact KKT is M plus a unit block for every contact.
"""

import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import FEET, leaves_of, max_rel, node_case, np_, t64
from tests._torch_parity import to_port

# tests/test_gaits.py:36-48 (the walk at tests/test_gaits.py:55-56), and a
# jump that moves forward, as examples/quadrupedal_gaits.py's does (the
# landing foot tasks and the flight CoM tasks then move horizontally):
# {case: (factory method, arguments, keywords)}
GAITS = {
    "walking": ("walking", (0.1, 0.05, 1e-2),
                dict(step_knots=4, support_knots=1)),
    "trotting": ("trotting", (0.15, 0.1, 1e-2),
                 dict(step_knots=4, support_knots=1)),
    "pacing": ("pacing", (0.15, 0.1, 1e-2),
               dict(step_knots=4, support_knots=1)),
    "bounding": ("bounding", (0.15, 0.1, 1e-2),
                 dict(step_knots=4, support_knots=1)),
    "com": ("com", (0.1, 1e-2), dict(num_knots=3)),
    "jumping": ("jumping", (0.1, [0.0, 0.0, 0.0], 1e-2),
                dict(ground_knots=2, flying_knots=2)),
    "jumping_forward": ("jumping", (0.1, [0.0, 0.3, 0.0], 1e-2),
                        dict(ground_knots=2, flying_knots=2)),
}
ROBOT = ("jp_R", "jp_p", "axis", "mass", "com", "inertia", "fp_R", "fp_p",
         "gravity", "q_lb", "q_ub", "v_limit", "effort_limit")


@functools.lru_cache(maxsize=None)
def _jax_gait(name):
    from crocoddyl_tpu.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = jnp.concatenate([q0, jnp.zeros(m.nv)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=np.asarray(q0))
    method, args, kw = GAITS[name]
    return getattr(fac, f"{method}_problem")(x0, *args, **kw)


def _torch_gait(name):
    from crocoddyl_tpu_torch.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.quadruped()
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    method, args, kw = GAITS[name]
    return getattr(fac, f"{method}_problem")(x0, *args, **kw)


def test_quadruped_robot_equals_jax():
    from crocoddyl_tpu.dynamics import robots as jrob
    from crocoddyl_tpu_torch.dynamics import robots as trob
    jm, tm = jrob.quadruped(), trob.quadruped()
    for name in ("joint_types", "parents", "joint_names", "frame_names",
                 "frame_parents"):
        assert getattr(jm, name) == getattr(tm, name), name
    for name in ROBOT:
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      np_(getattr(tm, name)), err_msg=name)
        assert getattr(tm, name).dtype == torch.float64, name
    for height in (0.5, 0.48):
        np.testing.assert_array_equal(
            np.asarray(jrob.quadruped_standing_q(jm, height=height)),
            np_(trob.quadruped_standing_q(tm, height=height)))


@pytest.mark.parametrize("name", list(GAITS))
def test_gait_problem_leaves_match_jax(name):
    import torch.utils._pytree as pt
    ref = leaves_of(_jax_gait(name))
    prob = _torch_gait(name)
    flat, _ = pt.tree_flatten_with_path(prob)
    got = {pt.keystr(p): np_(l) for p, l in flat}
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
    assert len(prob.segments) == 1 and prob.on_lanes
    assert pt.tree_structure(to_port(_jax_gait(name))) \
        == pt.tree_structure(prob)


def test_jump_knots_plain_linearization_matches_jax():
    """Every knot of a jump of ANYmal B and the dt=0 terminal knot, at
    perturbed (x, u); the 32 flight knots have every contact inactive.  The
    jump has as many nodes (38) as the reduced walk of ``jax_node_case``
    (19 knots, two lanes each), so the JAX lane code's executable is the
    walk's."""
    from crocoddyl_tpu.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    m = robots.anymal(dtype=np.float64)
    q0 = robots.anymal_standing_q(m)
    jump = QuadrupedGaitFactory(m, FEET, default_q=np.asarray(q0))
    jump = jump.jumping_problem(jnp.concatenate([q0, jnp.zeros(m.nv)]),
                                0.15, [0.0, 0.3, 0.0], 1e-2, ground_knots=2,
                                flying_knots=16)
    knots, xn, un, B, (d_ref, x_ref, c_ref) = node_case(jump, 1)
    seg = to_port(knots)
    active = np.stack([np_(c.active) for c in seg.contacts.contacts])
    assert xn.shape[0] == 38 and (active.sum(0) == 0).sum() == 32
    d, xnext, cost = tfn.calc_both_lanes(seg, t64(xn.T), t64(un.T))
    for f in ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu"):
        assert max_rel(getattr(d_ref, f), getattr(d, f)) < 1e-10, f
    assert max_rel(x_ref, xnext) < 1e-12
    assert max_rel(c_ref, cost) < 1e-12
