"""PyTorch port vs the JAX package: robot model, state manifold, the walking
problem and its quasi-static warm start (float64, CPU)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import jax_walk, leaves_of, np_, t64, to_port, torch_walk


def test_anymal_arrays_equal_exactly():
    from crocoddyl_tpu.dynamics import robots as jrob
    from crocoddyl_tpu_torch.dynamics import robots as trob
    jm = jrob.anymal(dtype=np.float64)
    tm = trob.anymal(dtype=torch.float64)
    for name in ("joint_types", "parents", "joint_names", "frame_names",
                 "frame_parents"):
        assert getattr(jm, name) == getattr(tm, name), name
    for name in ("jp_R", "jp_p", "axis", "mass", "com", "inertia", "fp_R",
                 "fp_p", "gravity", "q_lb", "q_ub", "v_limit",
                 "effort_limit"):
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      np_(getattr(tm, name)), err_msg=name)
    np.testing.assert_array_equal(np.asarray(jrob.anymal_standing_q(jm)),
                                  np_(trob.anymal_standing_q(tm)))


@pytest.mark.parametrize("fn", ["exp3", "log3", "exp6", "log6", "state",
                                "quat", "so3_jacobians", "se3_jacobians"])
def test_lie_and_state_match(fn):
    """Lie integrate/diff, the quaternion helpers, the SO(3)/SE(3)
    Jacobians and StateMultibody diff/integrate at random (q, dq), to
    1e-12."""
    from crocoddyl_tpu.dynamics import lie as jl
    from crocoddyl_tpu.dynamics.states import StateMultibody as JState
    from crocoddyl_tpu.dynamics import robots as jrob
    from crocoddyl_tpu_torch.dynamics import lie as tl
    from crocoddyl_tpu_torch.dynamics import robots as trob
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody as TState
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 3)) * np.r_[[1e-9] * 4 + [1.0] * 12][:, None]
    xi = rng.standard_normal((16, 6))
    if fn == "exp3":
        pairs = [(jl.exp3(jnp.asarray(w)), tl.exp3(t64(w)))]
    elif fn == "log3":
        R = np.asarray(jl.exp3(jnp.asarray(w)))
        pairs = [(jl.log3(jnp.asarray(R)), tl.log3(t64(R)))]
    elif fn == "exp6":
        pairs = list(zip(jl.exp6(jnp.asarray(xi)), tl.exp6(t64(xi))))
    elif fn == "log6":
        R, p = (np.asarray(a) for a in jl.exp6(jnp.asarray(xi)))
        pairs = [(jl.log6(jnp.asarray(R), jnp.asarray(p)),
                  tl.log6(t64(R), t64(p)))]
    elif fn == "quat":
        qa, qb = (np.asarray(jl.quat_exp(jnp.asarray(a))) for a in (w, w[::-1]))
        pairs = [(jl.quat_exp(jnp.asarray(w)), tl.quat_exp(t64(w))),
                 (jl.quat_mul(jnp.asarray(qa), jnp.asarray(qb)),
                  tl.quat_mul(t64(qa), t64(qb))),
                 (jl.quat_conj(jnp.asarray(qa)), tl.quat_conj(t64(qa))),
                 (jl.quat_identity(), tl.quat_identity())]
    elif fn == "so3_jacobians":
        pairs = [(getattr(jl, f)(jnp.asarray(w)), getattr(tl, f)(t64(w)))
                 for f in ("jac_so3_right", "jac_so3_right_inv")]
        S = np.asarray(jl.skew(jnp.asarray(w)))
        pairs.append((jl.unskew(jnp.asarray(S)), tl.unskew(t64(S))))
    elif fn == "se3_jacobians":
        xi[:4, 3:] *= 1e-9
        R, p = (np.asarray(a) for a in jl.exp6(jnp.asarray(xi)))
        pairs = [(getattr(jl, f)(jnp.asarray(xi)), getattr(tl, f)(t64(xi)))
                 for f in ("jac_se3_left", "jac_se3_right",
                           "jac_se3_right_inv")]
        pairs.append((jl.se3_adjoint(jnp.asarray(R), jnp.asarray(p)),
                      tl.se3_adjoint(t64(R), t64(p))))
        from crocoddyl_tpu.dynamics import spatial as jsp
        from crocoddyl_tpu_torch.dynamics import spatial as tsp
        pairs.append((jsp.Transform(jnp.asarray(R), jnp.asarray(p))
                      .act_force_inv(jnp.asarray(xi)),
                      tsp.Transform(t64(R), t64(p)).act_force_inv(t64(xi))))
        pairs += list(zip(jsp.transform_identity(batch=(2,)),
                          tsp.transform_identity(batch=(2,))))
    else:
        jm, tm = jrob.anymal(dtype=np.float64), trob.anymal()
        js, ts = JState(model=jm), TState(model=tm)
        q0 = np.asarray(jrob.anymal_standing_q(jm))
        x = np.concatenate([q0, np.zeros(jm.nv)])
        dx = 0.3 * rng.standard_normal((8, js.ndx))
        x1 = np.asarray(js.integrate(jnp.asarray(x)[None], jnp.asarray(dx)))
        pairs = [(x1, ts.integrate(t64(x)[None], t64(dx))),
                 (js.diff(jnp.asarray(x)[None], jnp.asarray(x1)),
                  ts.diff(t64(x)[None], t64(x1)))]
    for ja, ta in pairs:
        np.testing.assert_allclose(np_(ta), np.asarray(ja), rtol=0,
                                   atol=1e-12)


def test_walking_problem_leaves_match_jax():
    """The port's factory builds the same problem as the JAX factory, and
    problem_from_numpy carries the JAX problem over leaf for leaf."""
    from crocoddyl_tpu_torch.utils.struct import tree_flatten
    import torch.utils._pytree as pt
    jprob = jax_walk()[0]
    ref = leaves_of(jprob)
    for name, tprob in (("factory", torch_walk()), ("convert",
                                                    to_port(jprob))):
        flat, spec = pt.tree_flatten_with_path(tprob)
        got = {pt.keystr(p): np_(l) for p, l in flat}
        assert set(got) == set(ref), name
        for k, v in ref.items():
            np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                       err_msg=f"{name} {k}")
        assert pt.tree_structure(tprob) == pt.tree_structure(torch_walk())
    assert tree_flatten(to_port(jprob))[1] == tree_flatten(torch_walk())[1]


def test_quasi_static_matches_jax():
    jprob, xs0, us0, _ = jax_walk()
    tprob = torch_walk()
    us_t = tprob.quasi_static(t64(xs0))
    np.testing.assert_allclose(np_(us_t), np.asarray(us0), rtol=0, atol=1e-9)
