"""The model zoo of the port against the JAX package, float64 on the CPU:
the 6D contact, the CoP and centroidal-momentum costs, the smooth-abs
activation and ``make_bounds``, the multicopter and squashing actuations,
the biped, humanoid and quadrotor robots, ``BipedGaitFactory``, the RH5
analysis (``apps/rh5.py``) and the problems of the biped, humanoid and
quadrotor examples.

- Robots, problem leaves, ``problem_from_numpy`` round trips: exact to
  1e-12 (the factories' forward kinematics round differently by ~1e-18).
- ``Contact6D.calc``/``calc_tangent``, the costs' residuals and
  ``residual_jac_x``, the activation and the actuations (with their
  ``jacfwd``) at random states drawn with numpy: 1e-10 of each quantity's
  max-abs, the JAX side evaluated eagerly in this process.
- The node derivatives (``RigidBodyNode.calc_both`` under ``vmap`` over the
  knots of the biped gaits; ``ShootingProblem.calc_diff_full`` over the
  small CoP walk, the taichi problem and both quadrotors, terminal
  included) at perturbed points: 1e-9.
- The small CoP walk's first FDDP iteration from the quasi-static
  controls: the linearization, the backward pass and the trial at α = 0.25
  held to JAX's pieces at 1e-9 (gains 1e-8).  JAX's ``solve`` itself is
  not run: it takes ~120 s to compile on the biped, so the solve's
  decisions are held on the card to the port's CPU solve instead.
- ``calc_cops``, ``calc_zmps`` and ``log_solution_csv`` on one trajectory
  of the CoP walk fed to both packages: 1e-10, the same CSV header and
  rows.  (JAX's solution is not at hand, for the reason above: the
  trajectory is the perturbed one of the linearization test.)

The JAX references that compile (``jax_reference``) run in child
processes (``start_references``), side by side and beside this module's
eager tests, which come first.  The port's problem builders of
examples/humanoid_taichi.py and examples/quadrotor.py and the CoP walk are
``chip_smoke.py``'s, so what the card runs is what these tests hold.
"""

import csv
import functools
import io
import os
import sys
import types

import numpy as np
import pytest
import torch

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import (REPO, leaves_of, max_rel, reference,
                                 start_references, t64, to_port)

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(REPO, "examples"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
TOL = 1e-9          # node derivatives and solver pieces
TOL_GAIN = 1e-8     # k, K: Quu·k = Qu with a badly conditioned Quu
TOL_UNIT = 1e-10    # contacts, costs, actuations, the RH5 analysis
SOLES = ["right_sole", "left_sole"]
ALPHA = 0.25        # the trial step of the first iteration
ROBOT = ("jp_R", "jp_p", "axis", "mass", "com", "inertia", "fp_R", "fp_p",
         "gravity", "q_lb", "q_ub", "v_limit", "effort_limit")
# {case: (factory method, arguments, keywords)}: small problems of every
# BipedGaitFactory method (the walk with and without the CoP costs)
GAITS = {
    "walking": ("walking", (0.6, 0.1, 0.03),
                dict(step_knots=3, support_knots=1)),
    "walking_cop": ("walking", (0.6, 0.1, 0.03),
                    dict(step_knots=3, support_knots=2)),
    "squat": ("squat", (0.1, 4, 0.03), dict(recovery_knots=2)),
    "balancing": ("balancing", (1, 2, 4, 0.03), {}),
    "jumping": ("jumping", (0.1, [0.3, 0.0, 0.0], 0.03),
                dict(ground_knots=2, flying_knots=2)),
    "com": ("com", (0.05, 0.03), dict(num_knots=2)),
}
# the gaits whose knots (one structure: no CoP cost) share one JAX program
NODE_GAITS = ("walking", "squat", "balancing", "jumping", "com")


# ---------------------------------------------------------------------------
# Builders of both packages
# ---------------------------------------------------------------------------

def _jax_gait(name):
    import bipedal_walk_cop
    from crocoddyl_tpu.apps.gaits import BipedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    m = robots.biped()
    q0 = robots.biped_standing_q(m)
    cls = (bipedal_walk_cop.CoPBipedGaitFactory if name == "walking_cop"
           else BipedGaitFactory)
    method, args, kw = GAITS[name]
    return getattr(cls(m, SOLES, default_q=np.asarray(q0)),
                   f"{method}_problem")(
        jnp.concatenate([q0, jnp.zeros(m.nv)]), *args, **kw)


def _torch_gait(name):
    from crocoddyl_tpu_torch.apps.gaits import BipedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.biped()
    q0 = robots.biped_standing_q(m)
    cls = (chip_smoke.cop_factory() if name == "walking_cop"
           else BipedGaitFactory)
    method, args, kw = GAITS[name]
    return getattr(cls(m, SOLES, default_q=q0), f"{method}_problem")(
        torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)]), *args,
        **kw)


def _jax_example(name):
    """The JAX problem of an example at its own size."""
    import bipedal_jump_cop
    import bipedal_walk_cop
    import humanoid_manipulation
    import humanoid_taichi
    import quadrotor
    from crocoddyl_tpu.apps.gaits import BipedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    if name.startswith("bipedal_walk"):
        m = robots.biped()
        q0 = robots.biped_standing_q(m)
        cop = name == "bipedal_walk_cop"
        cls = bipedal_walk_cop.CoPBipedGaitFactory if cop else \
            BipedGaitFactory
        # examples/bipedal_walk.py:28-35 and bipedal_walk_cop.py:67-72
        return cls(m, SOLES, default_q=np.asarray(q0)).walking_problem(
            np.concatenate([np.asarray(q0), np.zeros(m.nv)]), 0.6, 0.1,
            0.03, step_knots=20 if cop else 35,
            support_knots=9 if cop else 10)
    if name == "bipedal_jump_cop":
        return bipedal_jump_cop.make_problem(forward=True)[0]
    if name == "humanoid_taichi":
        return humanoid_taichi.make_problem()[0]
    if name == "humanoid_manipulation":
        return humanoid_manipulation.make_problem()[0]
    return quadrotor.make_problem(ubound=name == "quadrotor_ubound")


def _torch_manipulation(T=30, dt=2e-2, target=(0.4, 0.2, 1.0)):
    """examples/humanoid_manipulation.py:30-86 from the port's modules."""
    from crocoddyl_tpu_torch import (CostFramePlacement, CostStack,
                                     RigidBodyNode, ShootingProblem,
                                     stack_models)
    from crocoddyl_tpu_torch.dynamics import algorithms as algo
    from crocoddyl_tpu_torch.dynamics import robots
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad, ActivationWeightedQuad)
    from crocoddyl_tpu_torch.models.multibody.actuations import (
        FloatingBaseActuation)
    from crocoddyl_tpu_torch.models.multibody.contacts import (Contact6D,
                                                               ContactSet)
    from crocoddyl_tpu_torch.models.multibody.costs import (CostControl,
                                                            CostState)
    m = robots.humanoid()
    q0 = robots.humanoid_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    oMi, _ = algo.forward_kinematics(m, q0)
    contacts = []
    for f in SOLES:
        M = algo.frame_placement(m, oMi, m.frame_id(f))
        contacts.append(Contact6D(fid=m.frame_id(f), ref_R=M.R, ref_p=M.p,
                                  gains=t64([0.0, 50.0]), active=t64(1.0)))
    sw = np.full(2 * m.nv, 0.01)
    sw[:6] = 10.0
    sw[m.nv:m.nv + 6] = 10.0

    def node(w_goal, dt_):
        costs = CostStack(items=(
            CostFramePlacement(fid=m.frame_id("left_gripper"),
                               ref_R=torch.eye(3, dtype=torch.float64),
                               ref_p=t64(target), activation=ActivationQuad(),
                               weight=t64(w_goal), active=t64(1.0)),
            CostState(xref=x0, activation=ActivationWeightedQuad(
                weights=t64(sw)), weight=t64(1e1), active=t64(1.0)),
            CostControl(uref=torch.zeros(m.nv - 6, dtype=torch.float64),
                        activation=ActivationQuad(), weight=t64(1e-3),
                        active=t64(1.0))))
        return RigidBodyNode(state_=StateMultibody(model=m),
                             actuation=FloatingBaseActuation(nv=m.nv),
                             costs=costs,
                             contacts=ContactSet(contacts=tuple(contacts)),
                             dt=t64(dt_))

    return ShootingProblem(x0=x0, running=stack_models([node(1e2, dt)] * T),
                           terminal=node(1e4, 0.0))


def _torch_example(name):
    if name == "bipedal_walk":
        from crocoddyl_tpu_torch.apps.gaits import BipedGaitFactory
        from crocoddyl_tpu_torch.dynamics import robots
        m = robots.biped()
        q0 = robots.biped_standing_q(m)
        return BipedGaitFactory(m, SOLES, default_q=q0).walking_problem(
            torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)]), 0.6,
            0.1, 0.03, step_knots=35, support_knots=10)
    if name == "bipedal_walk_cop":
        return chip_smoke.cop_walk_problem(torch)[0]
    if name == "bipedal_jump_cop":
        # examples/bipedal_jump_cop.py:44-56 --forward
        from crocoddyl_tpu_torch.dynamics import robots
        m = robots.biped()
        q0 = robots.biped_standing_q(m)
        fac = chip_smoke.cop_factory()(m, SOLES, default_q=q0)
        return fac.jumping_problem(
            torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)]),
            jump_height=0.1, jump_length=[0.3, 0.0, 0.0], dt=3e-2,
            ground_knots=12, flying_knots=8)
    if name == "humanoid_taichi":
        return chip_smoke.taichi_problem(torch)
    if name == "humanoid_manipulation":
        return _torch_manipulation()
    return chip_smoke.quadrotor_problem(torch,
                                        ubound=name == "quadrotor_ubound")


def _torch_leaves(tree):
    import torch.utils._pytree as pt
    flat, _ = pt.tree_flatten_with_path(tree)
    return {pt.keystr(p): l.numpy() for p, l in flat}


def _assert_leaves_equal(ref, got):
    """Equal keys, shapes and values within 1e-12 (infinite bounds equal)."""
    assert set(got) == set(ref), set(got) ^ set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12,
                                   err_msg=k)


def _points(nq, nv, nu, K, seed, base_x, u_scale=0.5):
    """(x (K, nq+nv), u (K, nu)) near ``base_x``, quaternion normalized."""
    rng = np.random.default_rng(seed)
    x = base_x[None] + 0.01 * rng.standard_normal((K, nq + nv))
    x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    return x, u_scale * rng.standard_normal((K, nu))


# ---------------------------------------------------------------------------
# JAX references computed in child processes
# ---------------------------------------------------------------------------

def _small_cop_walk():
    return _jax_gait("walking_cop")


def _jax_problem(job):
    import humanoid_taichi
    import quadrotor
    if job in ("cop", "rh5"):
        return _small_cop_walk()
    if job == "taichi":
        return humanoid_taichi.make_problem(T_phase=2)[0]
    return quadrotor.make_problem(T=4, ubound=job == "quadrotor_ubound")


def _problem_points(prob, seed):
    """Perturbed (xs (T+1, nx), us (T, nu)) around x0; the quadrotor's
    thrusts positive."""
    st = prob.state
    x, u = _points(st.nq, st.nv, prob.nu, prob.T + 1, seed,
                   np.asarray(prob.x0))
    if st.nq == 7:
        u = np.abs(u) * 4.0
    return x, u[:-1]


def jax_reference(job):
    """The JAX side of one job (the child of ``start_references`` calls
    this).  "biped": ``calc_both`` vmapped over the knots of the NODE_GAITS
    problems; "cop", "taichi", "quadrotor", "quadrotor_ubound": the
    problem's linearization (``fddp._calc_diff``: derivatives, gaps, cost)
    at perturbed points; "cop" also the first iteration from the
    quasi-static controls and the RH5 analysis of its trial."""
    from crocoddyl_tpu.core.solvers import fddp
    out = {}
    if job == "biped":
        knots = [_jax_gait(n).running for n in NODE_GAITS]
        knots = jax.tree.map(lambda *ls: jnp.concatenate(ls), *knots)
        K = knots.dt.shape[0]
        st = _jax_gait("walking").state
        x, u = _points(st.nq, st.nv, st.nv - 6, K, 5,
                       np.asarray(_jax_gait("walking").x0))
        d, xn, c = jax.jit(jax.vmap(lambda n, x, u: n.calc_both(x, u)))(
            knots, jnp.asarray(x), jnp.asarray(u))
        out.update(x=x, u=u, xnext=xn, cost=c)
        out.update((f, getattr(d, f)) for f in FIELDS)
        return {k: np.asarray(v) for k, v in out.items()}

    prob = _jax_problem(job)
    lin = jax.jit(lambda xs, us: fddp._calc_diff(prob, xs, us, False))

    def linearize(tag, xs, us):
        d, dterm, fs, cost = lin(jnp.asarray(xs), jnp.asarray(us))
        out.update({f"{tag}.{f}": getattr(d, f) for f in FIELDS})
        out.update({f"{tag}.term.{f}": getattr(dterm, f) for f in FIELDS})
        out.update({f"{tag}.fs": fs, f"{tag}.cost": cost})
        return d, dterm, fs

    xs, us = _problem_points(prob, 3)
    out.update({"pert.xs": xs, "pert.us": us})
    if job == "rh5":
        # the analysis runs eagerly (~55 s here): a job of its own
        from crocoddyl_tpu.apps import rh5
        sol = types.SimpleNamespace(xs=jnp.asarray(xs), us=jnp.asarray(us))
        cops = rh5.calc_cops(prob, sol)
        out["cops.t"] = np.array([r["t"] for r in cops])
        out["cops.idx"] = np.array([r["contact_idx"] for r in cops])
        out["cops.f"] = np.stack([r["f"] for r in cops])
        out["cops.cop"] = np.stack([r["cop"] for r in cops])
        out["zmps"] = rh5.calc_zmps(prob, sol)
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"zoo_rh5_{os.getpid()}.csv")
        rh5.log_solution_csv(prob, sol, path)
        with open(path) as f:
            out["csv"] = np.array(f.read())
        os.remove(path)
        return {k: np.asarray(v) for k, v in out.items()}
    linearize("pert", xs, us)
    if job != "cop":
        return {k: np.asarray(v) for k, v in out.items()}

    xs0 = jnp.tile(prob.x0[None], (prob.T + 1, 1))
    us0 = jax.jit(prob.quasi_static)(xs0)
    out.update({"warm.us": us0, "warm.xs": xs0})
    d, dterm, fs = linearize("warm", xs0, us0)
    Vx, Vxx, Qu, k, K, Quuk, failed = jax.jit(fddp._backward_pass)(
        d, dterm, fs, jnp.asarray(1e-9), jnp.asarray(1e-9))
    out.update({"bp.Vx": Vx, "bp.Vxx": Vxx, "bp.Qu": Qu, "bp.k": k,
                "bp.K": K, "bp.failed": failed})
    xs_t, us_t, cost_t, failed_t = jax.jit(
        lambda k, K: fddp._forward_pass(prob, xs0, us0, k, K, fs, ALPHA))(
        k, K)
    out.update({"trial.xs": xs_t, "trial.us": us_t, "trial.cost": cost_t,
                "trial.failed": failed_t})
    return {k: np.asarray(v) for k, v in out.items()}


JOBS = {job: f"tests.test_torch_model_zoo:jax_reference:{job}"
        for job in ("cop", "rh5", "biped", "taichi", "quadrotor",
                    "quadrotor_ubound")}


@pytest.fixture(scope="module", autouse=True)
def _references(solve_cache):  # noqa: F811
    start_references(JOBS.values(), solve_cache)
    return solve_cache


def _torch_problem(job):
    if job in ("cop", "rh5"):
        return _torch_gait("walking_cop")
    if job == "taichi":
        return chip_smoke.taichi_problem(torch, T_phase=2)
    return chip_smoke.quadrotor_problem(torch, T=4,
                                        ubound=job == "quadrotor_ubound")


# ---------------------------------------------------------------------------
# Robots, factories and example problems (no JAX program)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("robot", ("biped", "humanoid", "quadrotor"))
def test_zoo_robot_equals_jax(robot):
    """Every leaf and static field of the robot, its standing q and the
    quadrotor's thrust map; the widths of the reference."""
    from crocoddyl_tpu.dynamics import robots as jr
    from crocoddyl_tpu_torch.dynamics import robots as tr
    jm, tm = getattr(jr, robot)(), getattr(tr, robot)()
    for name in ("joint_types", "parents", "joint_names", "frame_names",
                 "frame_parents"):
        assert getattr(jm, name) == getattr(tm, name), name
    for name in ROBOT:
        np.testing.assert_array_equal(np.asarray(getattr(jm, name)),
                                      getattr(tm, name).numpy(),
                                      err_msg=name)
        assert getattr(tm, name).dtype == torch.float64, name
    nv, frames = {"biped": (18, ("right_sole", "left_sole")),
                  "humanoid": (27, ("right_sole", "left_sole",
                                    "right_gripper", "left_gripper")),
                  "quadrotor": (6, ("base_link",))}[robot]
    assert tm.nv == nv and all(f in tm.frame_names for f in frames)
    if robot == "quadrotor":
        np.testing.assert_array_equal(jr.quadrotor_tau_f(),
                                      tr.quadrotor_tau_f().numpy())
        return
    stand = f"{robot}_standing_q"
    for height in (0.88, 0.85):
        np.testing.assert_array_equal(
            np.asarray(getattr(jr, stand)(jm, height=height)),
            getattr(tr, stand)(tm, height=height).numpy())


@pytest.mark.parametrize("name", list(GAITS))
def test_biped_gait_leaves_match_jax(name):
    """Each BipedGaitFactory problem, built by a fresh factory of either
    package, has the same leaves and structure; the CoP walk carries a CoP
    cost per foot, active exactly where the foot supports."""
    import torch.utils._pytree as pt
    jp, tp = _jax_gait(name), _torch_gait(name)
    _assert_leaves_equal(leaves_of(jp), _torch_leaves(tp))
    assert pt.tree_structure(to_port(jp)) == pt.tree_structure(tp)
    assert len(tp.segments) == 1 and not tp.on_lanes
    cop = [c for c in tp.running.costs.items
           if type(c).__name__ == "CostContactCoP"]
    assert len(cop) == (2 if name == "walking_cop" else 0)
    for c in cop:
        torch.testing.assert_close(
            c.active, tp.running.contacts.contacts[c.contact_idx].active)


EXAMPLES = ("bipedal_walk", "bipedal_walk_cop", "bipedal_jump_cop",
            "humanoid_taichi", "humanoid_manipulation", "quadrotor",
            "quadrotor_ubound")


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_problem_leaves_match_jax(name):
    """The problem of each biped, humanoid and quadrotor example at the
    example's own size, built from the port's modules, equals JAX's."""
    import torch.utils._pytree as pt
    jp, tp = _jax_example(name), _torch_example(name)
    _assert_leaves_equal(leaves_of(jp), _torch_leaves(tp))
    assert pt.tree_structure(to_port(jp)) == pt.tree_structure(tp)


@pytest.mark.parametrize("name", ("walking_cop", "quadrotor_ubound"))
def test_problem_from_numpy_round_trip(name):
    """``problem_from_numpy`` rebuilds a JAX CoP walk (``CoPSupport``,
    ``Contact6D``, ``CostContactCoP``) and a squashed quadrotor
    (``SquashingActuation`` over ``MultiCopterBaseActuation``) into the
    port's classes with the JAX leaves, and the rebuilt problem computes
    what the port's own does."""
    from crocoddyl_tpu_torch.models.multibody.actuations import (
        MultiCopterBaseActuation, SmoothSatSquashing, SquashingActuation)
    from crocoddyl_tpu_torch.models.multibody.frames import CoPSupport
    jp = _jax_gait(name) if name == "walking_cop" else _jax_example(name)
    own = _torch_gait(name) if name == "walking_cop" else \
        _torch_example(name)
    port = to_port(jp)
    _assert_leaves_equal(leaves_of(jp), _torch_leaves(port))
    if name == "walking_cop":
        sup = [c.support for c in port.running.costs.items
               if hasattr(c, "support")]
        assert sup and all(isinstance(s, CoPSupport) for s in sup)
    else:
        act = port.running.actuation
        assert isinstance(act, SquashingActuation)
        assert isinstance(act.actuation, MultiCopterBaseActuation)
        assert isinstance(act.squashing, SmoothSatSquashing)
    xs = own.x0[None].expand(own.T + 1, -1).clone()
    us = torch.ones((own.T, own.nu), dtype=torch.float64)
    for a, b in zip(port.calc(xs, us), own.calc(xs, us)):
        assert max_rel(a, b) < 1e-12


@pytest.mark.parametrize("method", ("walking", "balancing"))
def test_pseudo_impulse_false_raises(method):
    """The true impulse switch knot is not ported: asking for it raises,
    naming ``ImpulseNode``, and nothing is built in its place."""
    from crocoddyl_tpu_torch.apps.gaits import BipedGaitFactory
    from crocoddyl_tpu_torch.dynamics import robots
    m = robots.biped()
    q0 = robots.biped_standing_q(m)
    fac = BipedGaitFactory(m, SOLES, default_q=q0)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    args = ((x0, 0.6, 0.1, 0.03, 3, 1) if method == "walking"
            else (x0, 1, 2, 4, 0.03))
    with pytest.raises(ValueError, match="ImpulseNode"):
        getattr(fac, f"{method}_problem")(*args, pseudo_impulse=False)


# ---------------------------------------------------------------------------
# Contacts, costs, activations and actuations (JAX evaluated eagerly)
# ---------------------------------------------------------------------------

def _kin_pair(robot, seed):
    """(JAX KinData, port KinData, a (nv,) numpy) at a random state near
    the standing pose."""
    from crocoddyl_tpu.dynamics import algorithms as ja
    from crocoddyl_tpu.dynamics import robots as jr
    from crocoddyl_tpu_torch.dynamics import algorithms as ta
    from crocoddyl_tpu_torch.dynamics import robots as tr
    jm, tm = getattr(jr, robot)(), getattr(tr, robot)()
    q0 = np.asarray(getattr(jr, f"{robot}_standing_q")(jm))
    x, _ = _points(jm.nq, jm.nv, 0, 1, seed,
                   np.concatenate([q0, np.zeros(jm.nv)]))
    x[0, jm.nq:] = np.random.default_rng(seed).standard_normal(jm.nv)
    q, v = x[0, :jm.nq], x[0, jm.nq:]
    a = np.random.default_rng(seed + 1).standard_normal(jm.nv)
    return (ja.KinData(jm, jnp.asarray(q), jnp.asarray(v)),
            ta.KinData(tm, t64(q), t64(v)), a)


GAINS = {"zero": (0.0, 0.0), "taichi": (0.0, 50.0), "stiff": (40.0, 8.0)}


@pytest.mark.parametrize("gains", list(GAINS))
@pytest.mark.parametrize("robot", ("biped", "humanoid"))
def test_contact6d_matches_jax(robot, gains):
    """``Contact6D.calc`` (J, a0) and ``calc_tangent`` at a random state and
    acceleration, against a reference placement off the current one, for
    each sole (and the humanoid's grippers)."""
    from crocoddyl_tpu.dynamics import algorithms as ja
    from crocoddyl_tpu.models.multibody import contacts as jc
    from crocoddyl_tpu.models.multibody.nodes import NodeCache as JCache
    from crocoddyl_tpu_torch.dynamics import algorithms as ta
    from crocoddyl_tpu_torch.models.multibody import contacts as tc
    from crocoddyl_tpu_torch.models.multibody.nodes import NodeCache
    jk, tk, a = _kin_pair(robot, seed=len(robot) + len(gains))
    rng = np.random.default_rng(2)
    for name in tk.model.frame_names:
        fid = tk.model.frame_id(name)
        R = np.asarray(jax.scipy.linalg.expm(jnp.asarray(
            np.cross(np.eye(3), 0.2 * rng.standard_normal(3)))))
        p = rng.standard_normal(3)
        kw = dict(ref_R=R, ref_p=p, gains=GAINS[gains], active=1.0)
        jcon = jc.Contact6D(fid=fid, **{k: jnp.asarray(v)
                                        for k, v in kw.items()})
        tcon = tc.Contact6D(fid=fid, **{k: t64(v) for k, v in kw.items()})
        assert tcon.nc == 6
        got = (*tcon.calc(NodeCache(tk)), tcon.calc_tangent(
            NodeCache(tk), ta.frame_tangents(tk, t64(a), fid)))
        ref = (*jcon.calc(JCache(jk)), jcon.calc_tangent(
            JCache(jk), ja.frame_tangents(jk, jnp.asarray(a), fid)))
        for what, r, g in zip(("J", "a0", "tangent"), ref, got):
            assert max_rel(r, g) < TOL_UNIT, (name, what)


@pytest.mark.parametrize("cost", ("cop", "centroidal"))
@pytest.mark.parametrize("robot", ("biped", "humanoid"))
def test_cost_residual_and_jacobian_match_jax(robot, cost):
    """``CostContactCoP`` (on a 6D wrench and on a 3D force) and
    ``CostCentroidalMomentum``: residual, closed-form ``residual_jac_x`` and
    ``cost_nr``, at a random state with random contact forces."""
    from crocoddyl_tpu.dynamics.states import StateMultibody as JState
    from crocoddyl_tpu.models.multibody import costs as jcs
    from crocoddyl_tpu.models.multibody import frames as jf
    from crocoddyl_tpu.models.multibody.activations import (
        ActivationQuad as JQuad)
    from crocoddyl_tpu.models.multibody.nodes import NodeCache as JCache
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    from crocoddyl_tpu_torch.models.multibody import costs as tcs
    from crocoddyl_tpu_torch.models.multibody import frames as tf
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad)
    from crocoddyl_tpu_torch.models.multibody.nodes import NodeCache
    jk, tk, _ = _kin_pair(robot, seed=7)
    jst, tst = JState(model=jk.model), StateMultibody(model=tk.model)
    rng = np.random.default_rng(4)
    forces = [rng.standard_normal(6), rng.standard_normal(3)]
    jcache = JCache(jk, forces=[jnp.asarray(f) for f in forces])
    tcache = NodeCache(tk, forces=[t64(f) for f in forces])
    x = np.concatenate([np.asarray(jk.q), np.asarray(jk.v)])
    u = rng.standard_normal(tk.model.nv - 6)
    one = dict(weight=1.0, active=1.0)
    pairs = []
    if cost == "cop":
        for idx in (0, 1):
            pairs.append((
                jcs.CostContactCoP(contact_idx=idx,
                                   support=jf.cop_support(0.2, 0.08),
                                   activation=JQuad(),
                                   **{k: jnp.asarray(v)
                                      for k, v in one.items()}),
                tcs.CostContactCoP(contact_idx=idx,
                                   support=tf.cop_support(0.2, 0.08),
                                   activation=ActivationQuad(),
                                   **{k: t64(v) for k, v in one.items()})))
    else:
        href = rng.standard_normal(6)
        pairs.append((
            jcs.CostCentroidalMomentum(href=jnp.asarray(href),
                                       activation=JQuad(),
                                       **{k: jnp.asarray(v)
                                          for k, v in one.items()}),
            tcs.CostCentroidalMomentum(href=t64(href),
                                       activation=ActivationQuad(),
                                       **{k: t64(v) for k, v in one.items()})))
    for jc_, tc_ in pairs:
        assert tcs.cost_nr(tc_, tst) == jcs.cost_nr(jc_, jst) == tc_.nr
        for what, r, g in (
                ("residual", jc_.residual(jst, jcache, jnp.asarray(x),
                                          jnp.asarray(u)),
                 tc_.residual(tst, tcache, t64(x), t64(u))),
                ("residual_jac_x",
                 jc_.residual_jac_x(jst, jcache, jnp.asarray(x),
                                    jnp.asarray(u), None),
                 tc_.residual_jac_x(tst, tcache, t64(x), t64(u), None))):
            assert np.shape(r) == tuple(g.shape), what
            if np.abs(np.asarray(r)).max() == 0.0:
                assert float(g.abs().max()) == 0.0, what
            else:
                assert max_rel(r, g) < TOL_UNIT, what


def test_smooth_abs_and_make_bounds_match_jax():
    """``ActivationSmoothAbs.calc`` at random residuals, and ``make_bounds``
    with finite, one-sided and two-sided infinite bounds (which stay
    infinite) at beta 1 and 0.5."""
    from crocoddyl_tpu.models.multibody import activations as ja
    from crocoddyl_tpu_torch.models.multibody import activations as ta
    r = np.random.default_rng(9).standard_normal(7) * 3.0
    for g, w in zip(ja.ActivationSmoothAbs().calc(jnp.asarray(r)),
                    ta.ActivationSmoothAbs().calc(t64(r))):
        assert max_rel(g, w) < TOL_UNIT
    lb = np.array([-1.0, -np.inf, -2.0, -np.inf, 0.5])
    ub = np.array([1.0, 3.0, np.inf, np.inf, 2.5])
    for beta in (1.0, 0.5):
        for tag, (l, u) in (("numpy", (lb, ub)), ("tensor", (t64(lb),
                                                             t64(ub)))):
            got = ta.make_bounds(l, u, beta)
            ref = ja.make_bounds(lb, ub, beta)
            for r_, g_ in zip(ref, got):
                assert g_.dtype == torch.float64, tag
                np.testing.assert_array_equal(np.asarray(r_), g_.numpy())
    assert np.isinf(ta.make_bounds(lb, ub, 0.5)[0].numpy()[[1, 3]]).all()


def _actuations(pkg):
    """{case: actuation} of one package: the quadrotor's multicopter map,
    the same squashed into [0.1, 5], and a multicopter with two joints."""
    import importlib
    acts = importlib.import_module(f"{pkg}.models.multibody.actuations")
    if pkg == "crocoddyl_tpu":
        from crocoddyl_tpu.dynamics.robots import quadrotor_tau_f
        arr = jnp.asarray
    else:
        from crocoddyl_tpu_torch.dynamics.robots import quadrotor_tau_f
        arr = t64
    tau_f = arr(np.asarray(quadrotor_tau_f()))
    mc = acts.MultiCopterBaseActuation(nv=6, tau_f=tau_f)
    return {
        "multicopter": mc,
        "squashing": acts.SquashingActuation(
            nv=6, actuation=mc, squashing=acts.SmoothSatSquashing(
                s_lb=arr(np.full(4, 0.1)), s_ub=arr(np.full(4, 5.0)),
                smooth=arr(0.1))),
        "multicopter_joints": acts.MultiCopterBaseActuation(nv=8,
                                                            tau_f=tau_f)}


@pytest.mark.parametrize("case", ("multicopter", "squashing",
                                  "multicopter_joints"))
def test_actuations_match_jax(case):
    """τ(x, u) and dτ/du (``jax.jacfwd`` against ``torch.func.jacfwd``, as
    the generic node takes it) at random controls, and ``nu``."""
    ja, ta = _actuations("crocoddyl_tpu")[case], \
        _actuations("crocoddyl_tpu_torch")[case]
    assert ta.nu == ja.nu == (6 if case == "multicopter_joints" else 4)
    rng = np.random.default_rng(12)
    x = rng.standard_normal(2 * ta.nv + 1)
    for _ in range(3):
        u = 6.0 * rng.uniform(-0.5, 1.0, ta.nu)
        assert max_rel(ja.calc(jnp.asarray(x), jnp.asarray(u)),
                       ta.calc(t64(x), t64(u))) < TOL_UNIT
        assert max_rel(
            jax.jacfwd(lambda uu: ja.calc(jnp.asarray(x), uu))(
                jnp.asarray(u)),
            torch.func.jacfwd(lambda uu: ta.calc(t64(x), uu))(t64(u))) \
            < TOL_UNIT


# ---------------------------------------------------------------------------
# Against the JAX references of the child processes
# ---------------------------------------------------------------------------

def test_biped_gait_knots_calc_both_matches_jax(_references):
    """Every knot of the walk, squat, balance, jump (flight knots with both
    contacts inactive) and CoM problems: the generic node's ``calc_both``
    under ``vmap`` at perturbed points."""
    from crocoddyl_tpu_torch.utils.struct import tree_map
    ref = reference(JOBS["biped"], _references)
    knots = tree_map(lambda *ls: torch.cat(ls),
                     *[_torch_gait(n).running for n in NODE_GAITS])
    d, xn, c = torch.func.vmap(lambda m, x, u: m.calc_both(x, u))(
        knots, t64(ref["x"]), t64(ref["u"]))
    got = {f: getattr(d, f) for f in FIELDS}
    got.update(xnext=xn, cost=c)
    for k, g in got.items():
        assert max_rel(ref[k], g) < TOL, k


@pytest.mark.parametrize("job", ("cop", "taichi", "quadrotor",
                                 "quadrotor_ubound"))
def test_problem_linearization_matches_jax(job, _references):
    """``_calc_diff`` (``ShootingProblem.calc_diff_full``: every running
    knot through the generic node, the terminal's ``calc_diff_terminal``,
    the gaps and the cost) at perturbed points: the small CoP walk, the
    taichi problem (Contact6D gains (0, 50), single support) and the
    quadrotor with and without squashing."""
    from crocoddyl_tpu_torch.core.solvers import fddp as tf
    ref = reference(JOBS[job], _references)
    prob = _torch_problem(job)
    assert not prob.on_lanes
    d, dterm, fs, cost = tf._calc_diff(prob, t64(ref["pert.xs"]),
                                       t64(ref["pert.us"]), False)
    for f in FIELDS:
        assert max_rel(ref["pert." + f], getattr(d, f)) < TOL, f
        assert max_rel(ref["pert.term." + f], getattr(dterm, f)) < TOL, f
    assert max_rel(ref["pert.fs"], fs) < TOL
    assert max_rel(ref["pert.cost"], cost) < TOL


@functools.lru_cache(maxsize=None)
def _first_iteration(cache_dir):
    """(JAX arrays, port pieces) of the small CoP walk's first FDDP
    iteration from the quasi-static controls: the linearization, the
    backward pass at regularization 1e-9 and the trial at ALPHA."""
    from crocoddyl_tpu_torch.core.solvers import fddp as tf
    ref = reference(JOBS["cop"], cache_dir)
    prob = _torch_problem("cop")
    xs0 = prob.x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)
    d, dterm, fs, cost = tf._calc_diff(prob, xs0, us0, False)
    reg = torch.tensor(1e-9, dtype=torch.float64)
    Vx, Vxx, Qu, k, K, _, failed = tf._backward_pass(d, dterm, fs, reg, reg)
    xs_t, us_t, cost_t, failed_t = tf._forward_pass(prob, xs0, us0, k, K,
                                                    fs, [ALPHA])
    port = dict(us0=us0, d=d, dterm=dterm, fs=fs, cost=cost, Vx=Vx,
                Vxx=Vxx, Qu=Qu, k=k, K=K, failed=failed, xs_t=xs_t[0],
                us_t=us_t[0], cost_t=cost_t[0], failed_t=failed_t[0])
    return ref, port


@pytest.mark.parametrize("piece", ("linearization", "backward_pass",
                                   "trial"))
def test_cop_walk_first_iteration_matches_jax(piece, _references):
    """The CoP walk (step_knots=3, support_knots=2, T=12) from the
    quasi-static controls: the quasi-static controls and the
    linearization, the backward pass (no failure) and the trial rollout at
    α = ALPHA (finite, its cost below the warm start's)."""
    ref, p = _first_iteration(_references)
    if piece == "linearization":
        assert max_rel(ref["warm.us"], p["us0"]) < TOL
        for f in FIELDS:
            assert max_rel(ref["warm." + f], getattr(p["d"], f)) < TOL, f
            assert max_rel(ref["warm.term." + f],
                           getattr(p["dterm"], f)) < TOL, f
        # the gaps of the quasi-static start are ~1e-8: held to the states'
        # scale, as tests/test_torch_solve.py holds them
        err = np.abs(ref["warm.fs"] - p["fs"].numpy()).max()
        assert err < TOL * np.abs(ref["warm.xs"]).max(), err
        assert max_rel(ref["warm.cost"], p["cost"]) < TOL
    elif piece == "backward_pass":
        assert not bool(ref["bp.failed"]) and not bool(p["failed"])
        for f in ("Vx", "Vxx", "Qu"):
            assert max_rel(ref["bp." + f], p[f]) < TOL, f
        for f in ("k", "K"):
            assert max_rel(ref["bp." + f], p[f]) < TOL_GAIN, f
    else:
        assert not bool(ref["trial.failed"]) and not bool(p["failed_t"])
        assert float(p["cost_t"]) < float(p["cost"])
        for f, g in (("xs", p["xs_t"]), ("us", p["us_t"]),
                     ("cost", p["cost_t"])):
            assert max_rel(ref["trial." + f], g) < TOL_GAIN, f


@pytest.mark.parametrize("what", ("cops", "zmps", "csv"))
def test_rh5_analysis_matches_jax(what, _references, tmp_path):
    """``calc_cops``, ``calc_zmps`` and ``log_solution_csv`` of the port and
    of JAX on one trajectory of the CoP walk (the perturbed points of
    ``_problem_points``: moving, both feet loaded on the support knots);
    several segments are refused."""
    from crocoddyl_tpu_torch.apps import rh5
    ref = reference(JOBS["rh5"], _references)
    prob = _torch_problem("rh5")
    sol = types.SimpleNamespace(xs=t64(ref["pert.xs"]),
                                us=t64(ref["pert.us"]))
    if what == "cops":
        cops = rh5.calc_cops(prob, sol)
        assert [r["t"] for r in cops] == ref["cops.t"].tolist()
        assert [r["contact_idx"] for r in cops] == ref["cops.idx"].tolist()
        assert max_rel(ref["cops.f"], np.stack([r["f"] for r in cops])) \
            < TOL_UNIT
        assert max_rel(ref["cops.cop"],
                       np.stack([r["cop"] for r in cops])) < TOL_UNIT
        # chip_smoke.cop_in_support: the worst A·f of the CoP costs, which
        # are active exactly on the supporting feet, from JAX's wrenches
        A = next(c.support.A[0] for c in prob.running.costs.items
                 if type(c).__name__ == "CostContactCoP").numpy()
        want = min(0.0, float((ref["cops.f"] @ A.T).min()))
        assert abs(chip_smoke.cop_in_support(prob, sol) - want) \
            < TOL_UNIT * np.abs(ref["cops.f"]).max()
        with pytest.raises(ValueError, match="segments"):
            rh5.calc_cops(prob.replace(running=(prob.running,
                                                prob.running)), sol)
    elif what == "zmps":
        zmps = rh5.calc_zmps(prob, sol)
        assert zmps.shape == (prob.T, 3)
        assert max_rel(ref["zmps"], zmps) < TOL_UNIT
    else:
        path = rh5.log_solution_csv(prob, sol, str(tmp_path / "log.csv"))
        with open(path) as f:
            got = list(csv.reader(f))
        want = list(csv.reader(io.StringIO(str(ref["csv"]))))
        assert got[0] == want[0] and len(got) == len(want) == prob.T + 1
        g = np.array(got[1:], dtype=np.float64)
        w = np.array(want[1:], dtype=np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        assert max_rel(np.nan_to_num(w), np.nan_to_num(g)) < TOL_UNIT
