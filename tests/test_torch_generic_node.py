"""The generic ``RigidBodyNode`` of the port (closed-form derivatives
outside the node kernel) and the per-stack dispatch of
``ShootingProblem.calc_diff_full``, float64 on the CPU.

- The node's ``calc_both``, ``calc_diff_terminal`` and ``calc`` against
  the JAX package's generic ``RigidBodyNode`` at random (x, u) drawn with
  numpy, for five structures: the arm of examples/arm_manipulation.py
  (armature, FramePlacement), the double pendulum of
  examples/double_pendulum.py (a user ``Actuation`` that defines only
  ``calc``), ANYmal B on three feet with one cost of each type of the
  walk's knots (a friction cone among them) and a FrameRotation cost, the
  double pendulum as an RK4
  node, and the contact knot as a dt=0 knot.  One jitted JAX function
  (vmapped over the points) serves every structure; tolerance 1e-9 of each
  field's max-abs.
- The generic path against the node kernel's plain version on every knot
  of the reduced walk (no JAX): 1e-9.
- A problem with one stack the kernel admits and one it does not: the
  admitted stack keeps the lane path, and the derivatives equal the
  all-generic evaluation (1e-9).
- The rigid-body algorithms and state Jacobians the node rests on
  (``gforce_derivatives`` with and without external wrenches,
  ``frame_tangents``, ``kin_tangent_basis``, ``aba``/``crba``/
  ``nonlinear_effects``/``gravity_torque``, ``centroidal_momentum``,
  ``jintegrate``/``jdiff``) on the double pendulum, the 7-DoF arm and the
  programmatic quadruped (tests/test_gforce_derivs.py:29-60 picks the same
  three) at random (q, v, a) and wrenches: 1e-10 of each quantity's
  max-abs, one jitted JAX function per robot.
- The slice as a whole: the port's ``solve`` of examples/arm_manipulation.py
  to its golden with the bar of tests/test_examples_golden.py:51-60, and of
  examples/double_pendulum.py against the JAX ``solve`` for one iteration
  (same decisions, cost rtol 1e-9; its golden is not a rounding-stable
  anchor, see ``test_double_pendulum_first_iteration_matches_jax``).

The JAX references run in child processes (``start_references``), side by
side and beside this module's port-only tests, which come first."""

import functools
import json
import os
import sys

import numpy as np
import pytest
import torch

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import (FEET, REPO, describe, leaves_of,
                                 max_rel, perturbed_nodes, reference,
                                 start_references, t64, to_port, torch_walk)

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(REPO, "examples"))

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
TOL = 1e-9          # node derivatives: the same closed forms, other sums
TOL_ALGO = 1e-10    # the algorithms and the state Jacobians
POINTS = 2
ROBOTS = ("double_pendulum", "arm7", "quadruped")
ARGS = ("q", "v", "a", "fext", "ext_w", "x1", "dx", "jac")


def _port_actuation():
    from crocoddyl_tpu_torch.models.multibody.actuations import Actuation

    class SecondJointActuation(Actuation):
        """Only the second joint is actuated; ``calc`` only."""

        @property
        def nu(self) -> int:
            return 1

        def calc(self, x, u):
            return torch.cat([u.new_zeros(1), u])
    return SecondJointActuation


PORT_CLASSES = {"SecondJointActuation": _port_actuation()}


def _standing_x():
    """ANYmal B standing at rest: the reduced walk's x0."""
    from crocoddyl_tpu.dynamics import robots
    m = robots.anymal(dtype=np.float64)
    return np.concatenate([np.asarray(robots.anymal_standing_q(m)),
                           np.zeros(m.nv)])


def _knot(prob, t):
    return jax.tree.map(lambda l: l[t], prob.running)


def _jax_nodes(name):
    """{structure: JAX node} of the reference job ``name``: "contact" is
    the contact knot and its dt=0 twin (one executable)."""
    import arm_manipulation
    import double_pendulum
    from crocoddyl_tpu.models.multibody.activations import ActivationQuad
    from crocoddyl_tpu.models.multibody.costs import CostFrameRotation
    from crocoddyl_tpu.models.multibody.nodes import CostStack, RigidBodyNode
    if name == "arm":
        return {name: _knot(arm_manipulation.make_problem(T=2)[0], 0)}
    dp = _knot(double_pendulum.make_problem(T=2), 0)
    if name == "double_pendulum":
        return {name: dp}
    if name == "rk4":
        return {name: dp.replace(integrator="rk4")}
    # ANYmal B on three of its four feet (the fourth contact inactive),
    # with one cost of each type of the walk's knots, a friction cone
    # among them, and a FrameRotation cost
    from crocoddyl_tpu.dynamics import robots
    from crocoddyl_tpu.dynamics.states import StateMultibody
    from crocoddyl_tpu.models.multibody.activations import (
        ActivationQuadraticBarrier, ActivationWeightedQuad)
    from crocoddyl_tpu.models.multibody.actuations import (
        FloatingBaseActuation)
    from crocoddyl_tpu.models.multibody.contacts import Contact3D, ContactSet
    from crocoddyl_tpu.models.multibody.costs import (
        CostCoM, CostContactFrictionCone, CostControl, CostFrameTranslation,
        CostFrameVelocity, CostState)
    from crocoddyl_tpu.models.multibody.frames import friction_cone
    m = robots.anymal(dtype=np.float64)
    fids = [m.frame_id(f) for f in FEET]
    rng = np.random.default_rng(11)
    cone = friction_cone((0.0, 0.0, 1.0), 0.7, nf=4, inner_appr=False)

    def w(v):
        return jnp.asarray(v)
    x_ref = _standing_x() + 0.01 * rng.standard_normal(m.nq + m.nv)
    items = (
        CostCoM(cref=w(rng.standard_normal(3)), activation=ActivationQuad(),
                weight=w(1e2), active=w(1.0)),
        CostFrameTranslation(fid=fids[3], pref=w(rng.standard_normal(3)),
                             activation=ActivationQuad(), weight=w(1e3),
                             active=w(1.0)),
        CostFrameVelocity(fid=fids[3], vref=w(np.zeros(6)),
                          activation=ActivationQuad(), weight=w(1e2),
                          active=w(1.0)),
        CostContactFrictionCone(
            contact_idx=1, cone=cone, activation=ActivationQuadraticBarrier(
                lb=cone.lb, ub=cone.ub), weight=w(1e1), active=w(1.0)),
        CostState(xref=w(x_ref), activation=ActivationWeightedQuad(
            weights=w(rng.uniform(0.5, 2.0, 2 * m.nv))), weight=w(1e1),
            active=w(1.0)),
        CostControl(uref=w(np.zeros(m.nv - 6)), activation=ActivationQuad(),
                    weight=w(1e-1), active=w(1.0)),
        CostFrameRotation(fid=fids[0], ref_R=w(np.diag([1.0, -1.0, -1.0])),
                          activation=ActivationQuad(), weight=w(0.7),
                          active=w(1.0)))
    contacts = ContactSet(contacts=tuple(
        Contact3D(fid=f, pref=w(np.zeros(3)), gains=w([0.0, 50.0]),
                  active=w(0.0 if i == 3 else 1.0))
        for i, f in enumerate(fids)))
    contact = RigidBodyNode(
        state_=StateMultibody(model=m), actuation=FloatingBaseActuation(
            nv=m.nv), costs=CostStack(items=items), contacts=contacts,
        dt=w(1e-2))
    return {"contact": contact,
            "dt0": contact.replace(dt=jnp.zeros_like(contact.dt))}


def _points(node, seed):
    """(x (P, nx), u (P, nu)) near the walk's x0 for a contact node (a
    well-posed contact KKT), random otherwise."""
    rng = np.random.default_rng(seed)
    st = node.state_
    nq, nv, nu = st.nq, st.nv, node.actuation.nu
    if node.contacts is not None:
        x = _standing_x()[None] + 0.01 * rng.standard_normal(
            (POINTS, nq + nv))
        x[:, 3:7] /= np.linalg.norm(x[:, 3:7], axis=1, keepdims=True)
    else:
        x = np.concatenate([rng.uniform(-1.0, 1.0, (POINTS, nq)),
                            rng.standard_normal((POINTS, nv))], 1)
    return x, rng.standard_normal((POINTS, nu))


def jax_reference(job):
    """The JAX side of one job (the child of ``start_references`` calls
    this): for each structure of ``_jax_nodes(job)``, "<structure>/" +
    its leaves and structure, the points, and (calc_both,
    calc_diff_terminal, calc) at them, one jitted function vmapped over
    the points.  The contact knot, the longest to compile, is split in two
    jobs: "contact_both" (calc_both, calc) and "contact_term"
    (calc_diff_terminal).  Job "solve" is the JAX ``solve`` of
    examples/double_pendulum.py for one iteration."""
    import double_pendulum
    if job == "solve":
        import crocoddyl_tpu as ct
        sol = ct.solve(double_pendulum.make_problem(),
                       settings=ct.SolverSettings(maxiter=1))
        return {f: np.asarray(getattr(sol, f)) for f in (
            "iter", "steplength", "xreg", "is_feasible", "converged",
            "cost")}

    both = job != "contact_term"
    term = job != "contact_both"

    def f(node, x, u):
        return (node.calc_both(x, u) if both else None,
                node.calc_diff_terminal(x) if term else None,
                node.calc(x, u) if both else None)
    methods = jax.jit(jax.vmap(f, in_axes=(None, 0, 0)))
    out = {}
    for name, jn in _jax_nodes(job.replace("contact_both", "contact")
                               .replace("contact_term", "contact")).items():
        x, u = _points(jn, seed=len(name))
        d, dterm, calc = methods(jn, jnp.asarray(x), jnp.asarray(u))
        res = {"x": x, "u": u,
               "structure": np.array(json.dumps(describe(jn)))}
        res.update(("leaf" + k, a) for k, a in leaves_of(jn).items())
        if both:
            res.update({"both.xnext": d[1], "both.cost": d[2],
                        "calc.xnext": calc[0], "calc.cost": calc[1]})
            res.update(("both." + fld, getattr(d[0], fld))
                       for fld in FIELDS)
        if term:
            res.update(("term." + fld, getattr(dterm, fld))
                       for fld in FIELDS)
        if name == "double_pendulum":
            res["quasi_static"] = jn.quasi_static(jnp.asarray(x[0]))
        out.update((f"{name}/{k}", np.asarray(a)) for k, a in res.items())
    return out


STRUCTURES = ("arm", "double_pendulum", "contact", "rk4", "dt0")
JOBS = {job: f"tests.test_torch_generic_node:jax_reference:{job}"
        for job in ("contact_both", "contact_term", "arm", "rk4",
                    "double_pendulum", "solve")}
JOBS.update((f"algorithms_{r}",
             f"tests.test_torch_generic_node:jax_algorithms_reference:{r}")
            for r in ROBOTS)


@pytest.fixture(scope="module", autouse=True)
def _references(solve_cache):  # noqa: F811
    start_references(JOBS.values(), solve_cache)
    return solve_cache


@functools.lru_cache(maxsize=None)
def _case(name, cache_dir):
    """(JAX arrays of structure ``name``, port node)."""
    from crocoddyl_tpu_torch.io.convert import problem_from_numpy
    jobs = (("contact_both", "contact_term") if name in ("contact", "dt0")
            else (name,))
    ref = {k.split("/", 1)[1]: a for job in jobs
           for k, a in reference(JOBS[job], cache_dir).items()
           if k.startswith(name + "/")}
    leaves = {k[4:]: a for k, a in ref.items() if k.startswith("leaf")}
    node = problem_from_numpy(leaves, json.loads(str(ref["structure"])),
                              classes=PORT_CLASSES)
    return ref, node


# ---------------------------------------------------------------------------
# The generic path against the node kernel's plain version (no JAX)
# ---------------------------------------------------------------------------

def _walk_points(prob):
    xs, us = perturbed_nodes(prob)
    return (t64(np.concatenate([xs, xs[-1:]])),
            t64(np.concatenate([us, np.zeros_like(us[-1:])])))


@functools.lru_cache(maxsize=None)
def _walk_generic_vs_lanes():
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    prob = torch_walk()
    knots = prob.knots                     # T running knots + dt=0 terminal
    X, U = _walk_points(prob)
    gen = torch.func.vmap(lambda m, x, u: m.calc_both(x, u))(knots, X, U)
    lane = tfn.calc_both_lanes_plain(knots, X.T.contiguous(),
                                     U.T.contiguous())
    return gen, lane


@pytest.mark.parametrize("field", FIELDS + ("xnext", "cost"))
def test_generic_path_matches_kernel_plain_on_walk(field):
    """Every knot of the reduced walk and its dt=0 terminal: the generic
    node's ``calc_both`` under ``vmap`` against ``calc_both_lanes_plain``
    (the node kernel's plain version)."""
    (gd, gx, gc), (ld, lx, lc) = _walk_generic_vs_lanes()
    if field == "xnext":
        g, l = gx, lx.T
    elif field == "cost":
        g, l = gc, lc
    else:
        g, l = getattr(gd, field), getattr(ld, field).movedim(-1, 0)
    assert max_rel(l, g) < TOL


class _count_lanes:
    """Within the block, every call of ``fused_node.calc_both_lanes`` is
    recorded with its node count."""

    def __enter__(self):
        from crocoddyl_tpu_torch.ops import fused_node as tfn
        self.mod, self.orig, self.calls = tfn, tfn.calc_both_lanes, []

        def rec(seg, x_l, u_l):
            self.calls.append(x_l.shape[-1])
            return self.orig(seg, x_l, u_l)
        tfn.calc_both_lanes = rec
        return self

    def __exit__(self, *exc):
        self.mod.calc_both_lanes = self.orig


def _mixed_problems():
    """The reduced walk with a FramePlacement cost on its terminal (running
    stack admitted, terminal generic), and with a FrameRotation cost on
    every running knot (running generic, terminal admitted)."""
    from crocoddyl_tpu_torch.models.multibody.activations import (
        ActivationQuad)
    from crocoddyl_tpu_torch.models.multibody.costs import (
        CostFramePlacement, CostFrameRotation)
    from crocoddyl_tpu_torch.models.multibody.nodes import CostStack
    prob = torch_walk()
    T, term = prob.T, prob.terminal
    fid = term.contacts.contacts[1].fid
    one = torch.tensor(1.0, dtype=torch.float64)
    place = CostFramePlacement(
        fid=fid, ref_R=torch.eye(3, dtype=torch.float64),
        ref_p=torch.tensor([0.3, 0.2, 0.0], dtype=torch.float64),
        activation=ActivationQuad(), weight=one, active=one)
    run = prob.running
    rot = CostFrameRotation(
        fid=fid, ref_R=torch.eye(3, dtype=torch.float64).expand(T, 3, 3),
        activation=ActivationQuad(), weight=one.expand(T),
        active=one.expand(T))
    return {
        "generic_terminal": prob.replace(terminal=term.replace(
            costs=CostStack(items=term.costs.items + (place,)))),
        "generic_running": prob.replace(running=run.replace(
            costs=CostStack(items=run.costs.items + (rot,))))}


@pytest.mark.parametrize("case", ("generic_terminal", "generic_running"))
def test_mixed_problem_keeps_kernel_on_admitted_stack(case):
    """Dispatch per stack: the stack the node kernel admits goes through
    ``calc_both_lanes`` (the T running knots in one call, or the terminal
    as one dt=0 knot), the other one through the generic node; the
    derivatives, gaps' xnext and costs equal the all-generic evaluation."""
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    prob = _mixed_problems()[case]
    T = prob.T
    assert not prob.on_lanes
    assert tfn.supports(prob.running) == (case == "generic_terminal")
    X, U = _walk_points(prob)
    xs, us = X, U[:T]
    with _count_lanes() as lanes:
        d, dterm, xn, costs = prob.calc_diff_full(xs, us)
    assert lanes.calls == ([T] if case == "generic_terminal" else [1])
    gd, gx, gc = torch.func.vmap(lambda m, x, u: m.calc_both(x, u))(
        prob.running, xs[:T], us)
    gterm = prob.terminal.calc_diff_terminal(xs[-1])
    for f in FIELDS:
        assert max_rel(getattr(gd, f), getattr(d, f)) < TOL, f
        assert max_rel(getattr(gterm, f), getattr(dterm, f)) < TOL, f
    assert max_rel(gx, xn) < TOL
    assert max_rel(torch.cat([gc, prob.terminal.calc_terminal(xs[-1])[None]]),
                   costs) < TOL


def test_admitted_problem_keeps_one_linearization():
    """A problem whose two stacks the kernel admits: one ``calc_both_lanes``
    call of T+1 nodes, as before."""
    prob = torch_walk()
    X, U = _walk_points(prob)
    with _count_lanes() as lanes:
        prob.calc_diff_full(X, U[:prob.T])
    assert prob.on_lanes and lanes.calls == [prob.T + 1]


def test_solver_gates():
    """``solve`` takes every single-segment problem of ``RigidBodyNode``s
    and ``ActionModel``s; ``solve_batch`` and kernels 4/5 keep their gates
    (every node admitted by the kernel)."""
    from crocoddyl_tpu_torch import SolverSettings
    from crocoddyl_tpu_torch.core.solvers import fddp, fddp_batch
    from crocoddyl_tpu_torch.ops import fused_scans
    import double_pendulum
    dp = to_port(double_pendulum.make_problem(T=3), PORT_CLASSES)
    batch = SolverSettings(maxiter=1, record_trace=False,
                           parallel_linesearch=False)
    for p in (dp,) + tuple(_mixed_problems().values()):
        assert fddp.supports(p, SolverSettings())
        assert not fddp_batch.supports(p, batch)
    assert not fused_scans.supports_problem(dp, SolverSettings())
    assert fddp_batch.supports(torch_walk(), batch)


# ---------------------------------------------------------------------------
# The slice as a whole
# ---------------------------------------------------------------------------

def _golden(name):
    with open(os.path.join(REPO, "tests", "golden.json")) as f:
        return json.load(f)[name]


def test_arm_manipulation_solve_matches_golden():
    """examples/arm_manipulation.py (T=250, DDP, maxiter=100) solved by the
    port on the CPU in float64 through the generic node and the generic
    passes, held to its golden with the bar of
    tests/test_examples_golden.py:51-60."""
    import arm_manipulation
    from crocoddyl_tpu_torch import ddp_settings, solve
    from crocoddyl_tpu_torch.ops import cuda_kernels as ck
    from crocoddyl_tpu_torch.ops import fused_node as tfn
    prob = to_port(arm_manipulation.make_problem()[0])
    before = tfn.calc_both_lanes_plain.calls
    sol = solve(prob, settings=ddp_settings(maxiter=100), device="cpu")
    assert tfn.calc_both_lanes_plain.calls == before
    assert all(w.launches == 0 for w in ck.WRAPPERS)
    g = _golden("arm_manipulation")
    assert bool(sol.converged) == g["converged"]
    assert abs(int(sol.iter) - g["iters"]) <= 1, (int(sol.iter), g["iters"])
    np.testing.assert_allclose(float(sol.cost), g["cost"], rtol=1e-5)


# ---------------------------------------------------------------------------
# Against the JAX package (references from the child processes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ("calc_both", "calc_diff_terminal",
                                    "calc"))
@pytest.mark.parametrize("name", STRUCTURES)
def test_generic_node_matches_jax(name, method, _references):
    ref, node = _case(name, _references)
    for i in range(POINTS):
        x, u = t64(ref["x"][i]), t64(ref["u"][i])
        if method == "calc_both":
            d, xn, c = node.calc_both(x, u)
            got = {f: getattr(d, f) for f in FIELDS}
            got.update(xnext=xn, cost=c)
            want = {k: ref["both." + k][i] for k in got}
        elif method == "calc_diff_terminal":
            d = node.calc_diff_terminal(x)
            got = {f: getattr(d, f) for f in FIELDS}
            want = {k: ref["term." + k][i] for k in got}
        else:
            xn, c = node.calc(x, u)
            got = dict(xnext=xn, cost=c)
            want = {k: ref["calc." + k][i] for k in got}
        for k in got:
            err = max_rel(want[k], got[k])
            assert err < TOL, (k, i, err)


def test_generic_node_is_an_action_model_with_user_actuation(_references):
    """The port's node is an ``ActionModel``; a user ``Actuation`` that
    defines only ``calc`` drives it, ``quasi_static`` included (its dτ/du
    by ``jacfwd``), equal to the JAX node's."""
    from crocoddyl_tpu_torch.core.action import ActionModel
    ref, node = _case("double_pendulum", _references)
    assert isinstance(node, ActionModel)
    assert type(node.actuation).__name__ == "SecondJointActuation"
    assert max_rel(ref["quasi_static"],
                   node.quasi_static(t64(ref["x"][0]))) < TOL


def test_double_pendulum_first_iteration_matches_jax(_references):
    """examples/double_pendulum.py: the port's first FDDP iteration (default
    settings, the user actuation) against the JAX package's: same step,
    regularization and feasibility, cost rtol 1e-9.

    Its golden (38 iterations, cost 1.8559) is not held here: that solve
    turns rounding-level differences into another local minimum.  The JAX
    package's own solve started 1e-15 away (joint 1's velocity) takes 68
    iterations to cost 2.39, and 1e-13 away 98 iterations to 1.70
    (golden_sensitivity.py), so a solve that does not reproduce the JAX
    program's rounding bit for bit ends elsewhere."""
    import double_pendulum
    from crocoddyl_tpu_torch import SolverSettings, solve
    ref = reference(JOBS["solve"], _references)
    sol = solve(to_port(double_pendulum.make_problem(), PORT_CLASSES),
                settings=SolverSettings(maxiter=1), device="cpu")
    for f in ("iter", "steplength", "xreg", "is_feasible", "converged"):
        assert float(ref[f]) == float(getattr(sol, f)), f
    assert abs(float(sol.cost) / float(ref["cost"]) - 1.0) < 1e-9


# ---------------------------------------------------------------------------
# The rigid-body algorithms and state Jacobians against the JAX package
# ---------------------------------------------------------------------------

def _point(rng, nq, nv, ff):
    q = rng.uniform(-1.0, 1.0, nq)
    if ff:
        q[3:7] /= np.linalg.norm(q[3:7])
    return q, rng.standard_normal(nv)


def _quantities(algo, st, m, kd, q, v, a, fext, ext_w, x0, x1, dx, jac):
    """Every compared quantity of one point, the same code for both
    packages (``algo``: their algorithms module)."""
    out = {}
    out["gforce_q"], out["gforce_v"] = algo.gforce_derivatives(kd, a)
    out["gforce_ext_q"], out["gforce_ext_v"] = algo.gforce_derivatives(
        kd, a, ext_w)
    fid = m.nframes - 1
    ft = algo.frame_tangents(kd, a, fid)
    for f in ft._fields:
        out["frame_tangents." + f] = getattr(ft, f)
    tb = algo.kin_tangent_basis(kd)
    for f in tb._fields:
        out["kin_tangent_basis." + f] = getattr(tb, f)
    out["aba"] = algo.aba(m, q, v, a, fext)
    out["crba"] = algo.crba(m, q)
    out["nonlinear_effects"] = algo.nonlinear_effects(m, q, v)
    out["gravity_torque"] = algo.gravity_torque(m, q)
    out["mass_matrix_vec"] = kd.mass_matrix_vec(a)
    out["centroidal_momentum"] = algo.centroidal_momentum(m, q, v)
    out["com_velocity"] = kd.com_velocity(a)
    out["frame_jacobian_world"] = algo.frame_jacobian(m, q, fid, "world")
    out["frame_jacobian_aligned"] = algo.frame_jacobian(
        m, q, fid, "local_world_aligned")
    out["jintegrate_x"], out["jintegrate_dx"] = st.jintegrate(x0, dx)
    out["jdiff_0"], out["jdiff_1"] = st.jdiff(x0, x1)
    out["jintegrate_transport"] = st.jintegrate_transport(x0, dx, jac,
                                                          "second")
    return out


def jax_algorithms_reference(robot):
    """The inputs ("in.<name>") and the JAX references ("ref.<name>",
    leading axis POINTS) of the algorithms on one robot: the child of
    ``start_references`` calls this."""
    from crocoddyl_tpu.dynamics import algorithms as ja
    from crocoddyl_tpu.dynamics import robots as jr
    from crocoddyl_tpu.dynamics.states import StateMultibody
    m = getattr(jr, robot)()
    st = StateMultibody(model=m)
    ff = m.joint_types[0] == 0
    rng = np.random.default_rng(7)
    rows = []
    for _ in range(POINTS):
        q, v = _point(rng, m.nq, m.nv, ff)
        q1, v1 = _point(rng, m.nq, m.nv, ff)
        rows.append(dict(q=q, v=v, a=rng.standard_normal(m.nv),
                         fext=rng.standard_normal((m.njoints, 6)),
                         ext_w=rng.standard_normal((m.njoints, 6)),
                         x1=np.concatenate([q1, v1]),
                         dx=0.3 * rng.standard_normal(st.ndx),
                         jac=rng.standard_normal((st.ndx, 3))))
    inp = {k: np.stack([r[k] for r in rows]) for k in rows[0]}

    def ref(q, v, a, fext, ext_w, x1, dx, jac):
        kd = ja.KinData(m, q, v)
        return _quantities(ja, st, m, kd, q, v, a, fext, ext_w,
                           jnp.concatenate([q, v]), x1, dx, jac)

    out = jax.jit(jax.vmap(ref))(*(jnp.asarray(inp[k]) for k in ARGS))
    res = {"in." + k: a for k, a in inp.items()}
    res.update(("ref." + k, np.asarray(o)) for k, o in out.items())
    return res


@functools.lru_cache(maxsize=None)
def _algorithms_case(robot, cache_dir):
    """(inputs, JAX references, port results per point) of one robot."""
    res = reference(JOBS["algorithms_" + robot], cache_dir)
    inp = {k[3:]: a for k, a in res.items() if k.startswith("in.")}
    ref = {k[4:]: a for k, a in res.items() if k.startswith("ref.")}
    return inp, ref, [_port(robot, inp, i) for i in range(POINTS)]


def _port(robot, inp, i):
    from crocoddyl_tpu_torch.dynamics import algorithms as ta
    from crocoddyl_tpu_torch.dynamics import robots as tr
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    m = getattr(tr, robot)()
    st = StateMultibody(model=m)
    t = {k: t64(a[i]) for k, a in inp.items()}
    kd = ta.KinData(m, t["q"], t["v"])
    return _quantities(ta, st, m, kd, t["q"], t["v"], t["a"], t["fext"],
                       t["ext_w"], torch.cat([t["q"], t["v"]]), t["x1"],
                       t["dx"], t["jac"])


GROUPS = {
    "gforce_derivatives": ("gforce_q", "gforce_v", "gforce_ext_q",
                           "gforce_ext_v"),
    "frame_tangents": tuple("frame_tangents." + f for f in
                            ("dxi", "dp", "dv", "dab", "dJa")),
    "kin_tangent_basis": tuple("kin_tangent_basis." + f for f in
                               ("oR", "op", "vels", "biasacc", "Jcols",
                                "vel_w", "Iw_c", "Iw_Ic")),
    "dynamics": ("aba", "crba", "nonlinear_effects", "gravity_torque",
                 "mass_matrix_vec"),
    "centroidal_momentum": ("centroidal_momentum", "com_velocity",
                            "frame_jacobian_world", "frame_jacobian_aligned"),
    "state_jacobians": ("jintegrate_x", "jintegrate_dx", "jdiff_0",
                        "jdiff_1", "jintegrate_transport"),
}


@pytest.mark.parametrize("group", sorted(GROUPS))
@pytest.mark.parametrize("robot", ROBOTS)
def test_algorithms_match_jax(robot, group, _references):
    """The rigid-body algorithms and state Jacobians (1e-10)."""
    _, ref, port = _algorithms_case(robot, _references)
    for name in GROUPS[group]:
        for i in range(POINTS):
            err = max_rel(ref[name][i], port[i][name])
            assert err < TOL_ALGO, (name, i, err)


def test_random_q_and_rand_are_valid_states():
    """``RobotModel.random_q`` / ``StateMultibody.rand`` draw from an
    explicit generator: reproducible, unit base quaternion, joints in
    [-π, π), velocities in [-1, 1)."""
    from crocoddyl_tpu_torch.dynamics import robots as tr
    from crocoddyl_tpu_torch.dynamics.states import StateMultibody
    st = StateMultibody(model=tr.quadruped())
    x1 = st.rand(torch.Generator().manual_seed(3))
    x2 = st.rand(torch.Generator().manual_seed(3))
    assert torch.equal(x1, x2) and x1.shape == (st.nx,)
    assert abs(float(torch.linalg.norm(x1[3:7])) - 1.0) < 1e-12
    assert bool((x1[7:st.nq].abs() <= np.pi).all())
    assert bool((x1[st.nq:].abs() <= 1.0).all())
    z = st.zero()
    assert float(z[6]) == 1.0 and float(z.abs().sum()) == 1.0
