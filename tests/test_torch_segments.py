"""Segmented problems and the true impulse switch knot of the port against
the JAX package, float64 on the CPU: ``ImpulseNode``, ``calc_impulse``,
the impulse costs, the segmented ``ShootingProblem``, the true-impulse
gaits, ``rotate_segmented``, and ``solve`` over several segments.

The problem is the true-impulse quadruped walk of tests/test_gaits.py:104-118
(``step_knots=4, support_knots=1, pseudo_impulse=False``: 8 segments,
T=22), the biped's true-impulse walk and balance at small sizes.

- Problem leaves, segment counts and lengths, ``problem_from_numpy`` of the
  JAX segmented problem: exact to 1e-12.
- ``calc_impulse`` of both contact types and the impulse costs' residuals,
  JAX evaluated eagerly in this process: 1e-10 of each quantity's max-abs.
- ``ImpulseNode.calc``/``calc_both`` on the impulse knots of the walk (the
  rows of JAX's ``calc_diff_full``) and of both biped problems at
  perturbed points: 1e-10; its derivatives
  against the port's ``numdiff_fxlx`` at the bar of
  tests/test_contacts_numdiff.py (5e-5 of 1 + the difference's max-abs).
- ``calc``, ``calc_diff``, ``calc_diff_full``, ``rollout`` and
  ``quasi_static`` of the walk at perturbed points: 1e-10, with
  ``calc_diff_full`` taking the rigid-body group through one call of the
  node kernel's plain version and the impulse group through the generic
  node.  (On the CPU JAX's ``calc_diff`` computes the derivatives of its
  ``calc_diff_full`` with the same operations: both nodes' ``calc_diff``
  is ``calc_both(x, u)[0]`` and the fused kernel is off, so the port's
  ``calc_diff`` is held to those.)
- ``_forward_pass`` at three step lengths from the first iteration's
  direction: 1e-9; ``_forward_pass_ms`` with ``ms_chunk=T`` (each segment
  one chunk) is, segment by segment, ``_forward_pass`` of that segment
  restarted from the candidate's incoming state, to the last bit (the
  chunks inside a segment are held to JAX on the unicycle,
  tests/test_torch_oracles.py).
- One FDDP iteration (``maxiter=1``, sequential line search) from the
  quasi-static controls, the only JAX ``solve`` of this module: the same
  decisions, cost 1e-8 relative, controls 1e-6, the direction 1e-8 of its
  max-abs (the gaps 1e-8 of the states').
- ``rotate_segmented`` with k=1 and k=3 on the varied unicycle of
  tests/test_mpc.py split in two segments and on the walk: JAX's leaves
  exactly, and k=3 equal to three k=1.
- ``apps/rh5.calc_zmps`` on the biped's true-impulse walk: JAX's at 1e-10.

The JAX references that compile run in child processes
(``start_references``), beside this module's eager tests.
"""

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import (FEET, REPO, leaves_of, max_rel, np_,
                                 reference, start_references, t64, to_port)

FIELDS = ("Fx", "Fu", "Lx", "Lu", "Lxx", "Lxu", "Luu")
TOL = 1e-10          # node and problem passes, residuals
TOL_FWD = 1e-9       # trial rollouts
SOLES = ["right_sole", "left_sole"]
ALPHAS = (1.0, 0.5, 0.125)
SEQ = dict(record_trace=False, parallel_linesearch=False)
# {case: (factory, method, arguments, keywords)}: the true-impulse problems
PROBLEMS = {
    "quad_walk": ("quad", "walking", (0.1, 0.05, 1e-2),
                  dict(step_knots=4, support_knots=1)),
    "biped_walk": ("biped", "walking", (0.6, 0.1, 0.03),
                   dict(step_knots=3, support_knots=1)),
    "biped_balancing": ("biped", "balancing", (1, 2, 4, 0.03), {}),
}


# ---------------------------------------------------------------------------
# Builders of both packages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_problem(case):
    from crocoddyl_tpu.apps.gaits import (BipedGaitFactory,
                                          QuadrupedGaitFactory)
    from crocoddyl_tpu.dynamics import robots
    robot, method, args, kw = PROBLEMS[case]
    if robot == "quad":
        m = robots.quadruped()
        q0 = robots.quadruped_standing_q(m)
        fac = QuadrupedGaitFactory(m, FEET, default_q=np.asarray(q0))
    else:
        m = robots.biped()
        q0 = robots.biped_standing_q(m)
        fac = BipedGaitFactory(m, SOLES, default_q=np.asarray(q0))
    return getattr(fac, f"{method}_problem")(
        jnp.concatenate([q0, jnp.zeros(m.nv)]), *args, pseudo_impulse=False,
        **kw)


@functools.lru_cache(maxsize=None)
def _torch_problem(case):
    from crocoddyl_tpu_torch.apps.gaits import (BipedGaitFactory,
                                                QuadrupedGaitFactory)
    from crocoddyl_tpu_torch.dynamics import robots
    robot, method, args, kw = PROBLEMS[case]
    if robot == "quad":
        m = robots.quadruped()
        q0 = robots.quadruped_standing_q(m)
        fac = QuadrupedGaitFactory(m, FEET, default_q=q0)
    else:
        m = robots.biped()
        q0 = robots.biped_standing_q(m)
        fac = BipedGaitFactory(m, SOLES, default_q=q0)
    return getattr(fac, f"{method}_problem")(
        torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)]), *args,
        pseudo_impulse=False, **kw)


@functools.lru_cache(maxsize=None)
def _walk():
    """The port's counterpart of the JAX walk (``problem_from_numpy``)."""
    return to_port(_jax_problem("quad_walk"))


def _points(prob, seed):
    """Perturbed (xs (T+1, nx), us (T, nu)) around x0, quaternion
    normalized."""
    rng = np.random.default_rng(seed)
    x0 = np.asarray(prob.x0)
    xs = x0[None] + 0.01 * rng.standard_normal((prob.T + 1, x0.size))
    xs[:, 3:7] /= np.linalg.norm(xs[:, 3:7], axis=1, keepdims=True)
    return xs, 0.5 * rng.standard_normal((prob.T, prob.nu))


def _impulse_segments(prob):
    """[(first knot, knots, segment)] of the problem's ImpulseNode
    segments."""
    return [(i, j - i, seg) for seg, (i, j) in zip(prob.segments,
                                                   prob._seg_slices())
            if type(seg).__name__ == "ImpulseNode"]


def _quad_state(seed):
    """(JAX quadruped, its port, a perturbed standing state (nx,))."""
    from crocoddyl_tpu.dynamics import robots as jr
    jm = jr.quadruped()
    q = np.asarray(jr.quadruped_standing_q(jm))
    rng = np.random.default_rng(seed)
    x = np.concatenate([q, np.zeros(jm.nv)])
    x = x + 0.01 * rng.standard_normal(x.size)
    x[3:7] /= np.linalg.norm(x[3:7])
    return jm, to_port(jm), x


# ---------------------------------------------------------------------------
# JAX references computed in child processes
# ---------------------------------------------------------------------------

def jax_reference(job):
    """The JAX side of one job (the child of ``start_references`` calls
    this).  "walk": the walk's passes at perturbed points; "solve": one
    FDDP iteration from the quasi-static controls and the trial rollouts
    from its direction; "impulse": ``calc_both`` over the impulse knots of
    the biped problems (one program: their impulse knots share one
    structure)."""
    from crocoddyl_tpu.core.solvers import fddp
    out = {}
    if job == "impulse":
        both = jax.jit(jax.vmap(lambda m, x, u: m.calc_both(x, u)))
        for case in ("biped_walk", "biped_balancing"):
            prob = _jax_problem(case)
            xs, us = _points(prob, 1)
            for i, n, seg in _impulse_segments(prob):
                d, xn, c = both(seg, jnp.asarray(xs[i:i + n]),
                                jnp.asarray(us[i:i + n]))
                tag = f"{case}.{i}"
                out.update({f"{tag}.{f}": getattr(d, f) for f in FIELDS})
                out.update({f"{tag}.xnext": xn, f"{tag}.cost": c})
        return {k: np.asarray(v) for k, v in out.items()}
    prob = _jax_problem("quad_walk")
    if job == "walk":
        xs, us = (jnp.asarray(a) for a in _points(prob, 0))

        def passes(xs, us):
            xn, c = prob.calc(xs, us)
            df, dtf, xnf, cf = prob.calc_diff_full(xs, us)
            return dict(calc_xnext=xn, calc_cost=c, rollout=prob.rollout(us),
                        quasi_static=prob.quasi_static(xs),
                        full_xnext=xnf, full_cost=cf,
                        **{f"full.{f}": getattr(df, f) for f in FIELDS},
                        **{f"full.term.{f}": getattr(dtf, f)
                           for f in FIELDS})
        return {k: np.asarray(v)
                for k, v in jax.jit(passes)(xs, us).items()}
    import crocoddyl_tpu as ct
    xs0 = jnp.tile(prob.x0[None], (prob.T + 1, 1))
    us0 = jax.jit(prob.quasi_static)(xs0)
    sol = ct.solve(prob, xs_init=xs0, us_init=us0,
                   settings=ct.SolverSettings(maxiter=1, **SEQ))
    out.update({"warm.us": us0})
    out.update({f"sol.{f}": getattr(sol, f) for f in (
        "xs", "us", "K", "k", "Vx", "Vxx", "Qu", "fs", "cost", "stop",
        "xreg", "steplength", "iter", "is_feasible", "d0", "d1")})
    fwd = jax.jit(lambda a: fddp._forward_pass(
        prob, xs0, us0, sol.k, sol.K, sol.fs, a))
    for a in ALPHAS:
        out.update({f"fwd{a}.{n}": v for n, v in zip(
            ("xs", "us", "cost", "failed"), fwd(jnp.asarray(a)))})
    return {k: np.asarray(v) for k, v in out.items()}


JOBS = {job: f"tests.test_torch_segments:jax_reference:{job}"
        for job in ("solve", "walk", "impulse")}


@pytest.fixture(scope="module", autouse=True)
def _references(solve_cache):  # noqa: F811
    start_references(JOBS.values(), solve_cache)
    return solve_cache


# ---------------------------------------------------------------------------
# Problems (no JAX program)
# ---------------------------------------------------------------------------

def _torch_leaves(tree):
    import torch.utils._pytree as pt
    flat, _ = pt.tree_flatten_with_path(tree)
    return {pt.keystr(p): np_(l) for p, l in flat}


def test_true_impulse_walk_matches_jax():
    """The port's quadruped factory builds the JAX factory's true-impulse
    walk: the same segments (types, lengths), leaves within 1e-12 and
    structure; the JAX problem carried across by ``problem_from_numpy`` is
    a tuple of the same segments, with an ImpulseNode terminal.  (The
    biped's walk and balance: tests/test_torch_model_zoo.py::
    test_pseudo_impulse_false_raises.)"""
    import torch.utils._pytree as pt
    case = "quad_walk"
    jp, tp = _jax_problem(case), _torch_problem(case)
    assert isinstance(tp.running, tuple) and len(tp.segments) > 1
    assert tp.seg_lengths == jp.seg_lengths and tp.T == jp.T
    assert ([type(s).__name__ for s in tp.segments]
            == [type(s).__name__ for s in jp.segments])
    assert type(tp.terminal).__name__ == type(jp.terminal).__name__
    ref, got = leaves_of(jp), _torch_leaves(tp)
    assert set(ref) == set(got), set(ref) ^ set(got)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12, err_msg=k)
    assert pt.tree_structure(to_port(jp)) == pt.tree_structure(tp)
    assert not tp.on_lanes
    # tests/test_gaits.py:110-112: 4 × (swing segment + impulse knot)
    assert len(tp.segments) == 8 and tp.T == 2 * 1 + 4 * 5
    assert tp._seg_groups == [[0, 2, 4, 6], [1, 3, 5, 7]]


@pytest.mark.parametrize("kind", ["contact3d", "contact6d"])
def test_calc_impulse_matches_jax(kind):
    """``calc_impulse`` of each contact type and of a ContactSet with an
    inactive member (contacts.py:59,99,144-150), JAX evaluated eagerly."""
    from crocoddyl_tpu.dynamics import algorithms as jalgo
    from crocoddyl_tpu.models.multibody import contacts as jc
    from crocoddyl_tpu.models.multibody.nodes import NodeCache as JCache
    from crocoddyl_tpu_torch.dynamics import algorithms as talgo
    from crocoddyl_tpu_torch.models.multibody.nodes import NodeCache
    jm, tm, x = _quad_state(5)
    nq = jm.nq

    def make(mod, fid, on):
        if kind == "contact3d":
            return mod.Contact3D(fid=fid, pref=jnp.asarray([0.3, 0.2, 0.0]),
                                 gains=jnp.asarray([10.0, 4.0]),
                                 active=jnp.asarray(on))
        return mod.Contact6D(fid=fid, ref_R=jnp.eye(3),
                             ref_p=jnp.asarray([-0.3, -0.2, 0.0]),
                             gains=jnp.asarray([8.0, 2.0]),
                             active=jnp.asarray(on))
    jset = jc.ContactSet(contacts=tuple(
        make(jc, jm.frame_id(f), on) for f, on in zip(FEET, (1., 0., 1., 1.))))
    jcache = JCache(jalgo.KinCache(jm, jnp.asarray(x[:nq]),
                                   jnp.asarray(x[nq:])))
    tset = to_port(jset)
    tcache = NodeCache(talgo.KinCache(tm, t64(x[:nq]), t64(x[nq:])))
    J1 = jset.contacts[0].calc_impulse(jcache)
    assert max_rel(J1, tset.contacts[0].calc_impulse(tcache)) < TOL
    (Jc, mask), (tJc, tmask) = (jset.calc_impulse(jcache),
                                tset.calc_impulse(tcache))
    assert max_rel(Jc, tJc) < TOL
    np.testing.assert_array_equal(np.asarray(mask), np_(tmask))
    n = 3 if kind == "contact3d" else 6
    assert tJc.shape == (4 * n, tm.nv) and not tJc[n:2 * n].any()


def test_impulse_costs_residuals_match_jax():
    """The three impulse costs (costs.py:291-310) on a cache holding
    impulses Λ and a post-impact velocity: residuals 1e-10, residual sizes
    (``cost_nr``) equal."""
    from crocoddyl_tpu.dynamics import algorithms as jalgo
    from crocoddyl_tpu.dynamics.states import StateMultibody as JState
    from crocoddyl_tpu.models.multibody import costs as jcs
    from crocoddyl_tpu.models.multibody.activations import ActivationQuad
    from crocoddyl_tpu.models.multibody.frames import friction_cone
    from crocoddyl_tpu.models.multibody.nodes import NodeCache as JCache
    from crocoddyl_tpu_torch.dynamics import algorithms as talgo
    from crocoddyl_tpu_torch.models.multibody import costs as tcs
    from crocoddyl_tpu_torch.models.multibody.nodes import NodeCache
    jm, tm, x = _quad_state(7)
    rng = np.random.default_rng(7)
    q = x[:jm.nq]
    v, vnext = rng.standard_normal((2, jm.nv))
    lam = [rng.standard_normal(3) for _ in FEET]
    cone = friction_cone((0., 0., 1.), 0.7, nf=4, inner_appr=False)
    common = dict(activation=ActivationQuad(), weight=jnp.asarray(2.0),
                  active=jnp.asarray(1.0))
    jcosts = (jcs.CostImpulseCoM(**common),
              jcs.CostContactImpulse(contact_idx=2,
                                     fref=jnp.asarray([0.1, -0.2, 3.0]),
                                     **common),
              jcs.CostImpulseFrictionCone(contact_idx=1, cone=cone,
                                          **common))
    jcache = JCache(jalgo.KinCache(jm, jnp.asarray(q), jnp.asarray(v)),
                    forces=[jnp.asarray(f) for f in lam],
                    vnext=jnp.asarray(vnext))
    tcache = NodeCache(talgo.KinCache(tm, t64(q), t64(v)),
                       forces=[t64(f) for f in lam], vnext=t64(vnext))
    jst = JState(jm)
    tst = to_port(jst)
    x = np.concatenate([q, v])
    for jcost in jcosts:
        tcost = to_port(jcost)
        assert type(tcost).__name__ == type(jcost).__name__
        r = jcost.residual(jst, jcache, jnp.asarray(x), jnp.zeros(12))
        got = tcost.residual(tst, tcache, t64(x),
                             torch.zeros(12, dtype=torch.float64))
        assert max_rel(r, got) < TOL, type(jcost).__name__
        assert tcs.cost_nr(tcost, tst) == jcs.cost_nr(jcost, jst) \
            == got.shape[0]


# ---------------------------------------------------------------------------
# The impulse knot against JAX and against finite differences
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(PROBLEMS))
def test_impulse_node_matches_jax(case, _references):
    """``ImpulseNode.calc_both`` under vmap over each impulse segment's
    knots (derivatives, xnext, cost) and ``calc``: 1e-10; the walk's
    against the impulse rows of JAX's ``calc_diff_full``."""
    prob = to_port(_jax_problem(case))
    segs = _impulse_segments(prob)
    assert segs
    if case == "quad_walk":
        full = reference(JOBS["walk"], _references)
        xs, us = _points(prob, 0)
        ref = {}
        for i, n, _ in segs:
            ref.update({f"{case}.{i}.{f}": full[f"full.{f}"][i:i + n]
                        for f in FIELDS})
            ref[f"{case}.{i}.xnext"] = full["full_xnext"][i:i + n]
            ref[f"{case}.{i}.cost"] = full["full_cost"][i:i + n]
    else:
        ref = reference(JOBS["impulse"], _references)
        xs, us = _points(prob, 1)
    for i, n, seg in segs:
        x, u = t64(xs[i:i + n]), t64(us[i:i + n])
        d, xn, c = torch.func.vmap(lambda m, x, u: m.calc_both(x, u))(
            seg, x, u)
        tag = f"{case}.{i}"
        for f in FIELDS:
            assert max_rel(ref[f"{tag}.{f}"], getattr(d, f)) < TOL, (tag, f)
        assert max_rel(ref[f"{tag}.xnext"], xn) < TOL
        assert max_rel(ref[f"{tag}.cost"], c) < TOL
        xn1, c1 = torch.func.vmap(lambda m, x, u: m.calc(x, u))(seg, x, u)
        assert max_rel(ref[f"{tag}.xnext"], xn1) < TOL
        assert max_rel(ref[f"{tag}.cost"], c1) < TOL


@pytest.mark.parametrize("case", ["quad_walk", "biped_walk"])
def test_impulse_node_derivatives_match_numdiff(case):
    """The impulse knot's Fx, Fu, Lx, Lu against the port's forward
    differences (``numdiff_fxlx``) at the bar of
    tests/test_contacts_numdiff.py: 5e-5 of 1 + the differences' max-abs;
    its terminal derivatives (``calc_diff_terminal``) are its running ones
    at u = 0."""
    from crocoddyl_tpu_torch.utils.struct import tree_map
    from crocoddyl_tpu_torch.utils.numdiff import numdiff_fxlx
    prob = _torch_problem(case)
    xs, us = _points(prob, 3)
    i, _, seg = _impulse_segments(prob)[0]
    node = tree_map(lambda l: l[0], seg)
    x, u = t64(xs[i]), t64(us[i])
    d = node.calc_diff(x, u)
    for name, fd in zip(("Fx", "Fu", "Lx", "Lu"), numdiff_fxlx(node, x, u)):
        got = np_(getattr(d, name))
        np.testing.assert_allclose(got, np_(fd), rtol=0,
                                   atol=5e-5 * (1 + np.abs(np_(fd)).max()),
                                   err_msg=name)
    dt = node.calc_diff_terminal(x)
    d0 = node.calc_diff(x, torch.zeros_like(u))
    for f in FIELDS:
        torch.testing.assert_close(getattr(dt, f), getattr(d0, f))


# ---------------------------------------------------------------------------
# The segmented problem's passes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("what", ["calc", "calc_diff", "calc_diff_full",
                                  "rollout", "quasi_static"])
def test_segmented_walk_passes_match_jax(what, _references, monkeypatch):
    """The walk's passes against JAX at perturbed points: 1e-10.
    ``calc_diff_full`` takes the 18 rigid-body knots of segments 0, 2, 4, 6
    in one call of the node kernel's plain version and the 4 impulse knots
    and the impulse terminal through the generic node."""
    from crocoddyl_tpu_torch.models.multibody.nodes import ImpulseNode
    from crocoddyl_tpu_torch.ops import fused_node
    ref = reference(JOBS["walk"], _references)
    prob = _walk()
    xs, us = (t64(a) for a in _points(prob, 0))
    if what == "calc":
        xn, c = prob.calc(xs, us)
        assert max_rel(ref["calc_xnext"], xn) < TOL
        assert max_rel(ref["calc_cost"], c) < TOL
    elif what in ("calc_diff", "calc_diff_full"):
        calls, nodes = [], []
        plain = fused_node.calc_both_lanes_plain

        def counted(s, x, u):
            nodes.append(x.shape[-1])
            return plain(s, x, u)
        counted.calls = plain.calls
        monkeypatch.setattr(fused_node, "calc_both_lanes_plain", counted)
        both = ImpulseNode.calc_both
        monkeypatch.setattr(ImpulseNode, "calc_both",
                            lambda self, x, u: calls.append(x.shape)
                            or both(self, x, u))
        out = getattr(prob, what)(xs, us)
        for f in FIELDS:
            assert max_rel(ref[f"full.{f}"], getattr(out[0], f)) < TOL, f
            assert max_rel(ref[f"full.term.{f}"],
                           getattr(out[1], f)) < TOL, f
        if what == "calc_diff_full":
            assert max_rel(ref["full_xnext"], out[2]) < TOL
            assert max_rel(ref["full_cost"], out[3]) < TOL
        assert nodes == [18]
        # the impulse block under vmap, then the terminal knot
        assert len(calls) == 2
    elif what == "rollout":
        assert max_rel(ref["rollout"], prob.rollout(us)) < TOL
    else:
        qs = prob.quasi_static(xs)
        assert max_rel(ref["quasi_static"], qs) < TOL
        for i, n, _ in _impulse_segments(prob):
            assert not qs[i:i + n].any()


def _first_iteration(cache_dir):
    ref = reference(JOBS["solve"], cache_dir)
    prob = _walk()
    xs0 = prob.x0[None].expand(prob.T + 1, -1).contiguous()
    return ref, prob, xs0, t64(ref["warm.us"])


@pytest.mark.parametrize("alpha", ALPHAS)
def test_segmented_forward_pass_matches_jax(alpha, _references):
    """The generic trial rollout through the 8 segments at the first
    iteration's direction, each step length a row of its own: 1e-9."""
    from crocoddyl_tpu_torch.core.solvers import fddp
    ref, prob, xs0, us0 = _first_iteration(_references)
    out = fddp._forward_pass(prob, xs0, us0, t64(ref["sol.k"]),
                             t64(ref["sol.K"]), t64(ref["sol.fs"]),
                             [0.25, alpha])
    for i, n in enumerate(("xs", "us", "cost")):
        assert max_rel(ref[f"fwd{alpha}.{n}"], out[i][1]) < TOL_FWD, n
    assert bool(out[3][1]) == bool(ref[f"fwd{alpha}.failed"])


def test_segmented_forward_pass_ms_restarts_each_segment(_references):
    """The multiple-shooting rollout with ``ms_chunk=T`` (each segment one
    chunk) at the first iteration's direction: each segment's rows are
    ``_forward_pass`` of that segment alone from x0 = integrate(xs[i],
    fs[i]), the candidate's incoming state (fddp.py:438-446), and the cost
    is theirs without their terminal costs, plus the terminal's."""
    from crocoddyl_tpu_torch.core.problem import terminal_calc
    from crocoddyl_tpu_torch.core.solvers import fddp
    ref, prob, xs0, us0 = _first_iteration(_references)
    k, K, fs = (t64(ref[f"sol.{f}"]) for f in ("k", "K", "fs"))
    alphas = [1.0, 0.5]
    xs_m, us_m, cost_m, failed_m = fddp._forward_pass_ms(
        prob, xs0, us0, k, K, fs, alphas, prob.T)
    _, integrate = fddp._state_ops(prob)
    cost = torch.zeros(2, dtype=torch.float64)
    for seg, (i, j) in zip(prob.segments, prob._seg_slices()):
        sub = prob.replace(x0=integrate(xs0[i:i + 1], fs[i:i + 1])[0],
                           running=seg)
        xs_s, us_s, c_s, f_s = fddp._forward_pass(
            sub, xs0[i:j + 1], us0[i:j], k[i:j], K[i:j], fs[i:j + 1],
            alphas)
        assert torch.equal(xs_s[:, :-1], xs_m[:, i:j]), (i, j)
        assert torch.equal(us_s, us_m[:, i:j]), (i, j)
        assert not f_s.any()
        cost = cost + c_s - terminal_calc(prob.terminal, xs_s[:, -1])
    cost = cost + terminal_calc(prob.terminal, xs_m[:, -1])
    assert max_rel(cost, cost_m) < 1e-12
    assert not failed_m.any()


def test_segmented_walk_solve_matches_jax(_references):
    """One FDDP iteration over the 8 segments from the quasi-static
    controls, sequential line search: the same decisions (iterations, step
    length, feasibility, regularization), cost 1e-8 relative, us 1e-6, the
    direction fields and xs 1e-8 of their max-abs."""
    import crocoddyl_tpu_torch as ctt
    ref, prob, xs0, us0 = _first_iteration(_references)
    sol = ctt.solve(prob, xs0, us0, ctt.SolverSettings(maxiter=1, **SEQ),
                    device="cpu")
    for f in ("iter", "steplength", "is_feasible", "xreg"):
        assert np_(getattr(sol, f)) == ref[f"sol.{f}"], f
    np.testing.assert_allclose(float(sol.cost), float(ref["sol.cost"]),
                               rtol=1e-8)
    np.testing.assert_allclose(np_(sol.us), ref["sol.us"], rtol=0, atol=1e-6)
    for f in ("xs", "K", "k", "Vx", "Vxx", "Qu"):
        assert max_rel(ref[f"sol.{f}"], getattr(sol, f)) < 1e-8, f
    # the gaps (~1e-8 against states of ~10) to 1e-8 of the states, as
    # tests/test_torch_solve.py holds them
    assert (np.abs(ref["sol.fs"] - np_(sol.fs)).max()
            < 1e-8 * np.abs(ref["sol.xs"]).max())


# ---------------------------------------------------------------------------
# Horizon rotation (JAX's rotate_segmented is plain Python)
# ---------------------------------------------------------------------------

def _varied_segments():
    """tests/test_mpc.py:77-114: the varied unicycle, split A(5), B(7)."""
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    m = UnicycleModel()
    T = 12
    w = jnp.stack([jnp.linspace(1.0, 2.0, T), jnp.linspace(0.1, 0.5, T)], -1)
    run = ct.replicate_model(m, T).replace(cost_weights=w)
    return ct.ShootingProblem(
        x0=jnp.asarray([-1.0, -1.0, 1.0]),
        running=(jax.tree.map(lambda l: l[:5], run),
                 jax.tree.map(lambda l: l[5:], run)), terminal=m)


def _same_problem(ref, out):
    want, got = leaves_of(ref), _torch_leaves(out)
    assert set(want) == set(got), set(want) ^ set(got)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("problem", ["unicycle", "walk"])
def test_rotate_segmented_matches_jax(problem, k):
    """``rotate_segmented`` drops k knots, appends them at the tail and
    regroups: JAX's segments and leaves exactly (the unicycle's two
    segments of one structure become one; the walk keeps 8 or 9)."""
    from crocoddyl_tpu.core.mpc import rotate_segmented as jrot
    from crocoddyl_tpu_torch.core.mpc import rotate_segmented
    jprob = _varied_segments() if problem == "unicycle" else \
        _jax_problem("quad_walk")
    tprob = to_port(jprob)
    x_new = np.asarray(jprob.x0) + 0.5
    ref = jrot(jprob, k=k, new_x0=jnp.asarray(x_new))
    out = rotate_segmented(tprob, k=k, new_x0=t64(x_new))
    assert out.seg_lengths == ref.seg_lengths
    _same_problem(ref, out)
    if problem == "unicycle":
        assert out.seg_lengths == (12,)


@pytest.mark.parametrize("problem", ["unicycle", "walk"])
def test_rotate_segmented_k3_equals_three_k1(problem):
    from crocoddyl_tpu_torch.core.mpc import _unstack, rotate_segmented
    from crocoddyl_tpu_torch.utils.struct import tree_leaves
    tprob = (to_port(_varied_segments()) if problem == "unicycle"
             else _torch_problem("quad_walk"))
    r3 = rotate_segmented(tprob, k=3)
    r111 = rotate_segmented(rotate_segmented(rotate_segmented(tprob)))
    a = [n for s in r3.segments for n in _unstack(s)]
    b = [n for s in r111.segments for n in _unstack(s)]
    assert len(a) == len(b) == tprob.T
    for x, y in zip(a, b):
        assert type(x) is type(y)
        for lx, ly in zip(tree_leaves(x), tree_leaves(y)):
            torch.testing.assert_close(lx, ly, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# The RH5 analysis over segments (JAX evaluated in this process)
# ---------------------------------------------------------------------------

def test_rh5_zmps_on_segmented_walk_match_jax():
    """``calc_zmps`` on the biped's true-impulse walk (4 segments) at
    perturbed states: an impulse segment's dt is zero, so its knots keep
    the previous momentum rate (rh5.py:78-90): JAX's ZMPs at 1e-10;
    ``calc_cops`` skips the impulse segments and gives one record per
    supporting sole of the rigid-body knots."""
    import types
    from crocoddyl_tpu.apps import rh5 as jrh5
    from crocoddyl_tpu_torch.apps import rh5
    jp = _jax_problem("biped_walk")
    prob = _torch_problem("biped_walk")
    xs, us = _points(prob, 4)
    ref = jrh5.calc_zmps(jp, types.SimpleNamespace(xs=jnp.asarray(xs),
                                                   us=jnp.asarray(us)))
    sol = types.SimpleNamespace(xs=t64(xs), us=t64(us))
    zmps = rh5.calc_zmps(prob, sol)
    assert zmps.shape == (prob.T, 3)
    assert max_rel(ref, zmps) < TOL
    cops = rh5.calc_cops(prob, sol)
    imp = {t for i, n, _ in _impulse_segments(prob) for t in range(i, i + n)}
    on = sum(int(c.active.sum()) for seg in prob.segments
             if type(seg).__name__ == "RigidBodyNode"
             for c in seg.contacts.contacts)
    assert len(cops) == on and not imp & {r["t"] for r in cops}


def test_every_reference_job_is_prefetched():
    """The session's prefetch (``tests/_torch_parity.REFERENCE_JOBS``)
    holds the JAX reference jobs (``JOBS``) of every module
    tests/test_torch_*.py, so that none is started late, when its module's
    first test runs."""
    import glob
    import importlib
    from tests._torch_parity import REFERENCE_JOBS
    jobs = set()
    for f in sorted(glob.glob(os.path.join(REPO, "tests", "test_torch_*.py"))):
        name = os.path.splitext(os.path.basename(f))[0]
        mod = importlib.import_module(f"tests.{name}")
        jobs |= set(getattr(mod, "JOBS", {}).values())
    assert jobs == set(REFERENCE_JOBS)
    assert len(REFERENCE_JOBS) == len(set(REFERENCE_JOBS))
