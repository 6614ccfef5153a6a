"""Shared fixtures of the PyTorch-port parity tests (tests/test_torch_*.py).

Builds the reduced ANYmal walk in the JAX package exactly as
tests/test_fddp_batch.py does, hands its numbers to the port as numpy
arrays, and compares results.  Not a test module itself.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fcntl
import functools
import os
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

torch.set_num_threads(1)

FEET = ["LF_FOOT", "RF_FOOT", "LH_FOOT", "RH_FOOT"]
B = 3
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def jax_walk_problem():
    """The JAX reduced walk (step_knots=3, support_knots=1) of
    ``jax_walk``, without its warm start."""
    from crocoddyl_tpu.apps.gaits import QuadrupedGaitFactory
    from crocoddyl_tpu.dynamics import robots
    m = robots.anymal(dtype=np.float64)
    q0 = robots.anymal_standing_q(m)
    x0 = jnp.concatenate([q0, jnp.zeros(m.nv)])
    fac = QuadrupedGaitFactory(m, FEET, default_q=np.asarray(q0))
    return fac.walking_problem(x0, 0.25, 0.15, 1e-2,
                               step_knots=3, support_knots=1)


@functools.lru_cache(maxsize=None)
def jax_walk():
    """(prob, xs0, us0, x0s) of the reduced walk (step_knots=3,
    support_knots=1), B=3 velocity-perturbed initial states from a numpy
    seed — the construction of tests/test_fddp_batch.py:19-36."""
    prob = jax_walk_problem()
    m = prob.state.model
    x0 = prob.x0
    xs0 = jnp.tile(prob.x0[None], (prob.T + 1, 1))
    us0 = jax.jit(prob.quasi_static)(xs0)
    dv = 0.01 * np.random.default_rng(0).standard_normal((B, m.nv))
    x0s = jnp.tile(x0[None], (B, 1)).at[:, prob.state.nq:].add(dv)
    return prob, xs0, us0, x0s


@functools.lru_cache(maxsize=None)
def jax_forward_pass():
    """JAX ``fddp._forward_pass`` on the reduced walk from the warm start,
    compiled once for the tests that hold the port's rollouts to it:
    ``f(k, K, fs, alpha, u_lb, u_ub)`` (bounds of ±inf clamp nothing)."""
    from crocoddyl_tpu.core.solvers import fddp
    prob, xs0, us0, _ = jax_walk()
    return jax.jit(lambda k, K, fs, alpha, lb, ub: fddp._forward_pass(
        prob, xs0, us0, k, K, fs, alpha, lb, ub))


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


@contextlib.contextmanager
def no_persistent_cache():
    """Within the block, JAX compiles without reading or writing the
    persistent compilation cache of tests/conftest.py: XLA:CPU has crashed
    (de)serializing cached executables in these tests' long worker
    processes (tests/run_suite.sh).  JAX offers no per-call switch, so the
    cache object is set aside and put back."""
    from jax._src import compilation_cache as cc
    with cc._cache_initialized_mutex:
        saved = cc._cache, cc._cache_initialized
        cc._cache, cc._cache_initialized = None, True
    try:
        yield
    finally:
        with cc._cache_initialized_mutex:
            cc._cache, cc._cache_initialized = saved


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_cache():
    """Imported by the tests/test_torch_*.py modules that call JAX: their
    JAX references compile outside the persistent cache
    (``no_persistent_cache``)."""
    with no_persistent_cache():
        yield


_SOLVE_CHILD = """
import ctypes, dataclasses, os, signal, sys
# end with the test process that started it (PR_SET_PDEATHSIG), and, when
# it runs ahead of the tests that need it, yield some CPU to the workers
ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
if os.getppid() != int(sys.argv[3]):
    sys.exit(1)
if int(sys.argv[4]):
    os.nice(int(sys.argv[4]))
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# a persistent compilation cache of this session's children alone
# (``_run_child``): a child is a fresh process that loads a few programs,
# not a long worker
jax.config.update("jax_compilation_cache_dir", os.environ["PARITY_JAX_CACHE"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
import crocoddyl_tpu as ct
import crocoddyl_tpu_torch as ctt
from crocoddyl_tpu.core.solvers import fddp_batch
from tests._torch_parity import SOLVE_JOBS, jax_walk, np_, t64, to_port
entry, path = sys.argv[1], sys.argv[2]
prob, xs0, us0, x0s = jax_walk()
port = to_port(prob)
leaves = {}
for maxiter in SOLVE_JOBS[entry]:
    kw = dict(maxiter=maxiter, record_trace=False, parallel_linesearch=False)
    if entry == "solve":
        # the reference's generic scans against the plain versions of the
        # port's kernels 4 and 5
        ref = ct.solve(prob, xs_init=xs0, us_init=us0,
                       settings=ct.SolverSettings(**kw))
        out = ctt.solve(port, t64(xs0), t64(us0),
                        ctt.SolverSettings(fused_scans=True, **kw),
                        device="cpu")
    else:
        ref = fddp_batch.solve_batch(prob, x0s, xs_init=xs0, us_init=us0,
                                     settings=ct.SolverSettings(**kw))
        out = ctt.solve_batch(port, t64(x0s), xs_init=t64(xs0),
                              us_init=t64(us0),
                              settings=ctt.SolverSettings(**kw),
                              device="cpu")
    for tag, sol in (("ref", ref), ("out", out)):
        for f in dataclasses.fields(sol):
            if getattr(sol, f.name) is not None:
                leaves[f"{tag}{maxiter}.{f.name}"] = np_(getattr(sol, f.name))
np.savez(path, **leaves)
"""


# The maxiter values that the port's tests hand to ``solve_pair``, by
# entry point: one child process computes all of an entry's
SOLVE_JOBS = {"solve_batch": (1,), "solve": (1, 20)}

# Every JAX reference of the port's tests (``start_references`` jobs: each
# module's ``JOBS``), longest first: the session's first worker computes
# them and SOLVE_JOBS from its start (``_prefetch``)
_R = "tests.test_torch_"
REFERENCE_JOBS = (
    f"{_R}segments:jax_reference:solve",
    f"{_R}segments:jax_reference:walk",
    f"{_R}model_zoo:jax_reference:cop",
    f"{_R}model_zoo:jax_reference:rh5",
    f"{_R}model_zoo:jax_reference:taichi",
    f"{_R}segments:jax_reference:impulse",
    f"{_R}model_zoo:jax_reference:biped",
    f"{_R}generic_node:jax_reference:contact_both",
    f"{_R}generic_node:jax_reference:contact_term",
    f"{_R}oracles:jax_reference:solvers",
    f"{_R}oracles:jax_reference:numdiff",
    f"{_R}model_zoo:jax_reference:quadrotor",
    f"{_R}model_zoo:jax_reference:quadrotor_ubound",
    f"{_R}generic_node:jax_reference:arm",
    f"{_R}generic_node:jax_reference:rk4",
    f"{_R}generic_node:jax_algorithms_reference:quadruped",
    f"{_R}generic_node:jax_algorithms_reference:arm7",
    f"{_R}generic_node:jax_reference:solve",
    f"{_R}generic_node:jax_reference:double_pendulum",
    f"{_R}generic_node:jax_algorithms_reference:double_pendulum")
# children the prefetch runs at once, and their niceness: beside the six
# test workers of the tier-1 run on eight cores
PREFETCH_SLOTS = 3
PREFETCH_NICE = 5
# how long a child may run, and how long a test waits for a reference
# another process is computing: a holder ends its child at CHILD_LIMIT and
# lets go of the lock, so only a holder stuck past that fails its waiters'
# tests, and a stuck reference fails its tests, not the session
CHILD_LIMIT = 900
WAIT_LIMIT = CHILD_LIMIT + 60


def _shared_dir():
    """Under pytest-xdist, a directory that every worker of the session
    finds from the session's id alone (so before any fixture runs); else
    None."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if not uid:
        return None
    path = os.path.join(tempfile.gettempdir(), f"torch_solve_pairs_{uid}")
    os.makedirs(path, exist_ok=True)
    return path


@pytest.fixture(scope="session")
def solve_cache(tmp_path_factory):
    """The directory where ``solve_pair`` keeps its solutions: under
    pytest-xdist the session's shared directory (``_shared_dir``); else
    the session's own temporary directory."""
    shared = _shared_dir()
    if shared:
        return shared
    path = tmp_path_factory.getbasetemp() / "torch_solve_pairs"
    path.mkdir(exist_ok=True)
    return str(path)


def _run_child(script, args, path, nice, timeout=CHILD_LIMIT):
    """Run ``script`` in a fresh Python process with ``args`` and a
    temporary output path, then move its output to ``path`` (niced by
    PREFETCH_NICE with ``nice``); its stderr on failure, else None."""
    tmp = f"{path}.{os.getpid()}.part.npz"
    env = {k: v for k, v in os.environ.items()
           if k != "PYTEST_XDIST_TESTRUNUID"}  # the child prefetches nothing
    # one XLA:CPU thread: the child runs beside the test workers; and no
    # LLVM optimization: a reference is a few small programs run once, so
    # their compile is most of a child's work (0.6-0.7 of its CPU seconds
    # at -O0 on the segmented walk's and the solve's references, whose
    # numbers move by rounding only)
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "")
                        + " --xla_cpu_multi_thread_eigen=false"
                        + " --xla_backend_optimization_level=0").strip()
    # the children's compilation cache, beside their outputs in the
    # session's own directory: empty when the session starts, and shared
    # with no other session (tests/conftest.py's cache is a fixed path)
    env["PARITY_JAX_CACHE"] = os.path.join(os.path.dirname(path),
                                           "jax_cache")
    try:
        res = subprocess.run(
            [sys.executable, "-c", script, *args, tmp, str(os.getpid()),
             str(PREFETCH_NICE if nice else 0)], cwd=REPO, env=env,
            capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return f"no result after {timeout} s"
    if res.returncode != 0:
        return res.stderr[-4000:] or f"exit code {res.returncode}"
    os.replace(tmp, path)
    return None


def _compute(entry, path, nice):
    """Run the child of ``solve_pair`` for ``entry`` into ``path``."""
    return _run_child(_SOLVE_CHILD, [entry], path, nice)


def _replacement_worker():
    """True in an xdist worker started in place of one that crashed: its ids
    run on past the initial count (gw6 with ``-n 6``)."""
    worker = os.environ.get("PYTEST_XDIST_WORKER", "")
    count = os.environ.get("PYTEST_XDIST_WORKER_COUNT", "")
    return (worker.startswith("gw") and count.isdigit()
            and int(worker[2:]) >= int(count))


def _try_lock(path):
    """The open, exclusively locked ``path + ".lock"`` if no process holds
    it and ``path`` is not written yet; else None."""
    lock = open(path + ".lock", "w")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        lock.close()
        return None
    if os.path.exists(path):
        lock.close()
        return None
    return lock


def _wait_lock(path, what):
    """The open ``path + ".lock"``, locked exclusively once its holder (the
    process computing ``what``) releases it; a TimeoutError after
    WAIT_LIMIT seconds, so that a stuck reference fails the tests that need
    it, not the session."""
    lock = open(path + ".lock", "w")
    deadline = time.monotonic() + WAIT_LIMIT
    while True:
        try:
            fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
            return lock
        except OSError:
            if time.monotonic() > deadline:
                lock.close()
                raise TimeoutError(f"{what}: not computed after waiting "
                                   f"{WAIT_LIMIT} s for its holder")
            time.sleep(0.5)


def _prefetch(cache_dir):
    """In the session's first worker to import this module (the holder of
    ``prefetch.lock`` for the life of its process), compute every JAX
    reference of the port's tests, SOLVE_JOBS and then REFERENCE_JOBS, in
    PREFETCH_SLOTS threads, each child niced by PREFETCH_NICE, from the
    session's start: the references are ready when the port's tests, which
    come late in the session, need them, and no worker waits for a child
    started late.  A job another process has taken (its lock) or written
    is skipped; each lock is released as its file is written.  A child
    dies with its worker; a worker started in place of a crashed one
    prefetches nothing (it runs the crashed worker's queue alone while the
    others shut down), and a reference left undone is computed by the
    first test that asks (``solve_pair``, ``reference``)."""
    if _replacement_worker():
        return
    leader = open(os.path.join(cache_dir, "prefetch.lock"), "w")
    try:
        fcntl.flock(leader, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except OSError:
        leader.close()
        return
    _PREFETCH.append(leader)        # held until this process ends
    jobs = [(_SOLVE_CHILD, [e], os.path.join(cache_dir, f"{e}.npz"))
            for e in SOLVE_JOBS]
    jobs += [(_REF_CHILD, j.split(":"), _ref_path(j, cache_dir))
             for j in REFERENCE_JOBS]
    pending = threading.Lock()

    def run():
        while True:
            with pending:
                if not jobs:
                    return
                script, args, path = jobs.pop(0)
                lock = _try_lock(path)
            if lock is None:
                continue
            try:
                _run_child(script, args, path, nice=True)
            finally:
                lock.close()
    for i in range(PREFETCH_SLOTS):
        threading.Thread(target=run, daemon=True,
                         name=f"torch references {i}").start()


_PREFETCH = []


@functools.lru_cache(maxsize=None)
def solve_pair(entry, maxiter, cache_dir):
    """(JAX reference, port) solutions of the reduced walk from the
    quasi-static warm start (sequential line search, no trace: the port's
    scope) as namespaces of numpy leaves: ``entry`` "solve" runs
    ``ct.solve`` and the port's ``solve(device="cpu")`` from x0,
    "solve_batch" both ``solve_batch`` from the B=3 x0s.  Both run in a
    fresh Python process, which computes every maxiter of SOLVE_JOBS[entry]:
    XLA:CPU has crashed compiling or (de)serializing the multi-MB solver
    programs late in long test workers (tests/run_suite.sh), and the port's
    plain CPU solve is the longest torch work of the suite.  The solutions
    go to ``cache_dir`` (the ``solve_cache`` fixture) under a file lock:
    under pytest-xdist the pairs were started when the session began
    (``_prefetch``), so a worker waits at most for the rest of them (a lock
    is released when its holder dies, and its child dies with it; a wait
    longer than WAIT_LIMIT fails the test); a pair that is not there is
    computed by the first worker that asks, at normal priority, since a
    test waits for it."""
    path = os.path.join(cache_dir, f"{entry}.npz")
    with _wait_lock(path, entry):
        if not os.path.exists(path):
            err = _compute(entry, path, nice=False)
            if err is not None:
                raise RuntimeError(f"{entry} failed:\n{err}")
    with np.load(path) as z:
        return tuple(types.SimpleNamespace(**{
            k.split(".", 1)[1]: z[k] for k in z.files
            if k.startswith(f"{tag}{maxiter}.")}) for tag in ("ref", "out"))


# ---------------------------------------------------------------------------
# JAX references computed in child processes, beside the port's own work
# ---------------------------------------------------------------------------

_REF_CHILD = """
import ctypes, importlib, os, signal, sys
ctypes.CDLL(None).prctl(1, int(signal.SIGKILL))
module, name, arg, path, ppid, nice = sys.argv[1:7]
if os.getppid() != int(ppid):
    sys.exit(1)
if int(nice):
    os.nice(int(nice))
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# a persistent compilation cache of this session's children alone
# (``_run_child``): a child is a fresh process that loads a few programs,
# not a long worker
jax.config.update("jax_compilation_cache_dir", os.environ["PARITY_JAX_CACHE"])
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
out = getattr(importlib.import_module(module), name)(arg)
np.savez(path, **out)
"""

# children of ``start_references`` running at once in one process
_REF_SLOTS = threading.BoundedSemaphore(PREFETCH_SLOTS)


def _ref_path(job, cache_dir):
    return os.path.join(cache_dir, "ref_" + job.replace(":", "_") + ".npz")


def start_references(jobs, cache_dir):
    """Compute the JAX references ``jobs`` in child processes, started from
    threads of this process, so that they run beside the port's own
    computations; a job another process has taken (its file lock) or
    finished is skipped (under pytest-xdist, ``_prefetch`` has taken every
    job of REFERENCE_JOBS at the session's start).  At most
    PREFETCH_SLOTS children run at once, niced.  A job is
    ``"module:function:arg"``: the child calls ``module.function(arg)`` and
    saves the dict of numpy arrays it returns.  Read a result with
    ``reference``."""
    def run(job, path, lock):
        try:
            with _REF_SLOTS:
                _run_child(_REF_CHILD, job.split(":"), path, nice=True)
        finally:
            lock.close()
    for job in jobs:
        path = _ref_path(job, cache_dir)
        lock = _try_lock(path)
        if lock is not None:
            threading.Thread(target=run, args=(job, path, lock),
                             daemon=True, name=f"reference {job}").start()


def reference(job, cache_dir):
    """The arrays of the JAX reference ``job`` (see ``start_references``):
    waits for the process computing it (a TimeoutError after WAIT_LIMIT
    seconds), or computes it at normal priority if no one did (its holder
    died)."""
    path = _ref_path(job, cache_dir)
    with _wait_lock(path, job):
        if not os.path.exists(path):
            err = _run_child(_REF_CHILD, job.split(":"), path, nice=False)
            if err is not None:
                raise RuntimeError(f"{job} failed:\n{err}")
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


if _shared_dir():
    _prefetch(_shared_dir())


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


def to_port(obj, classes=None):
    """The port's counterpart of a JAX pytree; ``classes`` names port
    classes the package does not have (a test's own subclasses)."""
    from crocoddyl_tpu_torch.io.convert import problem_from_numpy
    return problem_from_numpy(leaves_of(obj), describe(obj),
                              classes=classes)


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
    return node_case(jax_walk()[0], B)


@functools.lru_cache(maxsize=None)
def _jax_lanes():
    """The JAX lane linearization, jitted once: nodes of the same structure
    and count reuse its executable."""
    from crocoddyl_tpu.ops import fused_node as jfn
    return jax.jit(lambda s, x, u: jfn.calc_both_lanes(s, x, u, "jnp"))


def node_case(prob, B):
    """``jax_node_case`` for the JAX problem ``prob``."""
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
    ref = _jax_lanes()(seg_l, jnp.asarray(xn.T), jnp.asarray(un.T))
    return knots, xn, un, B, ref
