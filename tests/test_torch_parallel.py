"""The port's data-parallel layer (crocoddyl_tpu_torch/parallel/mesh.py)
against one process and against the JAX package, float64 on the CPU.

Two gloo ranks, spawned (``parallel.spawn``), each with one thread, run
everything of tests/_torch_fleet.py.rank_all at once, while this process
computes the same solves unsharded:

- the 16 unicycle solves of tests/test_mesh.py:22-35 (T=20,
  ``maxiter=40``), sharded by ``sharded_solve_x0`` and gathered, equal to
  the one-process solves at the bars of tests/test_mesh.py:46-58 (equal
  iterations, cost rtol 1e-12, controls atol 1e-10), and to JAX's
  ``vmap``ped ``ct.solve`` (equal decisions, cost rtol 1e-8, controls
  atol 1e-6);
- ``fleet_metrics`` over the two ranks: over the uneven first 7 solves (4
  and 3 a rank) equal to the one-process value (mean cost rtol 1e-14,
  fractions equal), over all 16 equal to JAX's ``fleet_metrics`` (rtol
  1e-8, fractions equal);
- ``batched_solve_fn`` over a problem whose leaves carry a batch axis;
- the reduced walk, B=4, split 2+2 through ``solve_batch``: each rank's
  slice equals the one-process ``solve_batch`` of that slice, and the
  gathered batch the one-process B=4 solve in every decision, cost rtol
  1e-8 (the plain versions' rounding depends on the batch width, and the
  walk's Riccati pass, cond(Quu) ~1e6, amplifies it: the B=4 and the two
  B=2 solves differ by 7.6e-10 in cost on this CPU);

and ``host_local_batch``'s arithmetic, the single-process mesh, and
``dryrun_multichip(2, device="cpu")``.  The JAX reference runs in a child
process (``start_references``).
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import _torch_fleet as fleet
from tests._torch_parity import _no_persistent_cache  # noqa: F401
from tests._torch_parity import solve_cache  # noqa: F401
from tests._torch_parity import np_, reference, start_references

DECISIONS = ("iter", "steplength", "is_feasible", "converged", "diverged")
FRACTIONS = ("mean_iters", "converged_frac", "diverged_frac")


def x0s_of_test_mesh():
    """tests/test_mesh.py:29-33."""
    key = jax.random.PRNGKey(0)
    return np.array(jnp.asarray([-1.0, -1.0, 1.0])
                    + 0.1 * jax.random.normal(key, (16, 3)))


def jax_reference(job):
    """The JAX side (the child of ``start_references`` calls this): the
    ``vmap``ped solves of tests/test_mesh.py:49-50 and their
    ``fleet_metrics``."""
    import crocoddyl_tpu as ct
    from crocoddyl_tpu.core.problem import ShootingProblem
    from crocoddyl_tpu.models.unicycle import UnicycleModel
    from crocoddyl_tpu.parallel import mesh as pmesh
    m = UnicycleModel()
    prob = ShootingProblem(x0=jnp.asarray([-1.0, -1.0, 1.0]),
                           running=ct.replicate_model(m, 20), terminal=m)
    settings = ct.SolverSettings(maxiter=fleet.UNICYCLE_MAXITER,
                                 record_trace=False)
    sol = jax.jit(jax.vmap(lambda x0: ct.solve(prob.replace(x0=x0),
                                               settings=settings)))(
        jnp.asarray(x0s_of_test_mesh()))
    out = {f: getattr(sol, f) for f in ("xs", "us", "cost") + DECISIONS}
    out.update({f"metrics.{k}": v
                for k, v in pmesh.fleet_metrics(sol).items()})
    return {k: np.asarray(v) for k, v in out.items()}


JOBS = {"unicycle": "tests.test_torch_parallel:jax_reference:unicycle"}


@pytest.fixture(scope="module", autouse=True)
def _references(solve_cache):
    start_references(JOBS.values(), solve_cache)
    return solve_cache


def _one_process(x0s):
    """The unsharded solves, in this process: the 16 unicycles as one
    batched solve (``vmap_solve``, as tests/test_mesh.py:49-50 ``vmap``s
    them), and the reduced walk's B=4 solve and its two B=2 halves."""
    from crocoddyl_tpu_torch import vmap_solve
    from crocoddyl_tpu_torch.utils.struct import tree_map
    prob = fleet.unicycle_problem()
    x0s = torch.as_tensor(x0s)
    uni = vmap_solve(fleet.unicycle_solve)(tree_map(
        lambda l: l.expand((len(x0s),) + l.shape), prob).replace(x0=x0s))
    wprob, xs0, us0, wx0s = fleet.walk()
    half = fleet.B_WALK // 2
    walks = [fleet.walk_solve(wprob, xs, xs0, us0)
             for xs in (wx0s, wx0s[:half], wx0s[half:])]
    return uni, walks


@pytest.fixture(scope="module")
def runs():
    """(the two ranks' reports, the one-process solves): the ranks run in
    a thread of this process while it computes the one-process solves."""
    from crocoddyl_tpu_torch.parallel import spawn
    x0s = x0s_of_test_mesh()
    got = {}

    def ranks():
        try:
            got["ranks"] = spawn(fleet.rank_all, 2, args=(x0s,),
                                 device="cpu", timeout=300)
        except BaseException as e:      # re-raised below
            got["error"] = e

    th = threading.Thread(target=ranks)
    th.start()
    try:
        one = _one_process(x0s)
    finally:
        th.join()
    if "error" in got:
        raise got["error"]
    return got["ranks"], one


def test_ranks_form_the_mesh(runs):
    ranks, _ = runs
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert (r["size"], r["backend"], r["device"]) == (2, "gloo", "cpu")
    assert [r["slice"] for r in ranks] == [(0, 8), (8, 8)]
    assert [r["uneven_local"] for r in ranks] == [4, 3]


def test_sharded_equals_unsharded(runs):
    """tests/test_mesh.py:46-58 over two gloo ranks: both ranks gather the
    one-process solutions."""
    ranks, (uni, _) = runs
    for r in ranks:
        got = r["unicycle"]
        assert np.array_equal(got["iter"], np_(uni.iter))
        np.testing.assert_allclose(got["cost"], np_(uni.cost), rtol=1e-12)
        np.testing.assert_allclose(got["us"], np_(uni.us), rtol=0,
                                   atol=1e-10)
    np.testing.assert_array_equal(ranks[0]["local_cost"],
                                  np_(uni.cost)[:8])
    np.testing.assert_array_equal(ranks[1]["local_cost"],
                                  np_(uni.cost)[8:])


def test_sharded_against_jax(runs, _references):
    """The 16 sharded solves against JAX's ``vmap``ped ``ct.solve``: the
    same decisions, cost rtol 1e-8, controls atol 1e-6."""
    ranks, _ = runs
    ref = reference(JOBS["unicycle"], _references)
    got = ranks[0]["unicycle"]
    for f in DECISIONS:
        assert np.array_equal(got[f], ref[f]), f
    assert bool(ref["converged"].all())
    np.testing.assert_allclose(got["cost"], ref["cost"], rtol=1e-8)
    np.testing.assert_allclose(got["us"], ref["us"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got["xs"], ref["xs"], rtol=0, atol=1e-6)


def test_fleet_metrics_over_uneven_shards(runs):
    """B=7 over two ranks (4 + 3): the collective sums and counts give the
    one-process metrics, on both ranks."""
    from crocoddyl_tpu_torch.parallel import fleet_metrics
    from crocoddyl_tpu_torch.parallel.mesh import _map
    ranks, (uni, _) = runs
    want = fleet_metrics(_map(lambda t: t[:fleet.B_UNEVEN], uni))
    for r in ranks:
        got = r["metrics_uneven"]
        assert abs(float(got["mean_cost"]) - float(want["mean_cost"])) \
            <= 1e-14 * abs(float(want["mean_cost"]))
        assert float(got["max_cost"]) == float(want["max_cost"])
        for k in FRACTIONS:
            assert float(got[k]) == float(want[k]), k
    # the per-rank means would not give it: the shards differ in size
    halves = np_(uni.cost)[:4].mean(), np_(uni.cost)[4:7].mean()
    assert abs(np.mean(halves) - float(want["mean_cost"])) > 1e-6


def test_fleet_metrics_against_jax(runs, _references):
    ranks, _ = runs
    ref = reference(JOBS["unicycle"], _references)
    for r in ranks:
        got = r["metrics"]
        for k in ("mean_cost", "max_cost"):
            np.testing.assert_allclose(got[k], ref[f"metrics.{k}"],
                                       rtol=1e-8)
        for k in FRACTIONS:
            assert float(got[k]) == float(ref[f"metrics.{k}"]), k
        assert got["converged_frac"] == 1.0 and got["diverged_frac"] == 0.0


@pytest.mark.parametrize("B", [7, 8, 16])
def test_host_local_batch(B):
    """Over 1-4 ranks every problem is assigned exactly once, the remainder
    to the first ranks; the single process's slice is JAX's."""
    from crocoddyl_tpu.parallel import mesh as jmesh
    from crocoddyl_tpu_torch.parallel import host_local_batch
    from crocoddyl_tpu_torch.parallel.mesh import _slice
    for n in range(1, 5):
        parts = [_slice(B, n, i) for i in range(n)]
        owned = [j for s, ln in parts for j in range(s, s + ln)]
        assert owned == list(range(B)), (n, parts)
        assert max(ln for _, ln in parts) - min(ln for _, ln in parts) <= 1
        assert host_local_batch(B, n) == parts[0] == tuple(
            jmesh.host_local_batch(B, n))


def test_batched_solve_fn(runs):
    """A problem whose every leaf carries a batch axis, 3 elements a rank:
    the gathered costs are the one-process solves'."""
    ranks, (uni, _) = runs
    want = np_(uni.cost)[:fleet.B_PROBLEMS]
    assert [len(r["batched_local"]) for r in ranks] == [3, 3]
    for r in ranks:
        assert r["batched"].shape == (fleet.B_PROBLEMS,)
        np.testing.assert_allclose(r["batched"], want, rtol=1e-12)


def test_walk_split_slices(runs):
    """Each rank's slice of the reduced walk through ``solve_batch`` is
    the one-process solve of that slice: splitting the batch changes no
    problem's decisions (the ladder's unmasked probes and the global alpha
    ladder of fddp_batch.py act per lane)."""
    ranks, (_, (_, lo, hi)) = runs
    for r, want in zip(ranks, (lo, hi)):
        got = r["walk_local"]
        for f in DECISIONS:
            assert np.array_equal(got[f], np_(getattr(want, f))), f
        np.testing.assert_allclose(got["cost"], np_(want.cost), rtol=1e-12)
        np.testing.assert_allclose(got["us"], np_(want.us), rtol=0,
                                   atol=1e-10)


def test_walk_split_equals_one_process(runs):
    """The gathered 2+2 split of the reduced walk against the one-process
    B=4 ``solve_batch``: the same decisions on both ranks, cost rtol 1e-8
    (the plain versions' batch-width rounding, see the module's
    docstring)."""
    ranks, (_, (whole, _, _)) = runs
    for r in ranks:
        got = r["walk"]
        assert got["cost"].shape == (fleet.B_WALK,)
        for f in DECISIONS:
            assert np.array_equal(got[f], np_(getattr(whole, f))), f
        np.testing.assert_allclose(got["cost"], np_(whole.cost), rtol=1e-8)
        assert np.all(np.isfinite(got["xs"]))


def test_single_process_mesh(monkeypatch):
    """Without a process group the mesh is one rank on the caller's device:
    sharding, gathering and the metrics are the identity's."""
    from crocoddyl_tpu_torch.parallel import (data_mesh, fleet_metrics,
                                              gather, init_distributed,
                                              replicate, shard_batch)
    mesh = data_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
    assert not mesh.distributed and mesh.backend is None
    with pytest.raises(ValueError):
        data_mesh(2, device="cpu")
    x = torch.arange(12.0, dtype=torch.float64).reshape(4, 3)
    assert torch.equal(shard_batch(x, mesh), x)
    assert torch.equal(replicate(x, mesh), x)
    assert gather(x, mesh) is x
    from crocoddyl_tpu_torch.core.solvers.fddp import Solution
    sol = Solution(*([None] * 8), cost=x[:, 0], stop=None, xreg=None,
                   ureg=None, steplength=None, d0=None, d1=None,
                   iter=torch.tensor([1, 2, 3, 4], dtype=torch.int32),
                   is_feasible=None,
                   converged=torch.tensor([True, True, False, True]),
                   diverged=torch.tensor([False, False, False, True]))
    m = fleet_metrics(sol)
    assert float(m["mean_cost"]) == 4.5 and float(m["max_cost"]) == 9.0
    assert (float(m["mean_iters"]), float(m["converged_frac"]),
            float(m["diverged_frac"])) == (2.5, 0.75, 0.25)
    for k in ("MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError):
        init_distributed(num_processes=1, process_id=0, device="cpu")


def test_dryrun_multichip_cpu():
    """The counterpart of __graft_entry__.dryrun_multichip on two gloo
    ranks: B=4 perturbed states of the reduced quadruped walk, costs of
    shape (4,), finite, the same on both ranks."""
    from crocoddyl_tpu_torch.parallel import dryrun_multichip
    reports = dryrun_multichip(2, device="cpu", timeout=300)
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["backend"] == "gloo" and r["costs"].shape == (4,)
        assert np.all(np.isfinite(r["costs"]))
        np.testing.assert_array_equal(r["costs"], reports[0]["costs"])
        assert r["metrics"]["mean_iters"] == 1.0
    np.testing.assert_allclose(reports[0]["metrics"]["mean_cost"],
                               reports[0]["costs"].astype(np.float64).mean(),
                               rtol=1e-6)
