"""Data-parallel batched solving over GPUs with ``torch.distributed`` (port
of crocoddyl_tpu/parallel/mesh.py).

The JAX package shards a ``vmap``ped, jitted ``solve`` over a device mesh
from one controller.  The port's solvers decide on the host, with one
device sync per ladder probe and per line-search trial, so one Python
thread driving several cards would serialize them.  The port's mesh is
therefore the process group: one process (a *rank*) per GPU, each solving
its slice of the batch on its own device, with no communication inside a
solve.  Without an initialized process group the mesh is one rank on the
caller's device (the single-process case).

* :func:`init_distributed` joins the process group (torch's
  ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``
  as ``torchrun`` sets them, or the arguments), NCCL where every rank of
  the host has a card of its own, gloo on the CPU and where ranks share a
  card;
* :func:`data_mesh` describes it; :func:`host_local_batch`,
  :func:`shard_batch` and :func:`replicate` place a rank's slice;
* :func:`sharded_solve_x0` and :func:`batched_solve_fn` solve a rank's
  slice as one batched solve (``fddp.vmap_solve``: ``solve_fn`` called
  once a rank, on its whole slice); :func:`gather` brings the whole batch
  to every rank;
* :func:`fleet_metrics` reduces a batched Solution over the global batch
  with collectives (sums and counts, then ``all_reduce``);
* :func:`spawn` starts ranks on one host, and :func:`dryrun_multichip`
  (the counterpart of ``__graft_entry__.dryrun_multichip``) solves a batch
  of the reduced quadruped walk over them.

Run over several cards with ``torchrun --nproc_per_node=N script.py``
(``init_distributed()`` reads the variables torchrun sets), or with
:func:`spawn` from one process.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue
import socket
import time
import traceback
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.struct import tree_leaves, tree_map

# how long a collective (and the rendezvous) waits for a rank that never
# arrives before it fails the run
TIMEOUT = 600.0

_local = {}     # this process's device, set by init_distributed


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The data mesh as this rank sees it: ``size`` ranks, this one
    ``rank``, solving on ``device``."""

    size: int
    rank: int
    device: torch.device

    @property
    def distributed(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend() if self.distributed else None


def _world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     local_device_ids=None, device=None,
                     timeout: float = TIMEOUT) -> int:
    """Join the process group and return this process's rank.

    The arguments first, then torch's variables: ``coordinator_address``
    ``host:port`` (``MASTER_ADDR``:``MASTER_PORT``), ``num_processes``
    (``WORLD_SIZE``), ``process_id`` (``RANK``).  The card this rank takes:
    ``device``, else the first of ``local_device_ids``, else
    ``LOCAL_RANK``, else the rank, modulo the host's cards;
    ``device="cpu"`` runs the rank on the CPU, and without it a machine
    with no card raises, as the solvers do.  The backend is NCCL where
    every rank on this host (``LOCAL_WORLD_SIZE``, else the world) has a
    card of its own, gloo on the CPU and where ranks share a card (NCCL
    refuses two ranks on one card).  A rank that never arrives fails the
    rendezvous and every collective after ``timeout`` seconds."""
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator_address is None:
        raise ValueError("init_distributed: no coordinator address (pass "
                         "one, or set MASTER_ADDR and MASTER_PORT)")
    world = (num_processes if num_processes is not None
             else int(env["WORLD_SIZE"]))
    rank = process_id if process_id is not None else int(env["RANK"])
    if device is not None and torch.device(device).type == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device: the ranks run on the "
                "card unless the caller passes device='cpu'")
        n_cards = torch.cuda.device_count()
        if device is not None:
            local = torch.device(device).index or 0
        elif local_device_ids is not None:
            local = int(np.atleast_1d(local_device_ids)[0])
        else:
            local = int(env.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % n_cards)
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        backend = "nccl" if local_world <= n_cards else "gloo"
        torch.cuda.set_device(dev)
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    _local["device"] = dev
    return dist.get_rank()


def data_mesh(n_devices: Optional[int] = None, device=None) -> DataMesh:
    """The mesh of the process group (one rank if there is none).  The JAX
    version takes the first ``n_devices`` devices; here ``n_devices`` must
    be the world size.  ``device`` defaults to this rank's device from
    :func:`init_distributed`, else the CUDA device (``device="cpu"`` for
    the CPU)."""
    size, rank = _world()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"data_mesh: {n_devices} devices asked for, the "
                         f"process group has {size} ranks")
    if device is None:
        device = _local.get("device")
    if device is None:
        from ..core.solvers.fddp import resolve_device
        device = resolve_device(None)
    return DataMesh(size=size, rank=rank, device=torch.device(device))


def _slice(global_batch: int, n: int, i: int):
    """(start, length) of part ``i`` of ``n``: the remainder goes to the
    first ranks, so every problem is assigned exactly once."""
    per, rem = divmod(global_batch, n)
    return i * per + min(i, rem), per + (1 if i < rem else 0)


def host_local_batch(global_batch: int, axis_size: Optional[int] = None):
    """This rank's slice ``(start, length)`` of a global batch over
    ``axis_size`` ranks (default: the world size)."""
    size, rank = _world()
    return _slice(global_batch, size if axis_size is None else axis_size,
                  rank)


def _batch_size(tree) -> int:
    return int(tree_leaves(tree)[0].shape[0])


def shard_batch(tree, mesh: DataMesh):
    """This rank's slice of the leading axis of every leaf, on its
    device."""
    start, n = _slice(_batch_size(tree), mesh.size, mesh.rank)
    return tree_map(lambda l: l[start:start + n].to(mesh.device), tree)


def replicate(tree, mesh: DataMesh):
    """The tree on this rank's device (problem constants)."""
    return tree_map(lambda l: l.to(mesh.device), tree)


def _map(fn, *trees):
    """``fn`` over the tensors of same-structure trees of dataclasses,
    tuples, lists and dicts (a Solution and its Trace); other values from
    the first tree."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if dataclasses.is_dataclass(t) and not isinstance(t, type):
        return dataclasses.replace(t, **{
            f.name: _map(fn, *(getattr(x, f.name) for x in trees))
            for f in dataclasses.fields(t) if f.init})
    if isinstance(t, (tuple, list)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in t}
    return t


def _tensors(tree):
    out = []
    _map(lambda x: out.append(x) or x, tree)
    return out


def _local_problems(mesh, n, what):
    if n == 0:
        raise ValueError(f"{what}: rank {mesh.rank} of {mesh.size} has no "
                         f"problem (fewer problems than ranks)")


def sharded_solve_x0(solve_fn: Callable, problem, mesh: DataMesh,
                     batched: bool = False):
    """One problem replicated, a batch of initial states sharded.  Returns
    ``run(x0s)``: from the global ``(B, nx)`` initial states, this rank's
    slice solved on its device, as one Solution with a leading batch axis.
    ``solve_fn(problem)`` is called once, under ``vmap_solve``, on the
    problem batched over the slice's initial states (the JAX version
    ``vmap``s it); with ``batched=True``, ``solve_fn(problem, x0s)`` takes
    the whole slice at once (``solve_batch``)."""
    from ..core.solvers.fddp import vmap_solve
    problem = replicate(problem, mesh)

    def run(x0s):
        x0s = shard_batch(x0s, mesh)
        n = x0s.shape[0]
        _local_problems(mesh, n, "sharded_solve_x0")
        if batched:
            return solve_fn(problem, x0s)
        problems = tree_map(lambda l: l.expand((n,) + l.shape),
                            problem).replace(x0=x0s)
        return vmap_solve(solve_fn)(problems)

    return run


def batched_solve_fn(solve_fn: Callable, mesh: DataMesh):
    """``run(problems)`` over a problem whose every leaf carries a leading
    batch axis: this rank solves its slice as one batch, one call of
    ``solve_fn`` under ``vmap_solve``, and returns its results with the
    leading axis."""
    from ..core.solvers.fddp import vmap_solve

    def run(problems):
        _local_problems(mesh, _slice(_batch_size(problems), mesh.size,
                                     mesh.rank)[1], "batched_solve_fn")
        return vmap_solve(solve_fn)(shard_batch(problems, mesh))

    return run


def _collective_device(mesh: DataMesh):
    """Where a collective's tensors live: on the card under NCCL, on the
    CPU under gloo (its CUDA support is partial)."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def gather(tree, mesh: DataMesh):
    """The whole batch on every rank, in rank order (``all_gather`` of
    every tensor's leading axis; the shards may differ in size)."""
    if not mesh.distributed:
        return tree
    cdev = _collective_device(mesh)
    leaves = _tensors(tree)
    n = torch.tensor([leaves[0].shape[0]], dtype=torch.int64, device=cdev)
    sizes = [torch.empty_like(n) for _ in range(mesh.size)]
    dist.all_gather(sizes, n)
    sizes = [int(s) for s in sizes]
    top = max(sizes)

    def one(x):
        y = x.to(cdev)
        if y.dtype == torch.bool:       # NCCL and gloo move bytes
            y = y.to(torch.uint8)
        pad = y.new_zeros((top - y.shape[0],) + tuple(y.shape[1:]))
        y = torch.cat([y, pad]).contiguous()
        parts = [torch.empty_like(y) for _ in range(mesh.size)]
        dist.all_gather(parts, y)
        out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
        return out.to(device=mesh.device, dtype=x.dtype)

    return _map(one, tree)


def fleet_metrics(solution, mesh: Optional[DataMesh] = None) -> dict:
    """Fleet statistics of a batched Solution over the global batch:
    ``mean_cost``, ``max_cost``, ``mean_iters``, ``converged_frac`` and
    ``diverged_frac``.  Over a mesh of several ranks each rank sums its
    shard, then ``all_reduce`` adds the sums and counts (the shards may
    differ in size, so the per-rank means are not averaged) and takes the
    maximum."""
    cost = solution.cost
    sums = torch.stack([
        cost.double().sum(), torch.tensor(float(cost.numel()),
                                          dtype=torch.float64,
                                          device=cost.device),
        solution.iter.double().sum(), solution.converged.double().sum(),
        solution.diverged.double().sum()])
    top = cost.max().double()
    if mesh is not None and mesh.distributed:
        cdev = _collective_device(mesh)
        sums, top = sums.to(cdev), top.to(cdev)
        dist.all_reduce(sums, op=dist.ReduceOp.SUM)
        dist.all_reduce(top, op=dist.ReduceOp.MAX)
        sums, top = sums.to(cost.device), top.to(cost.device)
    n = sums[1].float()
    return {"mean_cost": (sums[0] / sums[1]).to(cost.dtype),
            "max_cost": top.to(cost.dtype),
            "mean_iters": sums[2].float() / n,
            "converged_frac": sums[3].float() / n,
            "diverged_frac": sums[4].float() / n}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, nprocs, port, device, timeout, args, results):
    """One spawned rank: join the group as local rank ``rank`` of
    ``nprocs`` on this host, run ``fn(rank, *args)``, send (rank, ok,
    result or traceback) to the parent."""
    os.environ.update(LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs))
    try:
        init_distributed(f"localhost:{port}", nprocs, rank, device=device,
                         timeout=timeout)
        out = _map(lambda t: t.detach().cpu().numpy(), fn(rank, *args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn: Callable, nprocs: int, args=(), device=None,
          timeout: float = TIMEOUT):
    """Run ``fn(rank, *args)`` on ``nprocs`` ranks of one host, each a
    process started with the spawn method (CUDA cannot be used after a
    fork) that has joined the process group (``init_distributed`` on a free
    localhost port), and return their results in rank order.  ``fn`` is a
    module-level function; the tensors of its result come back as numpy
    arrays.  Rank r takes card ``r`` modulo the host's cards, as
    ``init_distributed`` places a local rank: more ranks than cards share
    them and talk over gloo; ``device="cpu"`` runs gloo ranks on the CPU.
    A rank that fails or does not finish within ``timeout`` seconds raises
    here, and the other ranks are ended."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, port, device, timeout, args,
                               results))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        while len(got) < nprocs:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in got]
                if dead:
                    raise RuntimeError(f"spawn: ranks {dead} (rank, exit "
                                       f"code) ended without a result")
                if time.monotonic() > deadline:
                    missing = sorted(set(range(nprocs)) - set(got))
                    raise TimeoutError(f"spawn: no result from ranks "
                                       f"{missing} after {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"spawn: rank {rank} failed:\n{out}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=30 if len(got) == nprocs else 0.1)
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(nprocs)]


def dryrun_rank(rank: int, n_devices: int, device=None) -> dict:
    """One rank of :func:`dryrun_multichip`: the reduced quadruped walk
    (``step_knots=1, support_knots=1``, float32, __graft_entry__.py:14-27),
    ``B = 2·n_devices`` initial states with seeded velocity perturbations,
    this rank's slice solved by ``solve_batch(maxiter=1)``, the costs
    gathered and the fleet metrics reduced over the ranks; the report
    holds the rank's kernel launches."""
    from ..apps.gaits import QuadrupedGaitFactory
    from ..core.solvers.fddp import SolverSettings
    from ..core.solvers.fddp_batch import solve_batch
    from ..dynamics import robots
    from ..ops import cuda_kernels
    from ..utils.casting import cast_floats

    torch.set_num_threads(1)
    mesh = data_mesh(n_devices)
    f32 = torch.float32
    m = robots.quadruped(dtype=torch.float64)
    q0 = robots.quadruped_standing_q(m)
    x0 = torch.cat([q0, torch.zeros(m.nv, dtype=torch.float64)])
    fac = QuadrupedGaitFactory(m, ["LF_FOOT", "RF_FOOT", "LH_FOOT",
                                   "RH_FOOT"], default_q=q0)
    prob = fac.walking_problem(x0, 0.1, 0.05, 1e-2, step_knots=1,
                               support_knots=1)
    xs0 = x0[None].expand(prob.T + 1, -1).clone()
    us0 = prob.quasi_static(xs0)
    B = 2 * n_devices
    x0s = np.tile(x0.numpy()[None], (B, 1))
    x0s[:, m.nq:] += 0.01 * np.random.default_rng(0).standard_normal(
        (B, m.nv))
    settings = SolverSettings(maxiter=1, record_trace=False,
                              parallel_linesearch=False)
    run = sharded_solve_x0(
        lambda p, xs: solve_batch(p, xs, xs_init=xs0.to(mesh.device, f32),
                                  us_init=us0.to(mesh.device, f32),
                                  settings=settings, device=mesh.device),
        cast_floats(prob, f32), mesh, batched=True)
    sol = run(torch.tensor(x0s, dtype=f32))
    costs = gather(sol.cost, mesh)
    if costs.shape != (B,):
        raise RuntimeError(f"dryrun: costs of shape {tuple(costs.shape)}, "
                           f"not ({B},)")
    if bool(torch.isnan(costs).any()):
        raise RuntimeError("dryrun: NaN cost")
    metrics = fleet_metrics(sol, mesh)
    return {"rank": rank, "device": str(mesh.device),
            "backend": mesh.backend, "costs": costs.cpu().numpy(),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "launches": {w.__name__: w.launches
                         for w in cuda_kernels.WRAPPERS}}


def dryrun_multichip(n_devices: int, device=None,
                     timeout: float = TIMEOUT) -> list:
    """Shard a batch of the reduced quadruped walk over ``n_devices`` ranks
    and run one solve step end to end (__graft_entry__.py:55-91): each
    rank takes its own card (NCCL), or with ``device="cpu"`` runs on the
    CPU (gloo).  Returns each rank's report; a failing rank raises."""
    if device is None and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip: {n_devices} ranks asked for, "
                           f"{torch.cuda.device_count()} cards present")
    return spawn(dryrun_rank, n_devices, args=(n_devices, device),
                 device=device, timeout=timeout)
