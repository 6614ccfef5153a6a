"""A pytest plugin that orders the session's tests for pytest-xdist's
``--dist load`` so that no worker is handed a long run of the suite's
longest tests.

``--dist load`` first hands each of the W workers a chunk of
``N // W // 4`` consecutive tests (N collected; ``first_chunk``, the rule
of pytest-xdist 3.8.0's ``LoadScheduling.schedule``, which
tests/test_torch_xla_mappings.py holds), then, as a worker's queue runs
low, more consecutive tests.  In collection order the longest tests
sit together: tests/conftest.py puts the seven tests of tests/test_gaits.py
first (five of them take 140-240 s each, ~1065 s in all), so with N ≈ 420
and W = 6 the first worker's chunk of 17 held all seven, and
tests/test_examples_golden.py holds ~20 solves of 60-270 s in a row (test
times of the tier-1 run, 6 workers, before this plugin).

This plugin keeps the order of tests/conftest.py's front group in its own
way: the gait tests head the first chunks, one a worker, each first in its
process as conftest.py wants (their first compile writes the persistent
cache from a fresh heap).  The JAX package's other tests that take 100 s
or more (``SLOW``, longest first) head the next chunks, one each.  The
other tests of the JAX package follow,
each module's spread evenly over their order, so that consecutive tests
come from different modules; a module with a module-scoped fixture of its
own (a problem built once for its tests) stays one block, and the blocks
are spread evenly too.  The port's tests (tests/test_torch_*.py) come
last: they are short once their
JAX references are computed (tests/_torch_parity.py starts those at the
session's start), and fill the workers' tails, the longest of them
(``PORT_FIRST``) first.  It changes which worker
runs a test and when, never a test.  Without xdist it changes nothing.

Each part counts.  Replayed through xdist's scheduling rules with the
test times of a tier-1 run of this order (6 workers, 424 tests, 6413 s of
tests, 1116 s in fact), the order ends in 1092 s; the collection's own
order in 1271 s; this order without LONG (every module spread over the
whole order) in 1298 s; and the gait tests at the chunks' heads with the
rest in collection order and the port's tests last in 1582 s.
``SLOW`` came when the suite grew to 449 tests, whose first chunk is 18
tests, not 17: replayed with the test times of a tier-1 run of 449 tests
(6884 s of tests, 1147 s on six workers if perfectly shared), the order
without ``SLOW`` ends in 1324 s (1350 s in fact: a 245-s test started
1009 s in), with it in 1184 s; over the 426 tests without the three
modules that came then, in 1143 s without it and 1178 s with it.

Registered through ``pytest_plugins`` by tests/test_torch_xla_mappings.py,
so every process that collects the suite loads it, and every worker orders
the same collection alike.
"""

from __future__ import annotations

import os

import pytest


# the JAX package's modules whose tests took longest in the tier-1 run
# (their tests' times summed: test_examples_golden.py ~1700 s,
# test_rh5.py ~600 s, of ~6500 s in all), and the blocks: spread over the
# first EARLY of the order, so that no long test starts near the end
LONG = ("tests/test_examples_golden.py", "tests/test_rh5.py")
EARLY = 0.8
# the JAX package's other tests that took 100 s or more in a tier-1 run
# (6 workers; 128-268 s each), longest first: each heads a chunk after the
# gait tests, so that none starts late and no worker is handed two at once
_G = "tests/test_examples_golden.py::test_example_matches_golden"
SLOW = ("tests/test_rh5.py::test_zmp_and_cop_analysis",
        f"{_G}[bipedal_walk_cop_fast]",
        "tests/test_fused_scans.py::test_solve_with_fused_scans_matches",
        "tests/test_rh5.py::test_squat_problem_structure_and_solve",
        "tests/test_fddp_batch.py::test_matches_vmapped_solve[1]",
        f"{_G}[humanoid_taichi_fast]",
        f"{_G}[bipedal_walk_fast]",
        f"{_G}[humanoid_manipulation_ubound_fast]",
        f"{_G}[humanoid_manipulation_fast]",
        f"{_G}[bipedal_walk_changing_gait_fast]",
        f"{_G}[quadrupedal_walk_ubound_fast]",
        "tests/test_rh5.py::test_balancing_problem_structure",
        f"{_G}[quadrupedal_walking_fast]",
        "tests/test_fused_node.py::test_solve_with_fused_path",
        "tests/test_kin_tangents.py::test_tangent_basis_feeds_node_derivatives")


# the port's tests that take 10 s or more once their JAX references are
# in: the exports of whole solves (the walk's replans and batch step, the
# unicycle's solve, the solves over nodes outside kernel 1) and the
# batched solves held to their single solves, longest first; they head
# the port's tests, so that none starts near the end
_S = "tests/test_torch_solve.py::test_export_walk_round_trip"
_K = "tests/test_torch_aot.py::test_export_solve_round_trip_node_kinds"
_V = "tests/test_torch_vmap_solve.py::test_walk_gains_match_single_solves"
PORT_FIRST = (f"{_V}[sequential_trace]", f"{_V}[fused_scans]",
              f"{_S}[solve_batch]", f"{_S}[fused_scans]",
              "tests/test_torch_aot.py::test_export_solve_round_trip",
              f"{_V}[default]", f"{_V}[box_fddp]", f"{_V}[ddp]",
              f"{_S}[default]", f"{_K}[impulse_walk]",
              "tests/test_torch_vmap_solve.py::test_segmented_batch",
              f"{_K}[generic_running]", f"{_K}[generic_terminal]")


def _module(item) -> str:
    return item.nodeid.split("::", 1)[0]


def _module_scoped(item) -> bool:
    """True if the test uses a fixture of module (or wider) scope."""
    info = getattr(item, "_fixtureinfo", None)
    defs = info.name2fixturedefs.values() if info is not None else ()
    return any(d.scope in ("module", "package", "session")
               for ds in defs for d in ds
               if d.baseid and d.baseid.split("::")[0] == _module(item))


def spread(items):
    """``items`` with each module's tests spread evenly over the order, in
    their own order: the k-th of a module's n tests at the fraction
    (k + ½)/n, ties in order of the modules' first appearance; the tests of
    a module with a module-scoped fixture of its own stay one block, the
    blocks at the fractions j/(b + 1); the blocks and the LONG modules'
    tests within the first EARLY of the order."""
    queues = {}
    for it in items:
        queues.setdefault(_module(it), []).append(it)
    units = []
    blocks = [q for q in queues.values()
              if any(_module_scoped(it) for it in q)]
    for i, (m, q) in enumerate(queues.items()):
        if q in blocks:
            units.append((EARLY * (blocks.index(q) + 1) / (len(blocks) + 1),
                          i, q))
        else:
            f = EARLY if m in LONG else 1.0
            units += [(f * (k + 0.5) / len(q), i, [it])
                      for k, it in enumerate(q)]
    units.sort(key=lambda u: u[:2])
    return [it for _, _, unit in units for it in unit]


def first_chunk(n, workers):
    """The tests pytest-xdist's ``--dist load`` first hands each of
    ``workers`` workers out of ``n``."""
    return max(2, n // workers // 4)


def schedule(items, workers):
    """The order of ``items`` for ``workers`` xdist workers (see the module
    docstring)."""
    slow = {n: i for i, n in enumerate(SLOW)}
    front = ([it for it in items if "test_gaits" in it.nodeid]
             + sorted((it for it in items if it.nodeid in slow),
                      key=lambda it: slow[it.nodeid]))
    first = {n: i for i, n in enumerate(PORT_FIRST)}
    port = sorted((it for it in items if _module(it).split("/")[-1]
                   .startswith("test_torch_")),
                  key=lambda it: first.get(it.nodeid, len(first)))
    taken = {id(it) for it in front + port}
    rest = spread([it for it in items if id(it) not in taken]) + port
    chunk = first_chunk(len(items), workers)
    out, r = [], 0
    for i, it in enumerate(front):
        fill = max(0, i * chunk - len(out))    # to the head of chunk i
        out += rest[r:r + fill]
        r += fill
        out.append(it)
    return out + rest[r:]


@pytest.hookimpl(trylast=True)
def pytest_collection_modifyitems(session, config, items):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT", "")
    if workers.isdigit() and int(workers) > 1:
        items[:] = schedule(items, int(workers))
