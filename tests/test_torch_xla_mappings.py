"""The plugin that keeps test processes under the limit on memory mappings
(tests/_xla_mappings.py): the port's tests compile their JAX references in
the same long pytest-xdist workers as the JAX package's own tests, and a
worker that holds more executables than the kernel allows mappings for
dies in XLA.  This module registers the plugin for the whole session, and
with it the plugin that orders the session's tests for pytest-xdist
(tests/_torch_schedule.py)."""

import types

import jax
import jax.numpy as jnp
import pytest

pytest_plugins = ("tests._xla_mappings", "tests._torch_schedule")


@pytest.fixture
def xm(request):
    """The plugin module, as the session registered it."""
    plugin = request.config.pluginmanager.get_plugin("tests._xla_mappings")
    assert plugin is not None
    return plugin


def test_plugin_is_registered(xm):
    assert callable(xm.pytest_runtest_teardown)


def test_release_frees_the_executables_jax_held(xm):
    """Executables that only JAX's caches hold give their mappings back."""
    xm.release()
    before = xm.mappings()
    fs = [jax.jit(lambda x, i=i: jnp.sin(x) * i + jnp.cumsum(x) @ x)
          for i in range(40)]
    for i, f in enumerate(fs):
        f(jnp.ones(8 + i)).block_until_ready()
    grown = xm.mappings() - before
    assert grown > 40, grown
    del fs, f
    xm.release()
    assert xm.mappings() - before < grown / 2, (grown, xm.mappings())


@pytest.mark.parametrize("held, released", [(100, False), (101, True)])
def test_teardown_releases_over_half_the_limit(xm, monkeypatch, held,
                                              released):
    calls = []
    monkeypatch.setattr(xm, "budget", lambda: 100)
    monkeypatch.setattr(xm, "mappings", lambda: held)
    monkeypatch.setattr(xm, "release", lambda: calls.append(1))
    xm.pytest_runtest_teardown(None, None)
    assert bool(calls) == released


def test_budget_is_half_the_system_limit(xm):
    with open(xm.MAX_MAP_COUNT) as f:
        assert xm.budget() == int(f.read()) // 2
    assert 0 < xm.mappings() < 2 * xm.budget()


@pytest.fixture
def sched(request):
    plugin = request.config.pluginmanager.get_plugin("tests._torch_schedule")
    assert plugin is not None
    return plugin


def test_schedule_orders_the_collection(sched):
    """The order for 6 xdist workers is a permutation of the collection:
    the gait tests head the first chunks (xdist's ``N // 24``), each
    module's tests keep their order, and the port's tests come last."""
    class Item:
        def __init__(self, nodeid):
            self.nodeid = nodeid
    items = ([Item(f"tests/test_gaits.py::g{i}") for i in range(7)]
             + [Item(f"tests/test_a.py::a{i}") for i in range(60)]
             + [Item(f"tests/test_examples_golden.py::e{i}")
                for i in range(20)]
             + [Item(f"tests/test_torch_x.py::x{i}") for i in range(60)])
    out = sched.schedule(items, 6)
    assert sorted(map(id, out)) == sorted(map(id, items))
    chunk = sched.first_chunk(len(items), 6)
    assert [out.index(it) for it in items[:7]] == [i * chunk
                                                   for i in range(7)]
    assert out[-60:] == items[-60:]
    for mod in ("test_a", "test_examples_golden"):
        mine = [it for it in out if mod + ".py" in it.nodeid]
        assert mine == [it for it in items if mod + ".py" in it.nodeid]
    # the long modules' tests within the first EARLY of the JAX tests
    last = max(out.index(it) for it in items[67:87])
    assert last < sched.EARLY * 87 + 7


@pytest.mark.parametrize("n", [147, 424])
def test_first_chunk_is_xdists(sched, n):
    """The schedule's ``first_chunk`` is the chunk of consecutive tests that
    the installed pytest-xdist's ``--dist load`` first hands each of 6
    workers: a pytest-xdist that hands out tests otherwise fails here, not
    silently in the order's effect."""
    from xdist.scheduler.load import LoadScheduling

    class Node:
        shutting_down = False

        def __init__(self, i):
            self.sent, self.gateway = [], types.SimpleNamespace(id=f"gw{i}")

        def send_runtest_some(self, indices):
            self.sent.append(list(indices))

        def shutdown(self):
            self.shutting_down = True

    # the scheduler's own state without a pytest session (its __init__
    # reads the workers' count and options from the command line)
    ls = LoadScheduling.__new__(LoadScheduling)
    ls.numnodes, ls.node2collection, ls.node2pending = 6, {}, {}
    ls.pending, ls.collection, ls.config = [], None, None
    ls.maxschedchunk, ls.log = None, lambda *a: None
    nodes = [Node(i) for i in range(6)]
    for node in nodes:
        ls.add_node(node)
        ls.add_node_collection(node, [f"t{i}" for i in range(n)])
    ls.schedule()
    chunk = sched.first_chunk(n, 6)
    assert [node.sent for node in nodes] == [
        [list(range(w * chunk, (w + 1) * chunk))] for w in range(6)]
