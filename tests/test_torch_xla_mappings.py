"""The plugin that keeps test processes under the limit on memory mappings
(tests/_xla_mappings.py): the port's tests compile their JAX references in
the same long pytest-xdist workers as the JAX package's own tests, and a
worker that holds more executables than the kernel allows mappings for
dies in XLA.  This module registers the plugin for the whole session."""

import jax
import jax.numpy as jnp
import pytest

pytest_plugins = ("tests._xla_mappings",)


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
