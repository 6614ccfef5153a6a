"""A pytest plugin that keeps a long test process under the kernel's limit
on memory mappings by releasing the XLA executables JAX holds.

XLA:CPU maps about 20 regions for every executable it loads (the code,
read-only data and data of each of its kernels), and JAX keeps every
executable it compiled for as long as the process lives.  Linux refuses a
process more than ``vm.max_map_count`` mappings (65530 by default), and
XLA segfaults when a mapping is refused: a pytest-xdist worker that runs a
dozen example solves in a row dies in the next compile or cache read.
After each test, once the process holds more than half the limit, this
plugin drops JAX's compilation caches (``jax.clear_caches``) and collects
garbage, which frees every executable nothing else refers to; later tests
compile again what they need.  It changes no result, only when programs
are compiled.

Registered through ``pytest_plugins`` by tests/test_torch_xla_mappings.py,
so every process that collects the suite loads it.
"""

from __future__ import annotations

import gc

import pytest

MAPS = "/proc/self/maps"
MAX_MAP_COUNT = "/proc/sys/vm/max_map_count"


def mappings() -> int | None:
    """The number of memory mappings this process holds; None where the
    system does not say (not Linux)."""
    try:
        with open(MAPS, "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return None


def budget() -> int | None:
    """Half of the system's limit on mappings per process: one test never
    adds anywhere near the other half."""
    try:
        with open(MAX_MAP_COUNT) as f:
            return int(f.read()) // 2
    except (OSError, ValueError):
        return None


def release() -> None:
    """Free the executables that only JAX's caches hold."""
    import jax
    jax.clear_caches()
    gc.collect()


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item, nextitem):
    limit, held = budget(), mappings()
    if limit is not None and held is not None and held > limit:
        release()
