"""Ahead-of-time preparation and export of the port's programs (port of
crocoddyl_tpu/utils/aot.py).

Reference: core/codegen/action-base.hpp (ActionModelCodeGen) records a
CppADCodeGen tape of calc/calcDiff, emits C, and dlopens it.  The JAX
package's counterpart is XLA AOT and ``jax.export``, which serializes a
whole ``solve`` (tests/test_aot.py:30-42).  Here:

* :func:`export_bytes` / :func:`import_bytes` record a function with
  ``torch.export`` at the example arguments' shapes and dtypes and
  serialize the graph: an action model's ``calc``, a problem's rollout and
  cost from ``(x0, us)`` (the tape that ActionModelCodeGen records), or a
  whole ``solve`` or ``solve_batch``.  A solve decides on the device
  (``core/solvers/control.py``): its iteration loop, regularization ladder
  and line search are recorded as ``while_loop`` and ``cond`` nodes, as
  JAX's ``lax.while_loop``s are (``solve``: fddp.py:649, :658, :744, :855;
  ``solve_batch``: fddp_batch.py:179, :250, :293), and each kernel launch,
  each generic backward pass (with its BoxQPs under box) and each
  evaluation of nodes outside the node kernel (``torch.func`` derivatives,
  ``autograd.Function`` JVP rules) as one node of its op
  ``torch.ops.crocoddyl_tpu_torch.*``.  Every problem and setting that the
  eager ``solve`` takes exports but a host ``iter_callback``, which raises
  ValueError, as ``jax.export`` refuses host callbacks.
* :func:`precompile`: the port's compile step is the ``nvcc`` build of the
  kernel library and the per-problem kernel descriptors.  It builds the
  library when an example argument sits on the card and runs the function
  once, which fills the descriptor caches (keyed by object identity), so
  that later calls build nothing.
"""

from __future__ import annotations

import contextlib
import io
import logging
import typing
from typing import Callable

import torch
import torch.export.passes

from .struct import tree_leaves


class _Wrap(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def precompile(fn: Callable, *example_args):
    """``fn`` ready to run at the example arguments: the kernel library is
    built (when an example argument is a CUDA tensor) and ``fn`` has run
    once on them, so the kernel descriptors of the problems it closes over
    are built.  Returns a callable that runs ``fn``."""
    if any(isinstance(a, torch.Tensor) and a.is_cuda
           for a in tree_leaves(example_args)):
        from ..ops import cuda_kernels
        cuda_kernels.build()
    fn(*example_args)
    return fn


@contextlib.contextmanager
def _unused_constants_dropped():
    """torch 2.13's export lifts the constants of the graph and drops the
    unused ones, but raises StopIteration on a constant that nothing reads
    (``lift_constants_pass._unused_constant``); the loop bodies' retrace
    leaves such nodes.  Within the block they are dropped."""
    from torch._export.passes import lift_constants_pass as lcp
    find = getattr(lcp, "_unused_constant", None)
    if find is None:
        yield
        return

    def unused(node):
        return [node] if not node.users else find(node)
    lcp._unused_constant = unused
    try:
        yield
    finally:
        lcp._unused_constant = find


@contextlib.contextmanager
def _no_stack_traces():
    """The exporter keeps each node's Python stack, which costs more than
    the trace itself for a solve's tens of thousands of nodes."""
    import torch.fx.config as fx_config
    saved = getattr(fx_config, "do_not_emit_stack_traces", None)
    if saved is None:
        yield
        return
    fx_config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        fx_config.do_not_emit_stack_traces = saved


def export_bytes(fn: Callable, *example_args) -> bytes:
    """``fn`` recorded by ``torch.export`` at the example arguments' shapes
    and dtypes, serialized (``torch.export.save``).  A whole ``solve`` or
    ``solve_batch`` is recorded with its loops and branches, for every
    node kind.  Raises ValueError on a host ``iter_callback``, the one
    setting an exported program cannot record."""
    from ..core.solvers import control
    from ..ops import fused_scans  # noqa: F401  (registers the kernels' ops)
    with control.export_scope(), _unused_constants_dropped(), \
            _no_stack_traces():
        program = torch.export.export(_Wrap(fn), tuple(example_args),
                                      strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


class _CachedTyping:
    """The ``typing`` module with ``get_type_hints`` kept per class."""

    def __init__(self):
        self._hints = {}

    def __getattr__(self, name):
        return getattr(typing, name)

    def get_type_hints(self, cls, *args, **kwargs):
        hit = self._hints.get(cls)
        if hit is None:
            hit = self._hints[cls] = typing.get_type_hints(cls, *args,
                                                           **kwargs)
        return hit


@contextlib.contextmanager
def _type_hints_cached():
    """torch 2.13's deserializer calls ``typing.get_type_hints`` on the
    schema's classes once per serialized object (most of a loop program's
    load time); within the block it reads them once per class."""
    from torch._export.serde import serialize
    saved = getattr(serialize, "typing", None)
    if saved is not typing:
        yield
        return
    serialize.typing = _CachedTyping()
    try:
        yield
    finally:
        serialize.typing = saved


def import_bytes(data: bytes) -> Callable:
    """Load a program saved by :func:`export_bytes`; returns a callable
    running the recorded graph on the device its tensor arguments sit on
    (the program's constants move there once per device)."""
    from ..ops import fused_scans  # noqa: F401  (registers the kernels' ops)
    log = logging.getLogger("torch._export.serde.serialize")
    level = log.level
    log.setLevel(logging.ERROR)  # loop counters' symbols are not in the graph
    try:
        with _type_hints_cached():
            program = torch.export.load(io.BytesIO(data))
    finally:
        log.setLevel(level)
    modules = {}

    def run(*args):
        dev = next((a.device for a in tree_leaves(args)
                    if isinstance(a, torch.Tensor)), torch.device("cpu"))
        mod = modules.get(dev)
        if mod is None:
            mod = modules[dev] = torch.export.passes.move_to_device_pass(
                program, dev).module()
        return mod(*args)
    return run
