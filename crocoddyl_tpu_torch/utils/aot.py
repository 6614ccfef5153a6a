"""Ahead-of-time preparation and export of the port's programs (port of
crocoddyl_tpu/utils/aot.py).

Reference: core/codegen/action-base.hpp (ActionModelCodeGen) records a
CppADCodeGen tape of calc/calcDiff, emits C, and dlopens it.  The JAX
package's counterpart is XLA AOT and ``jax.export``.  Here:

* :func:`export_bytes` / :func:`import_bytes` record a function with
  ``torch.export`` at the example arguments' shapes and dtypes and
  serialize the graph: an action model's ``calc``, or a problem's rollout
  and cost from ``(x0, us)``, the tape that ActionModelCodeGen records.
  A whole ``solve`` is not such a function: its regularization ladder and
  line search branch on tensor values on the host (``.item()``,
  ``bool()``), which ``torch.export`` cannot trace at fixed shapes, and
  :func:`export_bytes` raises on it.
* :func:`precompile`: the port's compile step is the ``nvcc`` build of the
  kernel library and the per-problem kernel descriptors.  It builds the
  library when an example argument sits on the card and runs the function
  once, which fills the descriptor caches (keyed by object identity), so
  that later calls build nothing.
"""

from __future__ import annotations

import io
from typing import Callable

import torch

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


def export_bytes(fn: Callable, *example_args) -> bytes:
    """``fn`` recorded by ``torch.export`` at the example arguments' shapes
    and dtypes, serialized (``torch.export.save``).  Raises ValueError on a
    function whose control flow depends on tensor values (a whole
    ``solve``)."""
    from torch.fx.experimental.symbolic_shapes import (
        GuardOnDataDependentSymNode)
    try:
        program = torch.export.export(_Wrap(fn), tuple(example_args),
                                      strict=False)
    except GuardOnDataDependentSymNode as e:
        raise ValueError(
            "export_bytes: the function branches on tensor values on the "
            "host (a solve's regularization ladder and line search read "
            "them with .item() or bool()); torch.export records only "
            "functions whose control flow is fixed by the shapes") from e
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def import_bytes(data: bytes) -> Callable:
    """Load a program saved by :func:`export_bytes`; returns a callable
    running the recorded graph."""
    return torch.export.load(io.BytesIO(data)).module()
