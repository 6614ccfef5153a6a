"""MPC horizon rotation and warm starting (port of
crocoddyl_tpu/core/mpc.py: ``stack_nodes``, ``circular_append``,
``rotate_segmented`` and ``shift_warm_start``).

The running horizon of a one-segment problem is one stacked model whose
leaves carry a leading T axis, so its rotation is a ``torch.roll`` of
every leaf on the problem's device: no host round trip.  A problem of
several segments (the true-impulse gaits) is rotated by rebuilding its
knot list and regrouping it into segments (``rotate_segmented``): a knot
cannot move into a segment of another structure.  A rotated problem is a
new object whose
leaves are new tensors, never an edit of the old one: the kernel
descriptor (``ops/cuda_kernels.descriptor``) and ``ShootingProblem.knots``
are cached by object identity and would be read stale.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..utils.struct import tree_flatten, tree_leaves, tree_map
from .action import ActionModel
from .problem import ShootingProblem


def _unstack(model):
    """The knots of a stacked model (leading T axis on every leaf) as a
    list of single-knot models."""
    T = tree_leaves(model)[0].shape[0]
    return [tree_map(lambda l: l[t], model) for t in range(T)]


def stack_nodes(nodes):
    """Stack structurally identical knots along a new leading axis."""
    return tree_map(lambda *ls: torch.stack(ls, 0), *nodes)


def circular_append(problem: ShootingProblem,
                    new_model: Optional[ActionModel] = None,
                    new_x0: Optional[torch.Tensor] = None) -> ShootingProblem:
    """Rotate the horizon one knot (ShootingProblem::circularAppend,
    shooting.hpp:112-129): knot 0 is dropped, the others shift left and the
    freed last slot takes ``new_model``'s parameters (default: the dropped
    knot, a cyclic gait schedule); ``new_x0`` replaces the initial state.
    One segment only: several segments raise a ``ValueError``."""
    if isinstance(problem.running, tuple) and len(problem.running) > 1:
        raise ValueError(
            "circular_append rotates one segment; use rotate_segmented() "
            "for a problem of several segments")
    running = (problem.running[0] if isinstance(problem.running, tuple)
               else problem.running)

    def rot(leaf, new_leaf=None):
        rolled = torch.roll(leaf, -1, 0)
        if new_leaf is not None:
            rolled[-1] = new_leaf
        return rolled

    if new_model is None:
        running = tree_map(rot, running)
    else:
        running = tree_map(rot, running, new_model)
    if isinstance(problem.running, tuple):
        running = (running,)
    x0 = problem.x0 if new_x0 is None else torch.as_tensor(
        new_x0, dtype=problem.x0.dtype, device=problem.x0.device)
    return problem.replace(running=running, x0=x0)


def rotate_segmented(problem: ShootingProblem, k: int = 1, new_models=None,
                     new_x0: Optional[torch.Tensor] = None) -> ShootingProblem:
    """Rotate the whole horizon of a problem of any number of segments by
    ``k`` knots (mpc.py:82-112): the first k knots are dropped and k models
    appended at the tail (``new_models``, default: the dropped knots, the
    cyclic schedule), then the knot list is regrouped into consecutive
    segments of one structure (type, static fields and leaf structure), so
    a knot may cross a segment boundary."""
    nodes = [n for seg in problem.segments for n in _unstack(seg)]
    k = k % len(nodes)
    nodes = nodes[k:] + list(nodes[:k] if new_models is None
                             else new_models)
    segments, keys = [], []
    for n in nodes:
        key = (type(n), tree_flatten(n)[1])
        if keys and keys[-1] == key:
            segments[-1].append(n)
        else:
            keys.append(key)
            segments.append([n])
    segments = tuple(stack_nodes(s) for s in segments)
    x0 = problem.x0 if new_x0 is None else torch.as_tensor(
        new_x0, dtype=problem.x0.dtype, device=problem.x0.device)
    return problem.replace(
        running=segments[0] if len(segments) == 1 else segments, x0=x0)


def shift_warm_start(xs: torch.Tensor, us: torch.Tensor,
                     x_measured: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shift a solution one knot for the next replan: xs and us roll left,
    the last knot repeats, and the head is pinned to the measured state
    when one is given (mpc.py:115-125)."""
    xs_n = torch.roll(xs, -1, 0)
    xs_n[-1] = xs[-1]
    us_n = torch.roll(us, -1, 0)
    us_n[-1] = us[-1]
    if x_measured is not None:
        xs_n[0] = x_measured
    return xs_n, us_n
