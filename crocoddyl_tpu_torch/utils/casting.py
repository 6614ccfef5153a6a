"""Precision policy helper (port of crocoddyl_tpu/utils/casting.py):
problems are built in float64 and cast to another float dtype for the
device."""

from __future__ import annotations

import torch

from .struct import tree_map


def cast_floats(tree, dtype):
    """Cast every floating-point tensor leaf of a pytree to ``dtype``
    (integer and bool leaves and static fields untouched)."""

    def _cast(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.is_floating_point():
            return leaf.to(dtype)
        return leaf

    return tree_map(_cast, tree)
