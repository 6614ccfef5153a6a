"""Build the port's problem from another framework's problem data.

:func:`problem_from_numpy` takes a problem's leaves as numpy arrays keyed by
pytree path (``".running.costs.items[0].weight"``, the key strings of
``tree_flatten_with_path``) and a ``structure`` that names each node's class,
its static fields and its children.  The JAX package's problem, flattened on
the JAX side, becomes the port's ShootingProblem with the very same numbers,
without this package importing JAX.

``structure`` is nested plain data:

- ``{"type": ClassName, "static": {field: value}, "fields": {field: sub}}``
  for a dataclass node;
- ``{"tuple": [sub, ...]}`` for a tuple;
- ``{"leaf": path}`` for an array leaf; ``None`` for an empty field.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _classes():
    from ..core.manifolds import StateVector
    from ..core.problem import ShootingProblem
    from ..dynamics.model import RobotModel
    from ..dynamics.states import StateMultibody
    from ..models.lqr import DiffLQRModel, LQRModel
    from ..models.multibody import (activations, actuations, contacts, costs,
                                    frames)
    from ..models.multibody.nodes import CostStack, RigidBodyNode
    from ..models.unicycle import UnicycleModel
    out = {c.__name__: c for c in (ShootingProblem, RobotModel,
                                   StateMultibody, CostStack,
                                   RigidBodyNode, StateVector, UnicycleModel,
                                   LQRModel, DiffLQRModel)}
    for mod in (activations, actuations, contacts, costs, frames):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and obj.__module__ == mod.__name__:
                out[name] = obj
    return out


def problem_from_numpy(leaves: Mapping[str, np.ndarray], structure,
                       device=None, dtype=None, classes=None):
    """Rebuild a problem (or any node of one) from numpy leaves keyed by
    pytree path and a structure description (see the module docstring).
    ``classes`` adds port classes by name, such as a user's
    ``Actuation`` subclass."""
    classes = {**_classes(), **(classes or {})}

    def build(node):
        if node is None:
            return None
        if "leaf" in node:
            t = torch.from_numpy(np.array(leaves[node["leaf"]]))
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return t.to(device) if device is not None else t
        if "tuple" in node:
            return tuple(build(s) for s in node["tuple"])
        cls = classes.get(node["type"])
        if cls is None:
            raise ValueError(f"no port class for {node['type']!r}")
        kw = {k: (tuple(v) if isinstance(v, list) else v)
              for k, v in node.get("static", {}).items()}
        kw.update({k: build(s) for k, s in node["fields"].items()})
        return cls(**kw)

    return build(structure)
