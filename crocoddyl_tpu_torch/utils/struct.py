"""Frozen dataclasses registered as PyTorch pytrees.

The JAX package builds its model and problem data from flax
``struct.PyTreeNode`` classes.  This is the PyTorch counterpart: a subclass
of :class:`PyTreeNode` becomes a frozen dataclass whose tensor fields are
pytree children and whose ``field(static=True)`` fields are part of the
tree structure.  One ``tree_map`` then moves a whole problem to a device or
a dtype, or stacks a list of same-structure knots.
"""

from __future__ import annotations

import dataclasses
import functools
import json

import torch.utils._pytree as pytree


def field(static: bool = False, **kwargs):
    """A dataclass field; ``static=True`` keeps it out of the pytree leaves."""
    meta = dict(kwargs.pop("metadata", {}) or {})
    meta["static"] = static
    return dataclasses.field(metadata=meta, **kwargs)


class PyTreeNode:
    """Base class: subclasses are frozen dataclasses and pytree nodes."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        dataclasses.dataclass(frozen=True)(cls)
        fields = dataclasses.fields(cls)
        data = tuple(f.name for f in fields if not f.metadata.get("static"))
        meta = tuple(f.name for f in fields if f.metadata.get("static"))

        # a None field is an empty subtree (as in JAX), so it lives in the
        # context and never reaches a tree_map function
        def flatten_with_keys(obj):
            present = [n for n in data if getattr(obj, n) is not None]
            nones = tuple(n for n in data if getattr(obj, n) is None)
            return ([(pytree.GetAttrKey(n), getattr(obj, n)) for n in present],
                    (tuple(getattr(obj, n) for n in meta), nones))

        def flatten(obj):
            children, context = flatten_with_keys(obj)
            return [c for _, c in children], context

        def unflatten(children, context):
            statics, nones = context
            kw = dict(zip([n for n in data if n not in nones], children))
            kw.update((n, None) for n in nones)
            kw.update(zip(meta, statics))
            return cls(**kw)

        pytree.register_pytree_node(
            cls, flatten, unflatten,
            serialized_type_name=f"{cls.__module__}.{cls.__qualname__}",
            to_dumpable_context=json.dumps,
            from_dumpable_context=lambda s: _tuples(json.loads(s)),
            flatten_with_keys_fn=flatten_with_keys)

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)


tree_map = pytree.tree_map
tree_leaves = pytree.tree_leaves
tree_flatten = pytree.tree_flatten
tree_unflatten = pytree.tree_unflatten


def _tuples(v):
    """JSON's lists back into the tuples of a static context."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def flat_spec(tree):
    """(leaves, the tree structure as a string): how an op argument list
    carries a dataclass tree (``unflat_spec`` rebuilds it).  The string is
    kept on the tree's object."""
    from ..core.solvers import control
    leaves, spec = tree_flatten(tree)
    return leaves, control.cached(tree, "_spec_str",
                                  lambda: pytree.treespec_dumps(spec))


@functools.lru_cache(maxsize=64)
def _spec(text):
    return pytree.treespec_loads(text)


def unflat_spec(leaves, text):
    """The tree of ``flat_spec``."""
    return tree_unflatten(list(leaves), _spec(text))
