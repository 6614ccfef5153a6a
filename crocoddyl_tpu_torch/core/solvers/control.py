"""The solvers' control flow on the device: ``while_loop`` and ``cond`` over
pytrees of tensors (the counterparts of ``jax.lax.while_loop`` and
``jax.lax.cond``).

The same body functions serve two modes:

- eager (every call of ``solve`` and ``solve_batch``): the loop and the
  branch are driven from Python, with one host read of each predicate;
- export (``torch.compiler.is_exporting()``, under ``utils/aot.export_bytes``):
  each body is traced once into a graph and recorded as one
  ``torch.ops.higher_order.while_loop`` or ``cond`` node, so the exported
  program decides on the device.

In export mode the bodies are traced with the exporter's own tracer, not
with dynamo (the public ``torch._higher_order_ops.while_loop`` and
``torch.cond`` run dynamo over the body, which the lane code's static
numpy tables do not pass).  What a body closes over is then read as a
constant of its graph: a tensor of the enclosing trace (an input, or a
value computed before the loop) or a real tensor (a problem's data).
``_lift`` turns every such constant into an operand of the loop or branch,
so the enclosing trace passes it in, and a nested loop's constants travel
up level by level.  A body output that is one of its inputs, or a view of
one, is cloned there, as the loop and branch operators require.

Values a solver caches on a problem object (``cached``: the stacked knots,
the kernel descriptors) are kept for the duration of one export in a table
of their own, and only outside every body, so a cached tensor always
belongs to the outermost trace.

A solver that runs over a batch of B problems at once (``fddp.solve`` of a
batched problem) gives the loop and the branch a (B,) predicate, one
decision per problem.  A 1-D predicate follows ``jax.vmap``'s batching rule
of ``lax.while_loop`` and ``lax.cond``: the loop runs while any problem's
predicate holds, and a problem whose predicate is false keeps its carry; a
branch with a batched predicate selects per problem.  Each check is still
one host read.  Every leaf of such a carry or branch output carries the
leading problem axis.  A single problem's predicate is 0-d.
"""

from __future__ import annotations

import contextlib

import torch
import torch.utils._pytree as pytree

_depth = 0          # bodies being traced for export, nested
_export_cache = {}  # (id(obj), key) -> (obj, value), for one export


def exporting() -> bool:
    return torch.compiler.is_exporting()


@contextlib.contextmanager
def export_scope():
    """The extent of one export: the export-time cache starts and ends
    empty."""
    _export_cache.clear()
    try:
        yield
    finally:
        _export_cache.clear()


def lanes(p, x):
    """The per-problem predicate or scalar ``p`` (B,) shaped to broadcast
    against ``x`` (B, ...); ``p`` itself when it is 0-d."""
    if p.dim() == 0:
        return p
    return p.reshape(p.shape + (1,) * (x.dim() - p.dim()))


def select(p, new, old):
    """``new`` where ``p`` holds and ``old`` elsewhere, leaf by leaf, ``p``
    one decision per problem."""
    return pytree.tree_map(lambda a, b: torch.where(lanes(p, b), a, b), new,
                           old)


def per_problem(x, nb, op):
    """``op`` ("sum", "max" or "any") over all of ``x`` but its leading
    ``nb`` problem axes: one value a problem of a batch, or one for all of
    ``x`` (``nb`` 0)."""
    if nb == 0:
        return getattr(x, op)()
    x = x.reshape(x.shape[:nb] + (-1,))
    return (x.amax if op == "max" else getattr(x, op))(-1)


def mv(M, v):
    """M·v over leading axes (``M @ v`` for one vector)."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


def cached(obj, key, build):
    """``build()`` cached on ``obj`` under ``key``: in its ``__dict__`` in
    eager mode; under export, a value already cached eagerly is read, then
    one in the export's table (a body reads it as a constant of the
    enclosing trace), and a new one is kept there outside every body and
    not at all inside one."""
    hit = obj.__dict__.get(key)
    if hit is not None:
        return hit
    if not exporting():
        value = build()
        obj.__dict__[key] = value
        return value
    ent = _export_cache.get((id(obj), key))
    if ent is not None and ent[0] is obj:
        return ent[1]
    value = build()
    if not _depth:
        _export_cache[(id(obj), key)] = (obj, value)
    return value


class cached_property:
    """``functools.cached_property`` through :func:`cached`."""

    def __init__(self, fn):
        self.fn = fn
        self.name = fn.__name__
        self.__doc__ = fn.__doc__

    def __get__(self, obj, owner=None):
        if obj is None:
            return self
        return cached(obj, self.name, lambda: self.fn(obj))


def pick(a, i):
    """``a[i]`` for a 0-d integer tensor ``i``, as ``index_select`` (an
    exporter may otherwise read ``i`` on the host as a Python index); for
    (B,) indices ``i`` of a batch, row ``i[b]`` of problem b's ``a[b]``."""
    if i.dim() == 0:
        return a.index_select(0, i.reshape(1))[0]
    return a[torch.arange(i.shape[0], device=i.device), i]


def _trace(fn, args):
    global _depth
    from torch._higher_order_ops.utils import reenter_make_fx
    _depth += 1
    try:
        return reenter_make_fx(fn)(*args)
    finally:
        _depth -= 1


def _attr(gm, name):
    """``gm``'s attribute ``name``, read past ``nn.Module.__getattr__``,
    which the enclosing trace has patched to record get_attr nodes."""
    for d in (gm.__dict__, gm._buffers, gm._parameters, gm._modules):
        if name in d:
            return d[name]
    return None


def _lift(gms):
    """Every tensor that a get_attr node of the graphs reads becomes a
    trailing placeholder of each graph (the same list for all); outputs
    that are placeholders or views are cloned.  Returns the tensors, the
    operands that the caller appends."""
    consts, index = [], {}
    for gm in gms:
        # the loop operators' tracing leaves get_attr nodes that nothing
        # reads (of the carries it copies); they are dropped, not lifted
        for n in list(gm.graph.nodes):
            if n.op == "get_attr" and not n.users and isinstance(
                    _attr(gm, n.target), torch.Tensor):
                gm.graph.erase_node(n)
        for n in gm.graph.nodes:
            if n.op == "get_attr":
                v = _attr(gm, n.target)
                if isinstance(v, torch.Tensor) and id(v) not in index:
                    index[id(v)] = len(consts)
                    # a constant made in the body (torch.tensor of a list)
                    # is a fake tensor here: its real value goes out
                    real = getattr(v, "constant", None)
                    consts.append(v if real is None else real)
    for gm in gms:
        g = gm.graph
        phs = [n for n in g.nodes if n.op == "placeholder"]
        new = []
        for i in range(len(consts)):
            if phs or new:
                ctx = g.inserting_after((new or phs)[-1])
            else:
                ctx = g.inserting_before(next(iter(g.nodes)))
            with ctx:
                new.append(g.placeholder(f"lifted_{i}"))
        dead = set()
        for n in list(g.nodes):
            if n.op == "get_attr":
                v = _attr(gm, n.target)
                if isinstance(v, torch.Tensor):
                    n.replace_all_uses_with(new[index[id(v)]])
                    g.erase_node(n)
                    dead.add(n.target)
        for t in dead:
            delattr(gm, t)
        out = next(n for n in g.nodes if n.op == "output")

        def fresh(a):
            if isinstance(a, torch.fx.Node) and (
                    a.op == "placeholder"
                    or (isinstance(a.target, torch._ops.OpOverload)
                        and a.target.is_view)):
                with g.inserting_before(out):
                    return g.call_function(torch.ops.aten.clone.default, (a,))
            return a
        out.args = (torch.fx.node.map_aggregate(out.args[0], fresh),)
        g.lint()
        gm.recompile()
    return consts


def _unspecialized(x):
    x = x.clone()
    if getattr(x, "constant", None) is not None:
        x.constant = None
    return x


def while_loop(cond_fn, body_fn, carry):
    """``while cond_fn(carry): carry = body_fn(carry)``; ``carry`` is a
    pytree of tensors whose shapes and dtypes ``body_fn`` keeps."""
    if not exporting():
        p = cond_fn(carry)
        if p.dim() == 1:
            # jax.vmap's rule: run while any problem's predicate holds; a
            # problem whose predicate is false keeps its carry
            while bool(p.any()):
                carry = select(p, body_fn(carry), carry)
                p = cond_fn(carry)
            return carry
        while bool(p):
            carry = body_fn(carry)
            p = cond_fn(carry)
        return carry
    from torch._higher_order_ops.while_loop import while_loop_op
    flat, spec = pytree.tree_flatten(carry)

    def fcond(*xs):
        return cond_fn(pytree.tree_unflatten(xs, spec))

    def fbody(*xs):
        return tuple(pytree.tree_leaves(body_fn(pytree.tree_unflatten(xs,
                                                                      spec))))
    # the body is traced at carries that are not constants: a constant
    # initial value (torch.tensor of a Python value) would be folded into
    # the graph as if every iteration saw it
    from torch.fx.experimental.proxy_tensor import disable_proxy_modes_tracing
    with disable_proxy_modes_tracing():
        args = [_unspecialized(x) for x in flat]
    gc, gb = _trace(fcond, args), _trace(fbody, args)
    consts = _lift([gc, gb])
    out = while_loop_op(gc, gb, tuple(flat), tuple(consts))
    return pytree.tree_unflatten(list(out), spec)


def cond(pred, true_fn, false_fn, operands=()):
    """``true_fn(operands)`` if ``pred`` else ``false_fn(operands)``; the
    two return pytrees of the same structure, shapes and dtypes."""
    if not exporting():
        if pred.dim() == 1:
            # jax.vmap's rule for a batched predicate: both branches, one
            # selected per problem (only one runs where all agree)
            some, every = torch.stack([pred.any(), pred.all()]).tolist()
            if not some:
                return false_fn(operands)
            if every:
                return true_fn(operands)
            return select(pred, true_fn(operands), false_fn(operands))
        return true_fn(operands) if bool(pred) else false_fn(operands)
    from torch._higher_order_ops.cond import cond_op
    flat, spec = pytree.tree_flatten(operands)
    out_spec = []

    def wrap(fn):
        def f(*xs):
            leaves, s = pytree.tree_flatten(fn(pytree.tree_unflatten(xs,
                                                                     spec)))
            out_spec.append(s)
            return tuple(leaves)
        return f
    gt, gf = _trace(wrap(true_fn), flat), _trace(wrap(false_fn), flat)
    if out_spec[0] != out_spec[1]:
        raise ValueError("cond: the branches return different structures")
    consts = _lift([gt, gf])
    out = cond_op(pred, gt, gf, tuple(flat) + tuple(consts))
    return pytree.tree_unflatten(list(out), out_spec[0])
