"""Nested containers of tensors (the port's pytrees): flatten to a list of
leaves and rebuild, in the JAX package's leaf order (``jax.tree.flatten``):
dict values by sorted key, tuple, list and NamedTuple fields in order,
``None`` an empty subtree.  Anything else is a leaf.  The checkpoint and
the chain-parallel layer walk a state through these two functions."""

from __future__ import annotations


def tree_flatten(tree):
    """(leaves, treedef): the leaves in order and the structure that
    :func:`tree_unflatten` rebuilds them into."""
    leaves = []

    def walk(node):
        if node is None:
            return ("none",)
        if isinstance(node, dict):
            keys = sorted(node)
            return ("dict", keys, [walk(node[k]) for k in keys])
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return ("namedtuple", type(node), [walk(c) for c in node])
        if isinstance(node, (tuple, list)):
            return (type(node), [walk(c) for c in node])
        leaves.append(node)
        return ("leaf",)

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves):
    """The tree of ``treedef`` with ``leaves`` in flattening order."""
    it = iter(leaves)

    def build(d):
        kind = d[0]
        if kind == "none":
            return None
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(c) for k, c in zip(d[1], d[2])}
        if kind == "namedtuple":
            return d[1](*[build(c) for c in d[2]])
        return kind(build(c) for c in d[1])

    out = build(treedef)
    end = object()
    if next(it, end) is not end:
        raise ValueError("more leaves than the structure holds")
    return out


def treedef_str(treedef) -> str:
    """A readable form of a structure, for error messages."""
    kind = treedef[0]
    if kind == "none":
        return "None"
    if kind == "leaf":
        return "*"
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {treedef_str(c)}"
                               for k, c in zip(treedef[1], treedef[2])) + "}"
    if kind == "namedtuple":
        return (treedef[1].__name__ + "("
                + ", ".join(treedef_str(c) for c in treedef[2]) + ")")
    inner = ", ".join(treedef_str(c) for c in treedef[1])
    return f"[{inner}]" if kind is list else f"({inner})"
