"""Parameter trees in ``jax.tree`` leaf order.

The port keeps parameters as nested dicts and lists of tensors, like the
JAX package's pytrees.  Leaf order matters: the packed ``(n, P)`` plane
(``core/plane.py``) lays leaves out in flatten order, and its columns must
match the reference's.  ``jax.tree`` visits dict keys SORTED and lists and
tuples in order; ``torch.utils._pytree`` visits dicts in insertion order,
so the port carries its own flatten.  ``None`` is an empty subtree, as in
JAX.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "tree_map", "leaves", "leaves_with_paths"]


def _walk(node, out: List[Any]):
    if isinstance(node, dict):
        keys = sorted(node)
        return ("dict", tuple(keys), tuple(_walk(node[k], out) for k in keys))
    if isinstance(node, (list, tuple)):
        kind = "list" if isinstance(node, list) else "tuple"
        return (kind, len(node), tuple(_walk(c, out) for c in node))
    if node is None:
        return ("none",)
    out.append(node)
    return ("leaf",)


def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, treedef)``; ``treedef`` is a hashable structure spec.

    The recursion is a module-level function, not a closure: a nested
    function that calls itself is a reference cycle, which would keep the
    leaves (gigabytes of tensors for a large model) alive until the
    cyclic garbage collector happens to run."""
    out: List[Any] = []
    spec = _walk(tree, out)
    return out, spec


def _build(spec, it):
    kind = spec[0]
    if kind == "leaf":
        return next(it)
    if kind == "none":
        return None
    if kind == "dict":
        return {k: _build(s, it) for k, s in zip(spec[1], spec[2])}
    children = [_build(s, it) for s in spec[2]]
    return children if kind == "list" else tuple(children)


def unflatten(treedef, leaves_in):
    """Inverse of :func:`flatten`."""
    it = iter(leaves_in)
    tree = _build(treedef, it)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree has slots")
    return tree


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def _walk_paths(node, path, out):
    if isinstance(node, dict):
        for k in sorted(node):
            _walk_paths(node[k], path + (k,), out)
    elif isinstance(node, (list, tuple)):
        for i, c in enumerate(node):
            _walk_paths(c, path + (i,), out)
    elif node is not None:
        out.append((path, node))


def leaves_with_paths(tree) -> List[Tuple[Tuple[Any, ...], Any]]:
    """``(path, leaf)`` in flatten order; a path holds the dict keys and
    list/tuple indices from the root (``jax.tree_util``'s
    ``tree_flatten_with_path`` keys, unwrapped)."""
    out: List[Tuple[Tuple[Any, ...], Any]] = []
    _walk_paths(tree, (), out)
    return out


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree.map`` over trees of the same structure."""
    flat, spec = flatten(tree)
    others = []
    for r in rest:
        f, s = flatten(r)
        if s != spec:
            raise ValueError("tree_map: tree structures differ")
        others.append(f)
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
