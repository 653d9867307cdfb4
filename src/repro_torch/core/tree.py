"""Trees of tensors, walked in ``jax.tree_util``'s order.

A tree is nested dicts (keys sorted, as JAX sorts them; an OrderedDict
keeps its own order), lists, tuples, namedtuples and dataclasses (fields in
declaration order); ``None`` is an empty subtree with no leaf; anything
else is a leaf. A leaf's name joins its key path with ``_``
(``{"a": OptState(m, v, step)}`` gives ``a_m``, ``a_v``, ``a_step``).
Checkpoint leaf names, serve's KV frame order and the weight carry all
follow this walk, so they match the JAX package's.
"""
from __future__ import annotations

import collections
import copy
import dataclasses


def children(node):
    """``[(key, child), ...]`` of a container node in ``jax.tree_util``'s
    order, ``[]`` for ``None``, or ``None`` for a leaf."""
    if node is None:
        return []
    if isinstance(node, dict):
        keys = list(node) if isinstance(node, collections.OrderedDict) else sorted(node)
        return [(k, node[k]) for k in keys]
    if isinstance(node, tuple) and hasattr(node, "_fields"):  # namedtuple
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name)) for f in dataclasses.fields(node)]
    return None


def leaf_paths(tree) -> list[tuple[str, object]]:
    """``(name, leaf)`` of every leaf, the name its key path joined by ``_``."""
    out = []
    _walk(tree, (), out)
    return out


def _walk(node, path, out) -> None:
    # a module-level function: a nested one that calls itself is a reference
    # cycle, and its list of leaves (a whole train state's tensors) would
    # wait for the cycle collector instead of being freed on return
    kids = children(node)
    if kids is None:
        out.append(("_".join(str(k) for k in path), node))
        return
    for k, child in kids:
        _walk(child, path + (k,), out)


def tree_map(fn, tree):
    """``tree`` with every leaf replaced by ``fn(leaf)``, called in
    :func:`leaf_paths`'s order."""
    kids = children(tree)
    if kids is None:
        return fn(tree)
    if tree is None:
        return None
    mapped = [(k, tree_map(fn, child)) for k, child in kids]
    if isinstance(tree, dict):
        return (collections.OrderedDict if isinstance(tree, collections.OrderedDict) else dict)(mapped)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(v for _, v in mapped))
    if isinstance(tree, (list, tuple)):
        return type(tree)(v for _, v in mapped)
    new = copy.copy(tree)  # a dataclass: its fields replaced, frozen or not
    for k, v in mapped:
        object.__setattr__(new, k, v)
    return new
