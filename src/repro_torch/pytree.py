"""Trees of tensors: the one walker of the port's containers.

The port's parameter, plan, cache, optimizer and sharding trees are made
of dicts, NamedTuples (caches, optimizer state), dataclasses
(``PlannedWeights``), lists and tuples. This module walks and rebuilds
them in the JAX package's flattening order and leaf paths, which the
checkpoint store's tensor names and the sharding trees both follow:

- a container's children come in ``jax.tree_util``'s order: dict keys
  sorted, NamedTuple and dataclass fields in declaration order, sequence
  items by index;
- ``None`` is structure, not a leaf: a None subtree maps to None and holds
  no leaves, and so are a dataclass's fields marked
  ``metadata={"static": True}`` (a plan's ``weight_bits``, a conv's
  ``kernel_hw``), which a rebuild keeps;
- a leaf's name is its path, the parts joined by "/";
- ``is_leaf`` stops the walk at a node that would otherwise be a
  container (a logical-axes tuple, a ``PlannedWeights``, a sharding).

A rebuilt dict keeps its keys' order.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

SEP = "/"


def is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def children(node) -> list[tuple[Any, Any]] | None:
    """(key, child) of a container in the JAX package's flattening order,
    or None for a leaf. The key is the dict key, the field name or the
    sequence index."""
    if isinstance(node, dict):
        return [(k, node[k]) for k in sorted(node)]
    if is_namedtuple(node):
        return list(zip(node._fields, node))
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [(f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)
                if not f.metadata.get("static")]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def child(node, key) -> Any:
    """The child of ``node`` under ``key`` (as :func:`children` names it)."""
    if isinstance(node, (dict, list)) or (isinstance(node, tuple)
                                          and not is_namedtuple(node)):
        return node[key]
    return getattr(node, key)


def _rebuild(node, mapped: dict) -> Any:
    if isinstance(node, dict):
        return {k: mapped[k] for k in node}
    if is_namedtuple(node):
        return type(node)(*(mapped[f] for f in node._fields))
    if dataclasses.is_dataclass(node):
        return dataclasses.replace(node, **mapped)
    return type(node)(mapped[i] for i in range(len(node)))


def _kids(node, is_leaf):
    if is_leaf is not None and is_leaf(node):
        return None
    return children(node)


def _join(prefix: str, key) -> str:
    return f"{prefix}{SEP}{key}" if prefix else str(key)


def leaves_with_names(tree: Any, prefix: str = "", *,
                      is_leaf: Callable[[Any], bool] | None = None
                      ) -> list[tuple[str, Any]]:
    """(name, leaf) of every leaf, in the JAX package's order and names."""
    if tree is None:
        return []
    kids = _kids(tree, is_leaf)
    if kids is None:
        return [(prefix, tree)]
    return [x for k, c in kids
            for x in leaves_with_names(c, _join(prefix, k), is_leaf=is_leaf)]


def leaves(tree: Any, *, is_leaf: Callable[[Any], bool] | None = None
           ) -> list:
    """The leaves of a tree, in :func:`leaves_with_names`' order."""
    return [x for _, x in leaves_with_names(tree, is_leaf=is_leaf)]


def map_with_names(fn: Callable[..., Any], tree: Any, *rest: Any,
                   prefix: str = "",
                   is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """The tree with each leaf replaced by ``fn(name, leaf, *the nodes of
    rest at its path)``; containers keep their types (and a dataclass its
    static fields), a None subtree stays None."""
    if tree is None:
        return None
    kids = _kids(tree, is_leaf)
    if kids is None:
        return fn(prefix, tree, *rest)
    return _rebuild(tree, {
        k: map_with_names(fn, c, *(child(r, k) for r in rest),
                          prefix=_join(prefix, k), is_leaf=is_leaf)
        for k, c in kids})


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn(leaf, *the nodes of rest at its path)`` over ``tree``'s
    leaves (:func:`map_with_names` without the names)."""
    return map_with_names(lambda _, *x: fn(*x), tree, *rest, is_leaf=is_leaf)
