"""Pytrees of tensors as the reference's ``jax.tree`` sees them: dicts
(keys in sorted order), lists, tuples and NamedTuples (fields by name)
are nodes, None is an empty node, anything else is a leaf. The params,
optimizer states and checkpoints of the port walk their trees here."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``, which share its structure); None stays None."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def leaves_with_path(tree: Any, path: Tuple[str, ...] = ()
                     ) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs in the reference's flatten order: dict keys
    sorted, sequence items by index, NamedTuple fields by name."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in leaves_with_path(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [pl for f, v in zip(tree._fields, tree)
                for pl in leaves_with_path(v, path + (f,))]
    if isinstance(tree, (list, tuple)):
        return [pl for i, v in enumerate(tree)
                for pl in leaves_with_path(v, path + (str(i),))]
    return [(path, tree)]


def tree_leaves(tree: Any) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def unflatten_like(template: Any, leaves: list) -> Any:
    """``template``'s structure with ``leaves`` in flatten order."""
    paths = [p for p, _ in leaves_with_path(template)]
    if len(paths) != len(leaves):
        raise ValueError(f"{len(leaves)} leaves for a template of "
                         f"{len(paths)}")
    return _rebuild(template, (), dict(zip(paths, leaves)))


def _rebuild(tree, path, by_path):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, path + (str(k),), by_path)
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(v, path + (f,), by_path)
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, path + (str(i),), by_path)
                          for i, v in enumerate(tree))
    return by_path[path]
