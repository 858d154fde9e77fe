"""Parameter trees of the port: nested NamedTuples, tuples, lists and dicts
whose leaves are tensors (or arrays).  ``None`` marks an absent field (a
tied LM head, a bias the config has not) and is no leaf, as in JAX.

A leaf's path is the tuple of field names, indices and dict keys that lead
to it; dict keys are visited in sorted order, as ``jax.tree`` does.

>>> from typing import NamedTuple
>>> class P(NamedTuple):
...     w: object
...     b: object
>>> t = {"p": P(w=1.0, b=None), "layers": (2.0, 3.0)}
>>> leaves_with_paths(t)
[(('layers', 0), 2.0), (('layers', 1), 3.0), (('p', 'w'), 1.0)]
>>> tree_map(lambda x: x * 10, t)["p"]
P(w=10.0, b=None)
>>> unflatten(t, [4.0, 5.0, 6.0])["layers"]
(4.0, 5.0)
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

__all__ = ["leaves_with_paths", "leaves", "tree_map", "tree_map_with_path",
           "unflatten", "path_name"]

Path = Tuple[Any, ...]


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(tree) -> List[Tuple[Any, Any]]:
    """``(key, child)`` pairs of an inner node, or ``None`` for a leaf."""
    if _is_namedtuple(tree):
        return list(zip(tree._fields, tree))
    if isinstance(tree, (tuple, list)):
        return list(enumerate(tree))
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    return None


def _rebuild(tree, values: Sequence[Any]):
    """An inner node of ``tree``'s type holding ``values`` in the order of
    :func:`_children`."""
    if _is_namedtuple(tree):
        return type(tree)(*values)
    if isinstance(tree, (tuple, list)):
        return type(tree)(values)
    return dict(zip(sorted(tree), values))


def leaves_with_paths(tree, path: Path = ()) -> List[Tuple[Path, Any]]:
    """Every leaf of ``tree`` with its path, depth first."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(path, tree)]
    out = []
    for key, child in kids:
        out += leaves_with_paths(child, path + (key,))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map_with_path(fn: Callable, tree, *rest, path: Path = ()):
    """``fn(path, leaf, *leaves_of_rest)`` at every leaf of ``tree``; the
    ``rest`` trees share its structure.  ``None`` stays ``None``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree, *rest)
    rest_kids = [[c for _, c in _children(r)] for r in rest]
    return _rebuild(tree, [
        tree_map_with_path(fn, child, *(rk[i] for rk in rest_kids),
                           path=path + (key,))
        for i, (key, child) in enumerate(kids)])


def tree_map(fn: Callable, tree, *rest):
    """``fn(leaf, *leaves_of_rest)`` at every leaf of ``tree``."""
    return tree_map_with_path(lambda _, *xs: fn(*xs), tree, *rest)


def unflatten(like, new_leaves: Sequence[Any]):
    """``like``'s structure holding ``new_leaves`` in the order of
    :func:`leaves_with_paths`."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def path_name(path: Path) -> str:
    """A leaf's name, its path joined by ``__`` (the reference's
    checkpoint names)."""
    return "__".join(str(k) for k in path) or "leaf"
