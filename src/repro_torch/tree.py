"""Trees of tensors, flattened in ``jax.tree_util``'s order.

The order of leaves is observable wherever leaves are numbered: the
checkpoint's ``leaf{i:05d}`` files, Q8Adam's per-leaf rounding keys
(``fold_in(base, 2*i)``) and the order of ``global_norm``'s sum.  So this
module walks a tree as ``jax.tree_util`` does:

* a dict's children in **sorted** key order (and it is rebuilt so);
* a list's or tuple's children in order;
* a NamedTuple's fields in field order;
* ``None`` is a node with no children (it holds no leaf);
* anything else is a leaf.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


class TreeDef:
    """The structure of a tree: its node kinds, dict keys and NamedTuple
    types, with a hole at each leaf."""

    __slots__ = ("kind", "meta", "children")

    def __init__(self, kind: str, meta=None, children: tuple = ()):
        self.kind = kind            # "leaf", "none", "dict", "list", "tuple", "namedtuple"
        self.meta = meta            # the sorted keys of a dict, a NamedTuple's type
        self.children = children

    @property
    def num_leaves(self) -> int:
        if self.kind == "leaf":
            return 1
        return sum(c.num_leaves for c in self.children)

    def unflatten(self, leaves) -> Any:
        """The tree of this structure holding ``leaves`` in order."""
        it = iter(leaves)
        out = self._build(it)
        if next(it, _END) is not _END:
            raise ValueError(f"more leaves than the {self.num_leaves} of {self}")
        return out

    def _build(self, it):
        if self.kind == "leaf":
            leaf = next(it, _END)
            if leaf is _END:
                raise ValueError(f"too few leaves for {self}")
            return leaf
        if self.kind == "none":
            return None
        kids = [c._build(it) for c in self.children]
        if self.kind == "dict":
            return dict(zip(self.meta, kids))
        if self.kind == "list":
            return kids
        if self.kind == "tuple":
            return tuple(kids)
        return self.meta(*kids)

    def flatten_up_to(self, tree) -> list:
        """The subtrees of ``tree`` that sit where this structure has
        leaves, in leaf order (``tree`` must hold this structure as a
        prefix), as ``PyTreeDef.flatten_up_to`` gives them."""
        out: list = []
        self._up_to(tree, out, ())
        return out

    def _up_to(self, tree, out: list, path: tuple):
        if self.kind == "leaf":
            out.append(tree)
            return
        if self.kind == "none":
            if tree is not None:
                raise ValueError(f"expected None at {path}, got {type(tree).__name__}")
            return
        if self.kind == "dict":
            if not isinstance(tree, dict) or sorted(tree) != list(self.meta):
                raise ValueError(f"expected a dict with keys {list(self.meta)} at {path}")
            kids = [tree[k] for k in self.meta]
        elif self.kind == "namedtuple":
            if type(tree) is not self.meta:
                raise ValueError(f"expected {self.meta.__name__} at {path}, "
                                 f"got {type(tree).__name__}")
            kids = list(tree)
        else:
            want = list if self.kind == "list" else tuple
            if (not isinstance(tree, want) or _is_namedtuple(tree)
                    or len(tree) != len(self.children)):
                raise ValueError(f"expected a {self.kind} of {len(self.children)} at {path}")
            kids = list(tree)
        for i, (c, t) in enumerate(zip(self.children, kids)):
            c._up_to(t, out, path + (i,))

    def __repr__(self) -> str:
        if self.kind == "leaf":
            return "*"
        if self.kind == "none":
            return "None"
        kids = [repr(c) for c in self.children]
        if self.kind == "dict":
            return "{" + ", ".join(f"{k!r}: {v}" for k, v in zip(self.meta, kids)) + "}"
        if self.kind == "list":
            return "[" + ", ".join(kids) + "]"
        if self.kind == "tuple":
            return "(" + ", ".join(kids) + ("," if len(kids) == 1 else "") + ")"
        return f"{self.meta.__name__}(" + ", ".join(
            f"{f}={v}" for f, v in zip(self.meta._fields, kids)) + ")"


_END = object()


def tree_flatten(tree, is_leaf: Callable | None = None) -> tuple[list, TreeDef]:
    """(leaves in ``jax.tree_util`` order, structure).  A subtree for
    which ``is_leaf`` is true is a leaf, as in JAX."""
    leaves: list = []
    return leaves, _flatten(tree, leaves, is_leaf)


def _flatten(tree, leaves: list, is_leaf) -> TreeDef:
    if is_leaf is not None and is_leaf(tree):
        leaves.append(tree)
        return TreeDef("leaf")
    if tree is None:
        return TreeDef("none")
    if isinstance(tree, dict):
        keys = tuple(sorted(tree))
        return TreeDef("dict", keys, tuple(_flatten(tree[k], leaves, is_leaf) for k in keys))
    if _is_namedtuple(tree):
        return TreeDef("namedtuple", type(tree),
                       tuple(_flatten(x, leaves, is_leaf) for x in tree))
    if isinstance(tree, (list, tuple)):
        kind = "list" if isinstance(tree, list) else "tuple"
        return TreeDef(kind, None, tuple(_flatten(x, leaves, is_leaf) for x in tree))
    leaves.append(tree)
    return TreeDef("leaf")


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return tree_flatten(tree, is_leaf)[0]


def tree_structure(tree) -> TreeDef:
    return tree_flatten(tree)[1]


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None) -> Any:
    """``fn`` over the leaves of ``tree`` (and the matching subtrees of
    ``rest``, which hold its structure as a prefix); dicts come back with
    sorted keys, as in JAX."""
    leaves, treedef = tree_flatten(tree, is_leaf)
    others = [treedef.flatten_up_to(r) for r in rest]
    return treedef.unflatten(fn(*xs) for xs in zip(leaves, *others))
