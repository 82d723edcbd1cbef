"""Trees of tensors: nested dicts and lists (tuples) with tensor leaves.

Leaves are visited in the reference's pytree order: a dict's keys
sorted, a list's items by index.  That order fixes the order of the
optimizer's global-norm sum and the leaf names of a checkpoint, so both
match the reference's for the same tree.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

Path = Tuple[Any, ...]


def _children(tree):
    if isinstance(tree, dict):
        return [(k, tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return list(enumerate(tree))
    return None


def flatten_with_path(tree, prefix: Path = ()) -> List[Tuple[Path, Any]]:
    """[(path, leaf)]: a path is the tuple of dict keys and list indices
    from the root."""
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for k, v in kids:
        out.extend(flatten_with_path(v, prefix + (k,)))
    return out


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(like, new_leaves) -> Any:
    """A tree shaped like ``like`` with ``new_leaves`` (in ``leaves``'
    order) for its leaves."""
    it = iter(new_leaves)

    def build(t):
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of each
    of ``rest`` (trees of the same structure)."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(x, *(o[i] for o in others))
                            for i, x in enumerate(leaves(tree))])
