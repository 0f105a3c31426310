"""Nested dicts and lists of tensors (the port's param and state trees): the
few `jax.tree` operations the training path needs.  Dict keys are walked in
sorted order, as `jax.tree` walks them, lists in order; anything else is a
leaf."""
from __future__ import annotations


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure); returns a tree of the results."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_paths(tree)]


def tree_paths(tree, prefix: str = "") -> list[tuple[str, object]]:
    """[(path, leaf)] in walk order; a path joins dict keys and list
    indices with '/'."""
    if isinstance(tree, dict):
        return [pl for k in sorted(tree)
                for pl in tree_paths(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [pl for i, t in enumerate(tree)
                for pl in tree_paths(t, f"{prefix}{i}/")]
    return [(prefix.rstrip("/"), tree)]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` whose leaves, in walk order, are
    ``leaves``."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(t) for t in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree has")
    return out
