"""Nested dicts, lists, tuples and NamedTuples of tensors, walked in the
order JAX walks a pytree: dict keys sorted, sequences and NamedTuple fields
in order, ``None`` holding no leaf.  The optimizer, the train step and the
checkpoint store use it, so a global norm sums its leaves in the
reference's order and a checkpoint's leaf paths are the reference's
(``['blocks']/[0]/['attn']/['q']/['kernel']``, ``.mu/...``, ``.count``).
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _children(node):
    """(key string, child) pairs in JAX's order, or None for a leaf."""
    if isinstance(node, dict):
        return [(f"[{k!r}]", node[k]) for k in sorted(node)]
    if _is_namedtuple(node):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return [(f"[{i}]", c) for i, c in enumerate(node)]
    return None


def flatten_with_paths(tree) -> list[tuple[str, object]]:
    """[(path, leaf)] in JAX's leaf order; ``path`` joins the key strings
    with ``/`` as the reference's checkpoint manifest does."""
    out = []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            out.append(("/".join(path), node))
            return
        for key, child in kids:
            walk(child, path + [key])

    walk(tree, [])
    return out


def leaves(tree) -> list:
    return [leaf for _, leaf in flatten_with_paths(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure; leaves
    are visited in JAX's order and dicts keep their own key order."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        vals = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def unflatten(tree, new_leaves):
    """``tree``'s structure with its leaves replaced, in order, by
    ``new_leaves``."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), tree)
    if next(it, it) is not it:
        raise ValueError("unflatten: more leaves than the tree holds")
    return out
