"""The few tree utilities the optimizer and the trainer need (the
reference's ``jax.tree``): a tree is nested dicts, lists, tuples and
NamedTuples with tensors at the leaves."""
from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn, tree, *rest):
    """``tree``'s structure with each leaf ``x`` replaced by ``fn(x, *the
    leaves at the same place in rest)``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves in ``tree_map``'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_flatten(tree):
    """``(leaves, unflatten)``: the leaves in ``tree_map``'s order, and a
    function that builds ``tree``'s structure around a list of new ones."""
    leaves = tree_leaves(tree)

    def unflatten(new):
        it = iter(new)
        return tree_map(lambda _: next(it), tree)
    return leaves, unflatten
