"""Parameter trees: nested dicts, lists and tuples of tensors, walked in
the JAX package's leaf order (dict keys sorted, sequences in order, as
`jax.tree.leaves` walks them), so that sums over leaves, checkpoint keys
and "the same order" claims follow the reference. A Python dict's own
order (insertion) is not used."""
from __future__ import annotations

from typing import Any, Callable, List, Tuple


def flatten_with_path(tree: Any, path: Tuple = ()) -> List[Tuple[Tuple,
                                                                 Any]]:
    """[(path, leaf)] in leaf order; a path is the tuple of dict keys and
    sequence indices from the root. None is an empty subtree."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += flatten_with_path(tree[k], path + (k,))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += flatten_with_path(v, path + (i,))
        return out
    if tree is None:
        return []
    return [(path, tree)]


def leaves(tree: Any) -> list:
    return [leaf for _, leaf in flatten_with_path(tree)]


def unflatten(template: Any, new_leaves) -> Any:
    """`template`'s structure with its leaves replaced, in leaf order."""
    it = iter(new_leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}       # keep the key order
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        if node is None:
            return None
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """fn over the leaves of `tree` and the matching leaves of `rest`."""
    others = [leaves(r) for r in rest]
    return unflatten(tree, [fn(leaf, *(o[i] for o in others))
                            for i, leaf in enumerate(leaves(tree))])


def path_key(path: Tuple) -> str:
    """A leaf's checkpoint key: its path joined with "/"."""
    return "/".join(str(p) for p in path)
