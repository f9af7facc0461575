"""Parameter trees of the port: nested dicts whose leaves are tensors
(the reference's pytrees).  The few ``jax.tree_util`` operations that the
training modules need."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree``, with the matching nodes of
    ``rest`` (same keys; a node there may be a subtree, such as an int8
    state's ``{"codes", "scale"}``, where ``tree`` has a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def leaves_with_paths(tree, prefix: Tuple[str, ...] = ()
                      ) -> Iterator[Tuple[Tuple[str, ...], object]]:
    """(path of keys, leaf) for every leaf, in the tree's key order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves_with_paths(v, prefix + (str(k),))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def flatten(tree) -> Dict[str, object]:
    """{"a/b/c": leaf}: each leaf under its path of keys joined by "/",
    as the reference's checkpoints spell ``tree_flatten_with_path``."""
    return {"/".join(path): leaf for path, leaf in leaves_with_paths(tree)}
