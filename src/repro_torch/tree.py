"""Trees of tensors, walked as the JAX package walks its pytrees.

Dicts, lists, tuples and named tuples are the inner nodes; anything else
is a leaf.  Every walk visits the leaves in one order, the JAX package's
flatten order (dict keys sorted, sequences in order), so the leaves that
``tree_leaves`` collects, the names ``named_leaves`` gives and the calls
``tree_map`` makes line up, and a tree can be rebuilt from its leaves with
``tree_map(lambda _: next(it), like)``.  The port's params, gradients,
optimizer states, checkpoints and device-store values all go through here.
"""
from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``tree`` with each leaf replaced by ``fn(leaf, *the leaves at the
    same place in rest)``.  Dicts keep their key order; ``fn`` is called
    in the visit order."""
    if isinstance(tree, dict):
        done = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, *kids) for kids in zip(tree, *rest, strict=True)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in the visit order."""
    out: list = []
    tree_map(out.append, tree)
    return out


def named_leaves(tree: Any, is_leaf: Callable[[Any], bool] | None = None
                 ) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in the visit order.  A path joins dict keys,
    named tuples' field names and sequence indices with ``/``, as the
    JAX package names a leaf (``embed/table``, ``segments/0/1/mlp/up``).
    A node for which ``is_leaf`` is true counts as one leaf."""
    out: list[tuple[str, Any]] = []

    def walk(name: str, node: Any) -> None:
        if is_leaf is None or not is_leaf(node):
            if isinstance(node, dict):
                kids = [(k, node[k]) for k in sorted(node)]
            elif isinstance(node, (list, tuple)):
                kids = list(zip(getattr(node, "_fields", range(len(node))),
                                node))
            else:
                kids = None
            if kids is not None:
                for k, v in kids:
                    walk(f"{name}/{k}" if name else str(k), v)
                return
        out.append((name, node))

    walk("", tree)
    return out
