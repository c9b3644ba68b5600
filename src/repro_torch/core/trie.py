"""Path-prefix trie — Cascade Fig 2 step ②.

(Copied from the JAX package's ``core/trie.py``, whose package
``__init__`` imports jax.)

The dispatcher matches each incoming object key against the set of registered
lambda path prefixes.  The paper reports ~130 ns per depth level using a
ternary tree; we use a per-level dict trie (hash per component) which has the
same asymptotics and is the idiomatic Python equivalent.

Keys are ``/``-separated paths (``/pool/sub/key``).  A registered prefix
matches every key of which it is a path-component prefix, so one key may
match several prefixes at different depths (the paper: "one incoming object
could match multiple path prefixes and trigger multiple lambdas").
"""
from __future__ import annotations

from typing import Any, Generic, Iterator, TypeVar

T = TypeVar("T")


def split_path(path: str) -> list[str]:
    """Split a Cascade key path into components, ignoring empty segments."""
    return [c for c in path.split("/") if c]


class _Node(Generic[T]):
    __slots__ = ("children", "values")

    def __init__(self) -> None:
        self.children: dict[str, _Node[T]] = {}
        self.values: list[T] = []


class PathTrie(Generic[T]):
    """Maps path prefixes to lists of values (lambda handles)."""

    def __init__(self) -> None:
        self._root: _Node[T] = _Node()
        self._size = 0

    def __len__(self) -> int:
        return self._size

    def insert(self, prefix: str, value: T) -> None:
        node = self._root
        for comp in split_path(prefix):
            nxt = node.children.get(comp)
            if nxt is None:
                nxt = _Node()
                node.children[comp] = nxt
            node = nxt
        node.values.append(value)
        self._size += 1

    def remove(self, prefix: str, value: T) -> bool:
        node = self._root
        for comp in split_path(prefix):
            node = node.children.get(comp)  # type: ignore[assignment]
            if node is None:
                return False
        try:
            node.values.remove(value)
        except ValueError:
            return False
        self._size -= 1
        return True

    def match(self, key: str) -> list[T]:
        """All values registered at any prefix of ``key`` (shallow → deep)."""
        out: list[T] = []
        node = self._root
        if node.values:
            out.extend(node.values)
        for comp in split_path(key):
            node = node.children.get(comp)  # type: ignore[assignment]
            if node is None:
                break
            if node.values:
                out.extend(node.values)
        return out

    def longest_prefix(self, key: str) -> tuple[str, list[T]] | None:
        """The deepest registered prefix of ``key`` with its values."""
        node = self._root
        best: tuple[str, list[T]] | None = None
        comps: list[str] = []
        if node.values:
            best = ("/", list(node.values))
        for comp in split_path(key):
            node = node.children.get(comp)  # type: ignore[assignment]
            if node is None:
                break
            comps.append(comp)
            if node.values:
                best = ("/" + "/".join(comps), list(node.values))
        return best

    def iter_prefixes(self) -> Iterator[tuple[str, list[T]]]:
        stack: list[tuple[str, _Node[T]]] = [("", self._root)]
        while stack:
            path, node = stack.pop()
            if node.values:
                yield (path or "/", list(node.values))
            for comp, child in node.children.items():
                stack.append((f"{path}/{comp}", child))
