"""Shared machinery for the port's cascade-lint passes: findings, pragmas,
sources (a copy of the JAX package's ``analysis/base.py``, which imports
no framework).

Pragma grammar (one per comment)::

    # lint: <name>(<arg>) [free-form justification]

``name`` is the suppression kind (``guarded-by``, ``allow-sync``,
``sync-site``, ``allow-donated-read``, ``static-ok``); ``arg`` is
kind-specific (a lock name for ``guarded-by``, otherwise the start of the
justification).  A pragma attaches to every line of the statement it sits
on; a pragma alone on a line attaches to the line below it (annotating
the statement it precedes).
"""
from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Iterator

PRAGMA_RE = re.compile(r"#\s*lint:\s*([a-z-]+)\(([^)]*)\)")


@dataclass(frozen=True)
class Finding:
    path: str
    line: int
    rule: str          # "lock-discipline" | "host-sync" | "donation" | "recompile"
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


@dataclass(frozen=True)
class Pragma:
    name: str
    arg: str
    line: int          # the source line the pragma governs


@dataclass
class SourceInfo:
    """One parsed file: AST + per-line pragmas, shared by every pass."""

    path: str
    text: str
    tree: ast.Module
    pragmas: dict[int, list[Pragma]] = field(default_factory=dict)

    @classmethod
    def from_source(cls, text: str, path: str = "<string>") -> "SourceInfo":
        tree = ast.parse(text, filename=path)
        info = cls(path=path, text=text, tree=tree)
        lines = text.splitlines()
        for i, raw in enumerate(lines, start=1):
            m = PRAGMA_RE.search(raw)
            if not m:
                continue
            target = i
            # a standalone pragma line annotates the statement below it
            if raw.lstrip().startswith("#"):
                target = i + 1
            info.pragmas.setdefault(target, []).append(
                Pragma(name=m.group(1), arg=m.group(2).strip(), line=target))
        return info

    @classmethod
    def parse(cls, path: str) -> "SourceInfo":
        with open(path, encoding="utf-8") as f:
            return cls.from_source(f.read(), path)

    def pragma_at(self, first: int, last: int | None, name: str
                  ) -> Pragma | None:
        """The first ``name`` pragma attached to lines [first, last]."""
        for line in range(first, (last or first) + 1):
            for p in self.pragmas.get(line, ()):
                if p.name == name:
                    return p
        return None

    def all_pragmas(self, name: str) -> list[Pragma]:
        return [p for ps in self.pragmas.values() for p in ps
                if p.name == name]


def iter_python_files(paths: list[str]) -> Iterator[str]:
    """Expand files/directories into a sorted stream of .py paths."""
    seen: set[str] = set()
    for root in paths:
        if os.path.isfile(root):
            if root not in seen:
                seen.add(root)
                yield root
            continue
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames.sort()
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    p = os.path.join(dirpath, fn)
                    if p not in seen:
                        seen.add(p)
                        yield p


def dotted_name(node: ast.AST) -> str | None:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def self_attr_root(node: ast.AST) -> str | None:
    """For a target/load path rooted at ``self`` — ``self.X...`` possibly
    through further attributes/subscripts — the first attribute ``X``."""
    cur = node
    attr: str | None = None
    while True:
        if isinstance(cur, ast.Attribute):
            attr = cur.attr
            cur = cur.value
        elif isinstance(cur, ast.Subscript):
            cur = cur.value
        else:
            break
    if isinstance(cur, ast.Name) and cur.id == "self" and attr is not None:
        return attr
    return None
