"""Pass 1 — lock discipline: infer guarded-by, flag unguarded mutations.

A copy of the JAX package's ``analysis/lock_discipline.py``: the pass reads
threading constructs only, so it is the same over the port.

For every class, the pass first finds its lock attributes (``self.X =
threading.Lock()`` / ``RLock()`` / ``Condition(...)``), then walks every
method recording each mutation of a ``self.Y`` attribute together with the
set of locks lexically held (``with self.X:`` blocks, plus local
with-contexts like ``with seq_lock:``).  The guarded-by relation is
INFERRED: an attribute mutated at least once while holding one of the
class's locks is considered guarded by the lock(s) held at *every* such
site.  Any other mutation of that attribute — outside the guard lock —
is flagged.

Deliberate exceptions are annotated in place::

    self._versions[vkey] = version   # lint: guarded-by(seq_lock) ...

The pragma must name the inferred guard lock OR a lock actually held at
the site (a class lock attribute or a local with-context variable) — a
wrong or stale lock name keeps the finding, so annotations cannot rot
silently.

Out of scope, deliberately: ``__init__``/``__post_init__``/``__del__``
(construction and teardown are single-threaded), attributes never mutated
under any lock (single-writer state — the engine's one-driver model), and
mutations through non-``self`` objects (cross-object discipline belongs
to the owning class).  Mutations inside nested ``def``s are analyzed with
an EMPTY held set: a closure runs at call time, when the enclosing
``with`` is long gone.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

from .base import Finding, SourceInfo, dotted_name, self_attr_root

LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}
# intrinsically thread-safe attributes: never part of the guarded-by relation
ATOMIC_FACTORIES = {
    "threading.Event", "Event", "threading.Semaphore", "Semaphore",
    "threading.BoundedSemaphore", "queue.SimpleQueue", "queue.Queue",
    "SimpleQueue", "Queue",
}
MUTATOR_METHODS = {
    "append", "appendleft", "extend", "insert", "pop", "popleft",
    "popitem", "remove", "clear", "add", "discard", "update",
    "setdefault", "sort", "reverse",
}
EXEMPT_METHODS = {"__init__", "__post_init__", "__new__", "__del__"}


@dataclass
class _Mutation:
    attr: str
    line: int
    end_line: int
    held_self: frozenset[str]     # class lock attrs held at the site
    held_local: frozenset[str]    # non-self with-contexts held at the site
    exempt: bool                  # __init__-family method


def _call_factory(value: ast.AST) -> str | None:
    if isinstance(value, ast.Call):
        return dotted_name(value.func)
    return None


class _MethodWalker(ast.NodeVisitor):
    """Collect self-attribute mutations with the lexically held lock set."""

    def __init__(self, lock_attrs: set[str], atomic_attrs: set[str],
                 exempt: bool) -> None:
        self.lock_attrs = lock_attrs
        self.atomic_attrs = atomic_attrs
        self.exempt = exempt
        self.held_self: list[str] = []
        self.held_local: list[str] = []
        self.mutations: list[_Mutation] = []

    # ------------------------------------------------------------ helpers
    def _record(self, target: ast.AST, node: ast.stmt) -> None:
        attr = self_attr_root(target)
        if attr is None or attr in self.lock_attrs \
                or attr in self.atomic_attrs:
            return
        self.mutations.append(_Mutation(
            attr=attr, line=node.lineno,
            end_line=getattr(node, "end_lineno", node.lineno) or node.lineno,
            held_self=frozenset(self.held_self),
            held_local=frozenset(self.held_local),
            exempt=self.exempt))

    # ----------------------------------------------------------- contexts
    def _visit_with(self, node: ast.With) -> None:
        pushed_self: list[str] = []
        pushed_local: list[str] = []
        for item in node.items:
            ctx = item.context_expr
            name = self_attr_root(ctx)
            if name is not None and name in self.lock_attrs:
                pushed_self.append(name)
                self.held_self.append(name)
            else:
                dn = dotted_name(ctx)
                if dn is not None:
                    pushed_local.append(dn)
                    self.held_local.append(dn)
        for stmt in node.body:
            self.visit(stmt)
        for _ in pushed_self:
            self.held_self.pop()
        for _ in pushed_local:
            self.held_local.pop()

    visit_With = _visit_with

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        # nested def: the enclosing with-block is NOT held at call time
        saved_s, saved_l = self.held_self, self.held_local
        self.held_self, self.held_local = [], []
        for stmt in node.body:
            self.visit(stmt)
        self.held_self, self.held_local = saved_s, saved_l

    visit_AsyncFunctionDef = visit_FunctionDef

    # ---------------------------------------------------------- mutations
    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                self._record(el, node)
        self.visit(node.value)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._record(node.target, node)
        self.visit(node.value)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._record(node.target, node)
            self.visit(node.value)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            self._record(t, node)

    def visit_Call(self, node: ast.Call) -> None:
        # self.X...<mutator>(...) mutates X in place
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in MUTATOR_METHODS:
            attr = self_attr_root(node.func.value)
            if attr is not None:
                self._record(node.func.value, node)
        self.generic_visit(node)


class LockDisciplinePass:
    name = "lock-discipline"

    def run(self, src: SourceInfo) -> list[Finding]:
        findings: list[Finding] = []
        for cls in [n for n in ast.walk(src.tree)
                    if isinstance(n, ast.ClassDef)]:
            findings.extend(self._check_class(src, cls))
        return findings

    # ----------------------------------------------------------- per-class
    def _check_class(self, src: SourceInfo, cls: ast.ClassDef
                     ) -> list[Finding]:
        lock_attrs: set[str] = set()
        atomic_attrs: set[str] = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                factory = _call_factory(node.value)
                for t in node.targets:
                    attr = self_attr_root(t)
                    if attr is None:
                        continue
                    if factory in LOCK_FACTORIES:
                        lock_attrs.add(attr)
                    elif factory in ATOMIC_FACTORIES:
                        atomic_attrs.add(attr)
        if not lock_attrs:
            return []

        mutations: list[_Mutation] = []
        for item in cls.body:
            if not isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            walker = _MethodWalker(lock_attrs, atomic_attrs,
                                   exempt=item.name in EXEMPT_METHODS)
            for stmt in item.body:
                walker.visit(stmt)
            mutations.extend(walker.mutations)

        # infer guarded-by: locks held at EVERY lock-holding mutation site
        guards: dict[str, frozenset[str]] = {}
        for m in mutations:
            if m.exempt:
                continue
            held = m.held_self & frozenset(lock_attrs)
            if not held:
                continue
            guards[m.attr] = (guards[m.attr] & held if m.attr in guards
                              else held)

        findings: list[Finding] = []
        for m in mutations:
            if m.exempt:
                continue
            guard = guards.get(m.attr)
            if not guard:
                continue          # never locked (single-writer) or consistent
            if guard & m.held_self:
                continue          # the guard lock is held
            pragma = src.pragma_at(m.line, m.end_line, "guarded-by")
            if pragma is not None:
                named = pragma.arg
                # the pragma must tell the truth: name the inferred guard
                # or a lock actually held at this site
                if named in guard or named in m.held_self \
                        or named in m.held_local:
                    continue
                findings.append(Finding(
                    src.path, m.line, self.name,
                    f"{cls.name}.{m.attr} is guarded by "
                    f"{self._fmt(guard)} but the pragma names "
                    f"{named!r}, which is neither the guard nor held "
                    f"here — fix the annotation or the code"))
                continue
            where = (f" while holding {self._fmt(m.held_self)}"
                     if m.held_self else " without any lock")
            hint = (f" (held local context {self._fmt(m.held_local)}: "
                    f"annotate with `# lint: guarded-by(...)` if it is "
                    f"the real guard)" if m.held_local else "")
            findings.append(Finding(
                src.path, m.line, self.name,
                f"{cls.name}.{m.attr} is mutated under "
                f"{self._fmt(guard)} elsewhere but mutated here"
                f"{where}{hint}"))
        return findings

    @staticmethod
    def _fmt(names: frozenset[str]) -> str:
        return "/".join(sorted(names))
