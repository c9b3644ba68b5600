"""Pass 3 — donation & recompile hazards around the fused fast path.

The port's counterpart of the JAX package's ``analysis/donation.py``, over
``core/fastpath.py``'s fused callables in place of ``jax.jit``.  Two rules:

**Donation (use-after-donate).**  ``X = fuse_stages(stages)`` (``donate``
omitted or ``True``) or ``X = <pipeline>.build(donate_input=True)`` keeps
the first tensor it is given as its CUDA graph's static input buffer, and
every later call of that shape copies its own input into it.  JAX turns a
read of a donated buffer into an error; torch cannot invalidate a tensor,
so reading it gives *another call's input*, silently.  Within each
function the pass tracks calls of known donating names, marks the first
positional operand's dotted path dead, and flags any later *read* of a
dead path.  A store to the same path revives it.  The analysis is linear
over the statement stream, so a read that is only conditionally dead is
still flagged; annotate real counterexamples with
``# lint: allow-donated-read(why)``.

**Recompile (capture hazard).**  A fused callable keys its captures on its
extra operands (``fastpath._key``), a Python scalar by its value.  Calls of
a known fused name (donating or not) that pass a bare int/float/bool
literal or a ``len(...)`` as an extra operand are flagged: each new value
is a new capture, and past ``max_graphs`` an eviction that synchronises the
device.  Suppress a value that is constant per build with
``# lint: static-ok(why)``.

Only a *literal* ``donate`` / ``donate_input`` is understood; fused names
built through helpers or comprehensions are out of scope (they get no
findings, not wrong ones).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass

from .base import Finding, SourceInfo, dotted_name


@dataclass(frozen=True)
class FusedCallable:
    name: str            # dotted name it is callable as, e.g. "self._fused"
    donates: bool        # its first operand becomes the graph's input buffer


def _literal_bool(node: ast.AST) -> bool | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, bool):
        return node.value
    return None


def is_fused_constructor(value: ast.AST) -> bool:
    """``fuse_stages(...)`` or ``<pipeline>.build(...)``: a callable whose
    calls run a fused chain on the device."""
    if not isinstance(value, ast.Call):
        return False
    dn = dotted_name(value.func) or ""
    return (dn.rsplit(".", 1)[-1] == "fuse_stages"
            or (isinstance(value.func, ast.Attribute)
                and value.func.attr == "build"
                and any(kw.arg == "donate_input" for kw in value.keywords)))


def _fused_spec(value: ast.AST) -> bool | None:
    """Whether a fused constructor call donates its first operand, or None
    when ``value`` is no fused constructor (or its flag is not literal)."""
    if not is_fused_constructor(value):
        return None
    kws = {kw.arg: kw.value for kw in value.keywords}
    if isinstance(value.func, ast.Attribute) and value.func.attr == "build":
        return _literal_bool(kws["donate_input"])
    if "donate" not in kws:
        return True                  # fuse_stages donates by default
    return _literal_bool(kws["donate"])


def collect_fused(tree: ast.Module) -> dict[str, FusedCallable]:
    """Fused callables bound to stable names, module- and class-level."""
    out: dict[str, FusedCallable] = {}
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assign):
            continue
        donates = _fused_spec(node.value)
        if donates is None:
            continue
        for t in node.targets:
            dn = dotted_name(t)
            if dn is not None:
                out[dn] = FusedCallable(dn, donates)
    return out


class _ScopeWalker(ast.NodeVisitor):
    """Linear walk of one function: dead donated paths + literal-arg calls."""

    def __init__(self, src: SourceInfo, fused: dict[str, FusedCallable],
                 qual: str) -> None:
        self.src = src
        self.fused = fused
        self.qual = qual
        self.dead: dict[str, int] = {}     # dotted path -> donation line
        self.findings: list[Finding] = []

    # ------------------------------------------------------------- helpers
    def _check_reads(self, node: ast.AST) -> None:
        if not self.dead:
            return
        for sub in ast.walk(node):
            dn = dotted_name(sub)
            if dn is None or dn not in self.dead:
                continue
            if not isinstance(getattr(sub, "ctx", None), ast.Load):
                continue
            line = sub.lineno
            end = getattr(sub, "end_lineno", line) or line
            if self.src.pragma_at(line, end, "allow-donated-read"):
                continue
            self.findings.append(Finding(
                self.src.path, line, "donation",
                f"{dn} was donated to a fused call on line "
                f"{self.dead[dn]} and not rebound — it now holds a later "
                f"call's input: reading it is a use-after-donate "
                f"(in {self.qual})"))

    def _apply_stores(self, node: ast.stmt) -> None:
        targets: list[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        for t in targets:
            for el in (t.elts if isinstance(t, (ast.Tuple, ast.List))
                       else [t]):
                dn = dotted_name(el)
                if dn is not None:
                    self.dead.pop(dn, None)

    def _apply_calls(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            fn = dotted_name(sub.func)
            spec = self.fused.get(fn) if fn else None
            if spec is None:
                continue
            if spec.donates and sub.args:
                dn = dotted_name(sub.args[0])
                if dn is not None:
                    self.dead[dn] = sub.lineno
            self._check_capture_args(sub, fn)

    def _check_capture_args(self, call: ast.Call, fn: str) -> None:
        for arg in call.args[1:]:
            hazard: str | None = None
            if isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, (bool, int, float)):
                hazard = f"Python scalar literal {arg.value!r}"
            elif isinstance(arg, ast.Call) \
                    and dotted_name(arg.func) == "len":
                hazard = "len(...) (varies with input size)"
            if hazard is None:
                continue
            line = arg.lineno
            end = getattr(arg, "end_lineno", line) or line
            if self.src.pragma_at(line, end, "static-ok") \
                    or self.src.pragma_at(call.lineno,
                                          getattr(call, "end_lineno", None),
                                          "static-ok"):
                continue
            self.findings.append(Finding(
                self.src.path, line, "recompile",
                f"{fn} is a fused call keyed on its extra operands but is "
                f"passed {hazard}: every new value is a new capture, and "
                f"past max_graphs an eviction that syncs the device — pass "
                f"a tensor or a value fixed per build (in {self.qual})"))

    # -------------------------------------------------------------- visits
    def _statement(self, node: ast.stmt) -> None:
        """Reads are checked BEFORE this statement's own donation takes
        effect, so the donating call itself is not a use-after-donate."""
        self._check_reads(node)
        self._apply_stores(node)
        self._apply_calls(node)

    def visit(self, node: ast.AST) -> None:  # type: ignore[override]
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return                    # nested scope: separate analysis
        if isinstance(node, (ast.If, ast.For, ast.While, ast.With,
                             ast.Try)):
            # compound statement: check its header expression, then the
            # bodies in order (linear approximation of control flow)
            for field_ in ("test", "iter", "items", "subject"):
                sub = getattr(node, field_, None)
                if sub is not None:
                    subs = sub if isinstance(sub, list) else [sub]
                    for s in subs:
                        self._check_reads(s)
                        self._apply_calls(s)
            for body_field in ("body", "orelse", "finalbody"):
                for stmt in getattr(node, body_field, []) or []:
                    self.visit(stmt)
            for handler in getattr(node, "handlers", []) or []:
                for stmt in handler.body:
                    self.visit(stmt)
        elif isinstance(node, ast.stmt):
            self._statement(node)


class DonationPass:
    name = "donation"

    def run(self, src: SourceInfo) -> list[Finding]:
        fused = collect_fused(src.tree)
        if not fused:
            return []
        findings: list[Finding] = []
        for qual, fn in self._functions(src.tree):
            walker = _ScopeWalker(src, fused, qual)
            for stmt in fn.body:
                walker.visit(stmt)
            findings.extend(walker.findings)
        return findings

    @staticmethod
    def _functions(tree: ast.Module):
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                yield node.name, node
            elif isinstance(node, ast.ClassDef):
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        yield f"{node.name}.{item.name}", item
