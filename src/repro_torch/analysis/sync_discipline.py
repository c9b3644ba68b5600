"""Pass 2 — host-sync discipline: one device→host sync site, statically.

The port's counterpart of the JAX package's ``analysis/sync_discipline.py``.
The serving invariant ``stats.host_syncs == stats.ticks`` only trips at
test time; this pass enforces its precondition at lint time: in the fast
path (``serving/``, ``models/``, ``kernels/``, ``launch/``,
``core/store.py``) every device→host sync point is flagged unless it sits
inside THE allowlisted sync site.

Flagged constructs:

- ``.cpu()``, ``.item()`` and ``.tolist()`` method calls, and ``.to(...)``
  whose target is the CPU (``"cpu"``, ``torch.device("cpu")`` or
  ``device="cpu"``): each pulls a tensor to the host;
- ``.numpy()`` of a *device-tainted* value, or with ``force=True``;
- ``torch.cuda.synchronize(...)`` and any stream's or event's
  ``.synchronize()``;
- ``np.asarray``/``np.array`` whose argument mentions a device-tainted
  name, and ``float()``/``bool()``/``int()`` of a device-tainted name —
  implicit syncs that are invisible in a grep.

Taint is intra-function: names assigned from ``torch.*`` calls, from
``.to(device)`` / ``.cuda()``, from a method or arithmetic of a tainted
value, or from calls of the port's model and kernel entry points
(``DEVICE_ENTRY_POINTS``) or of a fused callable (``NAME =
fuse_stages(...)``, ``NAME = ....build(...)`` of a ``FastPathPipeline``)
are device values; tainted-ness follows simple assignment and
subscripting.  These stand where the JAX pass has jitted callables.

The allowlist is a ``# lint: sync-site(...)`` pragma on the function def:
every sync inside it is sanctioned, and the RUNNER enforces that at most
one sync site exists across the fast path — a second pragma is itself a
violation, so the "single sync point" rule cannot erode one annotation at
a time.  Point suppressions use ``# lint: allow-sync(why)``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field

from .base import Finding, SourceInfo, dotted_name
from .donation import is_fused_constructor

_DEVICE_PRODUCER_PREFIXES = ("torch.",)
# torch.* calls whose value lives on the host
_HOST_PRODUCERS = {"torch.from_numpy", "torch.device", "torch.Generator",
                   "torch.cuda.Stream", "torch.cuda.Event",
                   "torch.cuda.current_stream", "torch.cuda.device_count",
                   "torch.cuda.is_available", "torch.cuda.current_device"}
# the port's model and kernel entry points, by their last name: each
# returns tensors on its inputs' device
DEVICE_ENTRY_POINTS = {
    "forward", "prefill", "decode_step", "paged_mixed_step", "paged_prefill",
    "paged_decode_step", "sample_with_scores", "speculative_verify", "moe",
    "ragged_paged_attention", "paged_decode_attention", "decode_attention",
    "flash_attention", "ssd",
}
_HOST_CONVERTERS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array"}
_SCALAR_CONVERTERS = {"float", "bool", "int"}
# tensor methods whose value is on the host
_HOST_METHODS = {"cpu", "item", "tolist", "numpy"}


@dataclass
class SyncSite:
    """A declared (pragma'd) sanctioned sync function."""
    path: str
    qualname: str
    line: int


@dataclass
class SyncReport:
    findings: list[Finding] = field(default_factory=list)
    sync_sites: list[SyncSite] = field(default_factory=list)


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    return (isinstance(node, ast.Call)
            and dotted_name(node.func) == "torch.device" and bool(node.args)
            and isinstance(node.args[0], ast.Constant)
            and node.args[0].value == "cpu")


def to_cpu(call: ast.Call) -> bool:
    """A ``.to(...)`` call whose target device is the CPU."""
    if not (isinstance(call.func, ast.Attribute) and call.func.attr == "to"):
        return False
    return ((bool(call.args) and _is_cpu(call.args[0]))
            or any(kw.arg == "device" and _is_cpu(kw.value)
                   for kw in call.keywords))


class _FunctionTaint(ast.NodeVisitor):
    """In-order walk of one function: taint device names, flag sync points."""

    def __init__(self, src: SourceInfo, fused: set[str], rule: str,
                 qual: str) -> None:
        self.src = src
        self.fused = set(fused)       # names whose call yields device values
        self.rule = rule
        self.qual = qual
        self.tainted: set[str] = set()
        self.findings: list[Finding] = []

    # ------------------------------------------------------------- helpers
    def _produces_device_value(self, call: ast.Call) -> bool:
        func = call.func
        if isinstance(func, ast.Attribute):
            if func.attr in _HOST_METHODS or to_cpu(call):
                return False          # that IS the host transfer
            if func.attr in ("to", "cuda"):
                return True
            if self._mentions_tainted(func.value):
                return True           # a method of a device value
        dn = dotted_name(func)
        if dn is None:
            return False
        if dn in self.fused or dn.rsplit(".", 1)[-1] in DEVICE_ENTRY_POINTS:
            return True
        if dn in _HOST_PRODUCERS:
            return False
        return dn.startswith(_DEVICE_PRODUCER_PREFIXES)

    def _mentions_tainted(self, node: ast.AST) -> bool:
        return any(isinstance(n, ast.Name) and n.id in self.tainted
                   for n in ast.walk(node))

    def _flag(self, node: ast.AST, msg: str) -> None:
        line = node.lineno
        end = getattr(node, "end_lineno", line) or line
        if self.src.pragma_at(line, end, "allow-sync"):
            return
        self.findings.append(Finding(self.src.path, line, self.rule,
                                     f"{msg} (in {self.qual})"))

    def _taint_target(self, target: ast.AST) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._taint_target(el)

    # ------------------------------------------------------------- visits
    def visit_Assign(self, node: ast.Assign) -> None:
        self.visit(node.value)
        value = node.value
        taints = False
        if is_fused_constructor(value):
            for t in node.targets:
                dn = dotted_name(t)
                if dn is not None:
                    self.fused.add(dn)
        elif isinstance(value, ast.Call):
            taints = self._produces_device_value(value)
        elif isinstance(value, ast.Name):
            taints = value.id in self.tainted
        elif isinstance(value, ast.Subscript):
            taints = self._mentions_tainted(value.value)
        elif isinstance(value, (ast.BinOp, ast.UnaryOp)):
            taints = self._mentions_tainted(value)
        if taints:
            for t in node.targets:
                self._taint_target(t)
        else:
            # reassignment from a host expression clears the taint
            for t in node.targets:
                if isinstance(t, ast.Name):
                    self.tainted.discard(t.id)

    def visit_Call(self, node: ast.Call) -> None:
        dn = dotted_name(node.func)
        attr = node.func.attr if isinstance(node.func, ast.Attribute) \
            else None
        if dn == "torch.cuda.synchronize":
            self._flag(node, "torch.cuda.synchronize is a device->host sync")
        elif attr == "synchronize":
            self._flag(node, ".synchronize() is a device->host sync")
        elif attr in ("cpu", "item", "tolist") and not node.args:
            self._flag(node, f".{attr}() forces a device->host transfer")
        elif to_cpu(node):
            self._flag(node, ".to(<cpu>) forces a device->host transfer")
        elif attr == "numpy" and (
                self._mentions_tainted(node.func.value)
                or any(kw.arg == "force" for kw in node.keywords)):
            self._flag(node, ".numpy() of a device value syncs it to host")
        elif dn in _HOST_CONVERTERS and node.args \
                and self._mentions_tainted(node.args[0]):
            self._flag(node, f"{dn} of a device value syncs it to host")
        elif dn in _SCALAR_CONVERTERS and node.args \
                and self._mentions_tainted(node.args[0]):
            self._flag(node, f"{dn}() of a device value syncs it to host")
        self.generic_visit(node)


class SyncDisciplinePass:
    name = "host-sync"

    def run(self, src: SourceInfo) -> list[Finding]:
        return self.run_full(src).findings

    def run_full(self, src: SourceInfo) -> SyncReport:
        report = SyncReport()
        module_fused = self._module_fused(src.tree)
        for cls_name, fn, fused in self._functions(src.tree, module_fused):
            qual = f"{cls_name}.{fn.name}" if cls_name else fn.name
            deco_first = min([fn.lineno]
                             + [d.lineno for d in fn.decorator_list])
            if src.pragma_at(deco_first, fn.lineno, "sync-site"):
                report.sync_sites.append(
                    SyncSite(src.path, qual, fn.lineno))
                continue              # the sanctioned sync point
            walker = _FunctionTaint(src, fused, self.name, qual)
            for stmt in fn.body:
                walker.visit(stmt)
            report.findings.extend(walker.findings)
        return report

    # -------------------------------------------------------------- scans
    @staticmethod
    def _module_fused(tree: ast.Module) -> set[str]:
        fused: set[str] = set()
        for node in tree.body:
            if isinstance(node, ast.Assign) \
                    and is_fused_constructor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        fused.add(t.id)
        return fused

    @staticmethod
    def _functions(tree: ast.Module, module_fused: set[str]):
        """Yield (class name | None, function, fused-name set) triples."""
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                yield None, node, set(module_fused)
            elif isinstance(node, ast.ClassDef):
                cls_fused = set(module_fused)
                for sub in ast.walk(node):
                    if isinstance(sub, ast.Assign) \
                            and is_fused_constructor(sub.value):
                        for t in sub.targets:
                            dn = dotted_name(t)
                            if dn and dn.startswith("self."):
                                cls_fused.add(dn)    # "self._fused"
                for item in node.body:
                    if isinstance(item, ast.FunctionDef):
                        yield node.name, item, cls_fused
