"""The port's host core (``repro_torch.core``: objects, versioning, the
persistent log, pools, placement, the dispatcher, the store, the path trie,
the DFG, the lambda API and ``CascadeService``) under the JAX package's own
scenarios, on the CPU.

Those modules are copies of the JAX package's, so their tests are too: the
scenarios of ``tests/test_store_core.py``, ``tests/test_dispatcher.py``,
``tests/test_log.py``, ``tests/test_trie.py`` and
``tests/test_dfg_service.py`` are read from those files and run here with
every ``repro.`` import pointed at ``repro_torch.`` (``repro_torch.core``
exports the names ``repro.core`` does, bar the device fast path).  Each
scenario runs under the port's lock-order tracker and sync-site sanitizer.
"""
import ast
import inspect
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.sanitizer import LockOrderTracker, SyncSiteSanitizer

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SOURCES = ("test_store_core", "test_dispatcher", "test_log", "test_trie",
           "test_dfg_service")


class _ToPort(ast.NodeTransformer):
    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod.startswith("repro."):
            node.module = "repro_torch" + mod[len("repro"):]
        return node

    def visit_Call(self, node):
        """``__import__("repro.x", ...)`` inside a scenario → the port."""
        self.generic_visit(node)
        arg = node.args[0] if node.args else None
        if (getattr(node.func, "id", None) == "__import__"
                and isinstance(arg, ast.Constant)
                and arg.value.startswith("repro.")):
            arg.value = "repro_torch" + arg.value[len("repro"):]
        return node


def _load(stem: str) -> dict:
    """The scenarios of ``tests/<stem>.py``, executed against the port."""
    path = TESTS / f"{stem}.py"
    tree = _ToPort().visit(ast.parse(path.read_text()))
    ns = {"__name__": f"{stem}_on_the_port", "__file__": str(path)}
    exec(compile(ast.fix_missing_locations(tree), str(path), "exec"), ns)
    return ns


_SCENARIOS = {stem: _load(stem) for stem in SOURCES}


def _cases():
    for stem, ns in _SCENARIOS.items():
        for name, fn in ns.items():
            if not (name.startswith("test_") and callable(fn)):
                continue
            marks = [m for m in getattr(fn, "pytestmark", [])
                     if m.name == "parametrize"]
            if not marks:
                yield pytest.param(stem, name, {}, id=f"{stem}::{name}")
                continue
            (mark,) = marks
            argname, values = mark.args
            for v in values:
                yield pytest.param(stem, name, {argname: v},
                                   id=f"{stem}::{name}[{v}]")


@pytest.fixture(autouse=True)
def port_sanitizers():
    """The port's lock-order tracker and sync-site sanitizer around every
    test: a lock-order inversion, or a host transfer from the fast path
    outside ``ServeEngine._to_host``, fails it."""
    tracker, sync = LockOrderTracker(), SyncSiteSanitizer()
    tracker.install()
    sync.install()
    try:
        yield
    finally:
        tracker.uninstall()
        sync.uninstall()
    assert not tracker.violations, "; ".join(tracker.violations)
    assert not sync.violations, "; ".join(sync.violations)


def test_scenarios_import_only_the_port():
    for stem, ns in _SCENARIOS.items():
        mods = {getattr(v, "__module__", "") for v in ns.values()
                if inspect.isclass(v) or inspect.isfunction(v)}
        assert not any(m.split(".")[0] == "repro" for m in mods), (stem, mods)
        assert any(m.startswith("repro_torch.core.") for m in mods), stem


@pytest.mark.parametrize("stem,name,kwargs", list(_cases()))
def test_reference_scenario_on_the_port(stem, name, kwargs, tmp_path):
    fn = _SCENARIOS[stem][name]
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)
