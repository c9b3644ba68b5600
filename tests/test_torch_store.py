"""The port's host core (``repro_torch.core``: objects, versioning, the
persistent log, pools, placement, the dispatcher and the store) under the
JAX package's own scenarios, on the CPU.

Those modules are copies of the JAX package's, so their tests are too: the
scenarios of ``tests/test_store_core.py``, ``tests/test_dispatcher.py`` and
``tests/test_log.py`` are read from those files and run here with every
``repro.`` import pointed at ``repro_torch.`` (a name the JAX tests import
from the ``repro.core`` package comes from the port's submodule that
defines it; ``CascadeService``, imported but unused there, waits for the
port's ``core/service.py``).  Each scenario runs under the reference's
lock-order tracker, installed for the port's modules.
"""
import ast
import importlib
import inspect
from pathlib import Path

import pytest
import torch

from repro.analysis.sanitizer import LockOrderTracker

torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
SOURCES = ("test_store_core", "test_dispatcher", "test_log")
PORT_CORE = ("objects", "versioning", "log", "pools", "placement",
             "dispatcher", "store", "trie")


def _homes() -> dict[str, str]:
    """Each public name of the port's core modules → the module defining
    it."""
    homes = {}
    for name in PORT_CORE:
        mod = importlib.import_module(f"repro_torch.core.{name}")
        for attr, val in vars(mod).items():
            if (not attr.startswith("_")
                    and getattr(val, "__module__", mod.__name__)
                    == mod.__name__):
                homes.setdefault(attr, mod.__name__)
    return homes


class _ToPort(ast.NodeTransformer):
    def __init__(self, homes: dict[str, str]) -> None:
        self.homes = homes

    def visit_ImportFrom(self, node):
        mod = node.module or ""
        if mod == "repro.core":
            return [ast.ImportFrom(module=self.homes[a.name], names=[a],
                                   level=0)
                    for a in node.names if a.name in self.homes]
        if mod.startswith("repro."):
            node.module = "repro_torch" + mod[len("repro"):]
        return node


def _load(stem: str) -> dict:
    """The scenarios of ``tests/<stem>.py``, executed against the port."""
    path = TESTS / f"{stem}.py"
    tree = _ToPort(_homes()).visit(ast.parse(path.read_text()))
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


@pytest.fixture
def lock_order():
    """The reference's lock-order tracker over the port's modules."""
    tracker = LockOrderTracker()
    tracker.install(module_prefixes=("repro_torch.",))
    try:
        yield tracker
    finally:
        tracker.uninstall()
    assert not tracker.violations, "; ".join(tracker.violations)


def test_scenarios_import_only_the_port():
    for stem, ns in _SCENARIOS.items():
        mods = {getattr(v, "__module__", "") for v in ns.values()
                if inspect.isclass(v) or inspect.isfunction(v)}
        assert not any(m.split(".")[0] == "repro" for m in mods), (stem, mods)
        assert any(m.startswith("repro_torch.core.") for m in mods), stem


@pytest.mark.parametrize("stem,name,kwargs", list(_cases()))
def test_reference_scenario_on_the_port(stem, name, kwargs, tmp_path,
                                        lock_order):
    fn = _SCENARIOS[stem][name]
    if "tmp_path" in inspect.signature(fn).parameters:
        kwargs = dict(kwargs, tmp_path=tmp_path)
    fn(**kwargs)
