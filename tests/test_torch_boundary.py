"""The PyTorch port's import boundary and device default.

``src/repro_torch/``, ``chip_smoke.py``, ``trace_records.py``,
``ab_dense.py`` and the example twins in ``examples_torch/`` import no
jax and nothing of the JAX package ``repro`` (whose package ``__init__``
files pull in jax); the
port's entry points and the twins run on the card unless the caller asks
for the CPU.
"""
import ast
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TWINS = sorted((ROOT / "examples_torch").glob("*.py"))
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py", ROOT / "trace_records.py",
     ROOT / "ab_dense.py"] + TWINS


def _imported_modules(path: Path) -> list[str]:
    mods = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            mods += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              == "import_module" and node.args
              and isinstance(node.args[0], (ast.Constant, ast.JoinedStr))):
            arg = node.args[0]
            text = arg.value if isinstance(arg, ast.Constant) else "".join(
                v.value for v in arg.values if isinstance(v, ast.Constant))
            mods.append(text)
    return mods


def test_the_launch_package_is_in_scope():
    """``launch/`` (meshes, rules, placement) is part of the port that the
    boundary covers: each of its modules is in ``PORT_FILES``."""
    launch = ROOT / "src" / "repro_torch" / "launch"
    names = {p.name for p in PORT_FILES if p.parent == launch}
    assert {"__init__.py", "mesh.py", "sharding.py"} <= names


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists()
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {mod}"


def test_engine_import_pulls_in_no_jax():
    code = ("import sys; import repro_torch.serving.engine, "
            "repro_torch.kernels.decode_attention.ops, "
            "repro_torch.kernels.flash_attention.ops, repro_torch.models, "
            "repro_torch.kernels.ssd.ops, repro_torch.models.mamba2, "
            "repro_torch.core.store, repro_torch.serving.faults, "
            "repro_torch.configs.gemma3_4b, "
            "repro_torch.configs.h2o_danube_1_8b, "
            "repro_torch.configs.h2o_danube_3_4b, "
            "repro_torch.configs.mamba2_1_3b, "
            "repro_torch.configs.zamba2_2_7b, "
            "repro_torch.configs.musicgen_large, "
            "repro_torch.configs.phi_3_vision_4_2b, "
            "repro_torch.core.fastpath, repro_torch.analysis, "
            "repro_torch.analysis.sanitizer, repro_torch.launch.mesh, "
            "repro_torch.launch.sharding, repro_torch.training.ft, "
            "repro_torch.training.data; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')); print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_entry_points_default_to_the_card():
    """With no ``device`` argument the engine and the initialisers ask for
    cuda; where there is none they raise rather than run on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import (init_decode_caches, init_paged_pools,
                                    init_params)
    from repro_torch.serving.engine import ServeEngine

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    cfg = get_config("gemma2-9b", smoke=True)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        ServeEngine(cfg, params)
    ssm = get_config("mamba2-1.3b", smoke=True)
    ssm_params = init_params(ssm, torch.Generator().manual_seed(0),
                             device="cpu")
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        ServeEngine(ssm, ssm_params)
    with pytest.raises((RuntimeError, AssertionError)):
        init_decode_caches(ssm, 2, 8)
    with pytest.raises((RuntimeError, AssertionError)):
        init_paged_pools(cfg, 4, 4)
    with pytest.raises((RuntimeError, AssertionError)):
        init_params(cfg)


@pytest.mark.parametrize("path", TWINS, ids=lambda p: p.name)
def test_twins_default_to_the_card(path):
    """Each twin's ``--device`` defaults to cuda: with no card, its
    ``main()`` raises before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is usable")
    spec = importlib.util.spec_from_file_location(f"_twin_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with pytest.raises(RuntimeError, match="cuda|CUDA"):
        mod.main([])
