"""The port's cascade-lint (``repro_torch.analysis``) against the JAX
package's and over the port's own tree.

- Lock discipline: the port's pass is a copy of the JAX package's, so on
  every lock-pass fixture source of ``tests/test_cascade_lint.py`` (taken
  from that file's own tests) and on every file of ``src/repro_torch`` the
  two give the same findings.
- Host-sync discipline: torch cases for each flagged construct, the taint
  rules, the ``sync-site`` / ``allow-sync`` pragmas and the one-site budget
  over the fast-path scope (``serving/``, ``models/``, ``kernels/``,
  ``core/store.py``).
- Donation and recompile hazards over ``fuse_stages`` and
  ``FastPathPipeline.build``.
- The CLI: ``python -m repro_torch.analysis src/repro_torch`` exits 0, and
  a copy of the tree with a second ``sync-site``, a stray ``.item()`` in
  ``kernels/`` or a read of a donated ``fuse_stages`` input exits 1.
"""
import importlib.util
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as janalysis
from repro_torch.analysis import (DonationPass, LockDisciplinePass,
                                  SourceInfo, SyncDisciplinePass, lint_paths,
                                  main)

ROOT = Path(__file__).resolve().parents[1]
PORT_SRC = ROOT / "src" / "repro_torch"


def _run(pass_cls, source: str):
    src = SourceInfo.from_source(textwrap.dedent(source), "snippet.py")
    return pass_cls().run(src)


def _render(findings) -> list[tuple]:
    return [(f.line, f.rule, f.message) for f in findings]


# --------------------------------------------------------------------------
# Pass 1: lock discipline, the same as the JAX package's
# --------------------------------------------------------------------------

def _lock_fixture_sources() -> list[str]:
    """Every source ``tests/test_cascade_lint.py``'s lock-pass tests feed
    the JAX pass: its tests run once with ``_run`` recording them."""
    spec = importlib.util.spec_from_file_location(
        "_cascade_lint_sources", ROOT / "tests" / "test_cascade_lint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    sources, run = [], mod._run

    def recording(pass_cls, source):
        if pass_cls is mod.LockDisciplinePass:
            sources.append(source)
        return run(pass_cls, source)

    mod._run = recording
    for name in sorted(vars(mod)):
        if name.startswith("test_lock_pass_"):
            getattr(mod, name)()
    return sources


LOCK_SOURCES = _lock_fixture_sources()


def test_lock_fixture_sources_were_found():
    assert len(LOCK_SOURCES) >= 7


@pytest.mark.parametrize("i", range(len(LOCK_SOURCES)))
def test_lock_pass_matches_the_jax_pass_on_its_fixtures(i):
    src = textwrap.dedent(LOCK_SOURCES[i])
    want = janalysis.LockDisciplinePass().run(
        janalysis.SourceInfo.from_source(src, "snippet.py"))
    got = LockDisciplinePass().run(SourceInfo.from_source(src, "snippet.py"))
    assert _render(got) == _render(want)


def test_lock_pass_matches_the_jax_pass_over_the_port():
    for path in sorted(PORT_SRC.rglob("*.py")):
        want = janalysis.LockDisciplinePass().run(
            janalysis.SourceInfo.parse(str(path)))
        got = LockDisciplinePass().run(SourceInfo.parse(str(path)))
        assert _render(got) == _render(want), path


# --------------------------------------------------------------------------
# Pass 2: host-sync discipline over torch
# --------------------------------------------------------------------------

@pytest.mark.parametrize("body,what", [
    ("return t.cpu()", ".cpu()"),
    ("return t.item()", ".item()"),
    ("return t.tolist()", ".tolist()"),
    ('return t.to("cpu")', ".to(<cpu>)"),
    ('return t.to(device="cpu")', ".to(<cpu>)"),
    ('return t.to(torch.device("cpu"), non_blocking=True)', ".to(<cpu>)"),
    ("return t.numpy(force=True)", ".numpy()"),
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("torch.cuda.current_stream().synchronize()", ".synchronize()"),
    ("ev = torch.cuda.Event()\n    ev.synchronize()", ".synchronize()"),
])
def test_sync_pass_flags_each_host_transfer(body, what):
    findings = _run(SyncDisciplinePass, f"""
import torch

def peek(t):
    {body}
""")
    assert len(findings) == 1, findings
    assert findings[0].rule == "host-sync"
    assert what in findings[0].message and "peek" in findings[0].message


@pytest.mark.parametrize("produce", [
    "y = torch.sum(x)",                              # a torch.* call
    "y = x.to(dev)",                                 # .to(device)
    "y = x.cuda()",                                  # .cuda()
    "y = ops.flash_attention(x, x, x)",              # a kernel entry point
    "y = forward(params, x, pos, cfg)",              # a model entry point
    "z = torch.ones(3)\n    y = z.float() * 2",      # a method, arithmetic
    "z = torch.ones(3)\n    y = z[0]",               # a subscript
])
@pytest.mark.parametrize("convert,what", [
    ("float(y)", "float()"), ("int(y)", "int()"), ("bool(y)", "bool()"),
    ("np.asarray(y)", "np.asarray"), ("np.array(y)", "np.array"),
    ("y.numpy()", ".numpy()"),
])
def test_sync_pass_flags_implicit_syncs_of_device_values(produce, convert,
                                                         what):
    findings = _run(SyncDisciplinePass, f"""
import numpy as np
import torch

def step(x, dev, params, pos, cfg):
    {produce}
    return {convert}
""")
    assert len(findings) == 1, findings
    assert what in findings[0].message


def test_sync_pass_taints_what_a_fused_callable_returns():
    findings = _run(SyncDisciplinePass, """
        from repro_torch.core.fastpath import fuse_stages

        _run = fuse_stages(STAGES, donate=False)

        class Node:
            def __init__(self, stages):
                self._fused = fuse_stages(stages)

            def go(self, x):
                out = self._fused(x)
                return float(out)

        def drive(x, pipe):
            run = pipe.build(donate_input=False)
            a = _run(x)
            b = run(x)
            return int(a), bool(b)
    """)
    assert [(f.line, f.message.split(" (in ")[0]) for f in findings] == [
        (12, "float() of a device value syncs it to host"),
        (18, "int() of a device value syncs it to host"),
        (18, "bool() of a device value syncs it to host")]


def test_sync_pass_clean_on_host_values():
    assert _run(SyncDisciplinePass, """
        import numpy as np
        import torch

        def host_only(xs, flat, dev):
            acc = np.asarray(xs)
            host = torch.from_numpy(acc)
            view = host.numpy()
            moved = host.to(dev)
            moved = np.zeros(3)
            return float(sum(xs)), int(len(view)), float(moved[0])
    """) == []


def test_sync_pass_sync_site_pragma_exempts_function():
    findings = _run(SyncDisciplinePass, """
        class Engine:
            # lint: sync-site(the one per-tick pull)
            def _to_host(self, flat):
                return flat.cpu().numpy()

            def peek(self, flat):
                return flat.cpu()
    """)
    assert len(findings) == 1
    assert "Engine.peek" in findings[0].message


def test_sync_pass_allow_sync_pragma_suppresses():
    assert _run(SyncDisciplinePass, """
        def debug_dump(t):
            return t.cpu()  # lint: allow-sync(offline debug path)

        def check(t):
            # lint: allow-sync(a card probe reads one number)
            return t.abs().max().item()
    """) == []


def _tree(tmp_path, files: dict) -> Path:
    for rel, text in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(text))
    return tmp_path


SITE = """
    # lint: sync-site(THE one per-tick device->host pull)
    def _to_host(flat):
        return flat.cpu().numpy()
"""


def test_runner_enforces_single_sync_site_budget_over_kernels(tmp_path):
    root = _tree(tmp_path, {
        "serving/engine.py": SITE,
        "kernels/ssd/ops.py": SITE.replace("_to_host", "_pull"),
    })
    findings = lint_paths([str(root)])
    assert len(findings) == 1
    assert findings[0].path.endswith("serving/engine.py")
    assert "second `sync-site` pragma" in findings[0].message
    assert "kernels/ssd/ops.py" in findings[0].message


def test_runner_scope_is_the_fast_path(tmp_path):
    stray = "def peek(t):\n    return t.item()\n"
    root = _tree(tmp_path, {
        "kernels/a.py": stray, "models/b.py": stray, "serving/c.py": stray,
        "core/store.py": stray, "core/log.py": stray,
        "training/d.py": stray, "analysis/e.py": stray,
    })
    flagged = sorted(Path(f.path).relative_to(root).as_posix()
                     for f in lint_paths([str(root)]))
    assert flagged == ["core/store.py", "kernels/a.py", "models/b.py",
                       "serving/c.py"]


# --------------------------------------------------------------------------
# Pass 3: donation & recompile hazards over fuse_stages
# --------------------------------------------------------------------------

DONATING = """
    from repro_torch.core.fastpath import fuse_stages

    _fused = fuse_stages(STAGES{kw})

    def drive(x):
        out = _fused(x)
        {after}
"""


@pytest.mark.parametrize("kw", ["", ", donate=True", ", max_graphs=2"])
def test_donation_pass_flags_read_after_donate(kw):
    findings = _run(DonationPass, DONATING.format(kw=kw, after="return x"))
    assert len(findings) == 1
    f = findings[0]
    assert f.rule == "donation" and f.line == 8
    assert "use-after-donate" in f.message and "x was donated" in f.message


def test_donation_pass_undonated_group_is_clean():
    assert _run(DonationPass, DONATING.format(kw=", donate=False",
                                              after="return x")) == []


def test_donation_pass_non_literal_flag_is_out_of_scope():
    assert _run(DonationPass, DONATING.format(kw=", donate=flag",
                                              after="return x")) == []


def test_donation_pass_rebind_revives_operand():
    assert _run(DonationPass, DONATING.format(
        kw="", after="x = out\n        return x")) == []


def test_donation_pass_pragma_suppresses():
    assert _run(DonationPass, DONATING.format(
        kw="", after="return x  # lint: allow-donated-read(aliased on purpose)"
    )) == []


def test_donation_pass_tracks_pipeline_builds_and_self_attributes():
    findings = _run(DonationPass, """
        from repro_torch.core.fastpath import FastPathPipeline, fuse_stages

        class Node:
            def __init__(self, stages):
                self._fused = fuse_stages(stages)
                self._kept = FastPathPipeline(stages).build()
                self._run = FastPathPipeline(stages).build(donate_input=True)

            def tick(self):
                a = self._fused(self.buf.act)
                b = self._run(self.frame)
                return self.buf.act.shape, self.frame.sum()

            def safe(self, pipe, x):
                run = pipe.build(donate_input=False)
                y = run(x)
                return x
    """)
    assert [(f.line, f.message.split(" was ")[0]) for f in findings] == [
        (13, "self.buf.act"), (13, "self.frame")]


def test_recompile_pass_flags_scalar_literal_and_len_extras():
    findings = _run(DonationPass, """
        from repro_torch.core.fastpath import fuse_stages

        _fused = fuse_stages(STAGES, donate=False)

        def drive(x, rows, scale):
            a = _fused(x, 7)
            b = _fused(x, len(rows))
            c = _fused(x, scale)
            d = _fused(x, 0.5)  # lint: static-ok(constant per build)
            return a, b, c, d
    """)
    assert [(f.line, f.rule) for f in findings] == [(7, "recompile"),
                                                    (8, "recompile")]
    assert "literal 7" in findings[0].message
    assert "len(...)" in findings[1].message
    assert "new capture" in findings[0].message


# --------------------------------------------------------------------------
# The CLI and the port's tree
# --------------------------------------------------------------------------

def test_full_port_tree_is_clean():
    findings = lint_paths([str(PORT_SRC)])
    assert findings == [], "\n".join(f.render() for f in findings)


def test_port_tree_has_one_sync_site_and_every_pragma_a_reason():
    """Outside ``analysis/`` (whose docstrings show the grammar): one
    ``sync-site``, on ``ServeEngine._to_host``, and every pragma says why
    in a few words."""
    sites, reasons = [], []
    for path in sorted(PORT_SRC.rglob("*.py")):
        rel = path.relative_to(PORT_SRC).as_posix()
        if rel.startswith("analysis/"):
            continue
        src = SourceInfo.parse(str(path))
        sites += [(rel, p.line) for p in src.all_pragmas("sync-site")]
        for line in src.text.splitlines():
            if "# lint:" in line:
                why = line.split("# lint:", 1)[1].split("(", 1)[1]
                reasons.append((rel, re.findall(r"[A-Za-z]+", why)))
    assert sites == [("serving/engine.py", sites[0][1])], sites
    lines = (PORT_SRC / "serving/engine.py").read_text().splitlines()
    assert lines[sites[0][1] - 1].strip().startswith("def _to_host(")
    assert len(reasons) >= 7
    assert all(len(words) >= 3 for _, words in reasons), reasons


def test_cli_exits_zero_on_the_port():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          str(PORT_SRC)], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "cascade-lint: clean" in out.stderr


@pytest.mark.parametrize("rel,text,rule", [
    ("serving/scheduler.py",
     "\n\n# lint: sync-site(a second pull)\ndef _peek(t):\n"
     "    return t.cpu()\n", "second `sync-site` pragma"),
    ("kernels/ssd/ops.py",
     "\n\ndef _stray(t):\n    return t.sum().item()\n", ".item() forces"),
    ("core/fastpath.py",
     "\n\ndef _reuse(stages, x):\n    run = fuse_stages(stages)\n"
     "    y = run(x)\n    return x + y\n", "use-after-donate"),
])
def test_cli_exits_one_on_each_seeded_fault(tmp_path, capsys, rel, text,
                                            rule):
    root = tmp_path / "repro_torch"
    shutil.copytree(PORT_SRC, root,
                    ignore=shutil.ignore_patterns("__pycache__", "build"))
    assert main([str(root)]) == 0
    with open(root / rel, "a") as f:
        f.write(text)
    capsys.readouterr()
    assert main([str(root)]) == 1
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and rule in out[0] and rel in out[0], out
