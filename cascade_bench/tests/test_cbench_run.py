"""Whole runs of the harness on the CPU at the registry's SMOKE sizes: the
port served through the window, the served tokens held against the plain
reference, and each fault the serving cells can have breaking ``correct``.

At these sizes the port runs in float32 and serves the reference's own
greedy tokens, so every gap is 0 and the limits here are 1e-3; the card's
limits (``limits/<cell>.json``) are set from bfloat16 runs at full size.
"""
import ast
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cascade_bench import run

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "cascade_bench"
SEED = 2 ** 31 + 1234
LIMITS = {"logit_gap_max": {"limit": 1e-3}, "logit_gap_mean": {"limit": 1e-3}}
MIXES = {
    "open": {"loop": "open", "rate_per_s": 8.0,
             "prompt": {"dist": "lognormal", "median": 40, "sigma": 0.5,
                        "min": 8, "max": 120},
             "output": {"dist": "lognormal", "median": 24, "sigma": 0.5,
                        "min": 4, "max": 60}, "strata": 4},
    "closed": {"loop": "closed", "pool": 64,
               "prompt": {"dist": "uniform", "min": 60, "max": 120},
               "output": {"dist": "uniform", "min": 16, "max": 40},
               "strata": 4},
}
CASES = {"deepseek-moe-16b.chat": ("deepseek-moe-16b", "open"),
         "zamba2-2.7b.doc-qa": ("zamba2-2.7b", "closed"),
         "deepseek-moe-16b.doc-qa": ("deepseek-moe-16b", "closed")}


def tiny(name: str) -> dict:
    """The cell's configuration file with the registry's SMOKE model and a
    small engine (deepseek's capacity dropless: the reference is)."""
    from repro_torch.configs.registry import get_config
    conf = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    m = dataclasses.asdict(get_config(name, smoke=True))
    m.pop("notes")
    if m["family"] == "moe":
        m["capacity_factor"] = 8.0
    conf["model"] = m
    paged = conf["engine"]["paged"]
    conf["engine"] = {"paged": paged, "n_slots": 4, "max_len": 256}
    if paged:
        conf["engine"].update(token_budget=32, block_size=16, num_blocks=80)
    return conf


def cell_run(workload: str, *, traced=False, control=False, seconds=5.0):
    """One run of the cell at SMOKE size; the window is long enough that
    a busy CPU still finishes the 100 served tokens a check compares."""
    name, mix = CASES[workload]
    cell = {"name": workload, "config": name, "chips": 1}
    out = run.run_cell(run.load_spec(), cell, tiny(name), MIXES[mix], SEED,
                       seconds, traced, "cpu", limits=LIMITS,
                       control=control)
    out.pop("_run")
    return out


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("workload", sorted(CASES))
def test_a_sound_run_is_correct(workload):
    out = cell_run(workload)
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert out["served"]["program"]["logit_gap_max"] == 0.0
    spec = run.load_spec()
    want = {m["name"] for m in run.metrics_of(
        spec, {"name": workload}, False)}
    assert set(out["metrics"]) == want and "setup_s" in want


@pytest.mark.parametrize("workload", ["deepseek-moe-16b.chat",
                                      "zamba2-2.7b.doc-qa"])
def test_the_control_reads_wide_of_the_limit(workload):
    """The float8 control, in the program's place, through the harness's
    own ``checks`` and ``passed``: not correct, where the program is."""
    out = cell_run(workload, control=True)
    assert out["correct"], out["checks"]
    ctl = out["control"]
    assert ctl["correct"] is False, ctl["checks"]
    for name, lim in LIMITS.items():
        assert ctl["checks"][name] == {
            "value": out["served"]["control"][name], "limit": lim["limit"]}
        assert ctl["checks"][name]["value"] > lim["limit"]


@pytest.mark.parametrize("workload", sorted(CASES))
def test_each_cells_limits_pass_its_sound_runs_and_fail_its_control(
        workload):
    """The card's limits (``limits/<cell>.json``) through the harness's
    comparison: the largest reading of sound runs passes and the smallest
    reading of the float8 control fails, each as a whole result."""
    from cascade_bench import correct
    raw = json.loads((BENCH / "limits" / f"{workload}.json").read_text())
    limits = run.limits_of(workload)
    picks = [None] * correct.MIN_REQUESTS

    def verdict(which: str) -> bool:
        read = {name: raw[which]["reading"] for name in limits}
        read["compared_tokens"] = correct.MIN_TOKENS
        return correct.passed(correct.checks([], picks, read, limits))
    assert verdict("lower")
    assert not verdict("upper")
    for name, lim in limits.items():
        assert raw["lower"]["reading"] < lim["limit"] < raw["upper"]["reading"]


def _finished(index: int, served: int):
    from types import SimpleNamespace as NS
    item = NS(index=index, prompt=np.zeros(8, np.int32), max_new=served)
    return NS(done=True, error=None, item=item,
              req=NS(tokens=list(range(served))))


def test_the_sample_compares_several_requests():
    """A request long enough for every token compared still leaves room
    for others: at least ``MIN_REQUESTS`` distinct requests, the longest
    among them."""
    from cascade_bench import correct
    records = [_finished(i, 20) for i in range(10)] + [_finished(10, 1024)]
    for seed in (1, SEED):
        picks = correct.sample(records, seed)
        assert len(picks) == correct.MIN_REQUESTS
        assert len({r.item.index for r in picks}) == len(picks)
        assert picks[0].item.index == 10
    short = [_finished(i, 20) for i in range(30)]
    assert len(correct.sample(short, SEED)) == correct.MAX_REQUESTS
    assert len(correct.sample(short[:3], SEED)) == 3
    ch = correct.checks(short[:3], short[:3], {"compared_tokens": 400}, {})
    assert ch["compared_requests"] == {"value": 3, "limit": 4}
    assert not correct.passed(ch), ch


def test_a_traced_run_reads_the_per_layer_metrics():
    out = cell_run("deepseek-moe-16b.chat", traced=True)
    assert out["correct"], out["checks"]
    # the CPU has no device records: the device metrics are left out
    for name in ("queue_wait_p90_s.tpot", "ttft_p90_s.chat",
                 "tpot_p90_s.chat", "tick_period_ms.tpot", "mfu.tpot"):
        assert name in out["metrics"], name
    assert "k1_roofline.tpot" not in out["metrics"]
    assert "idle_share.tpot" not in out["metrics"]


def _alter_a_token(monkeypatch):
    from repro_torch.serving import engine as eng
    real = eng.ServeEngine._to_host
    calls = {"n": 0}

    def to_host(self, flat, layout):
        out = real(self, flat, layout)
        calls["n"] += 1
        if calls["n"] % 5 == 0:
            out[0][...] = (out[0] + 1) % self.cfg.vocab_size
        return out
    monkeypatch.setattr(eng.ServeEngine, "_to_host", to_host)


def _keep_state(monkeypatch):
    """Every step computes from the caches but keeps none of its writes."""
    from repro_torch.serving import engine as eng
    from repro_torch.tree import tree_map
    real_paged, real_decode = eng.paged_mixed_step, eng.decode_step

    def paged(params, pools, *a, **k):
        return real_paged(params, tree_map(torch.clone, pools), *a, **k)

    def decode(params, caches, *a, **k):
        return real_decode(params, tree_map(torch.clone, caches), *a, **k)
    monkeypatch.setattr(eng, "paged_mixed_step", paged)
    monkeypatch.setattr(eng, "decode_step", decode)


@pytest.mark.parametrize("fault", [_alter_a_token, _keep_state],
                         ids=["token_altered", "state_unchanged"])
@pytest.mark.parametrize("workload", ["deepseek-moe-16b.chat",
                                      "zamba2-2.7b.doc-qa"])
def test_a_fault_makes_the_run_incorrect(workload, fault, monkeypatch):
    fault(monkeypatch)
    out = cell_run(workload)
    assert not out["correct"], out["checks"]


def test_the_command_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "deepseek-moe-16b.chat", "--seed", "3",
                   "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for f in files:
        assert not _imports(f) & {"jax", "jaxlib", "flax", "repro"}, f
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(f), f


def test_a_run_leaves_the_jax_package_unloaded():
    """A whole run in a fresh process: once it ends, ``sys.modules`` holds
    none of the modules the command refuses to print a result with."""
    import subprocess
    code = (
        "import sys, json; sys.path[:0] = [%r, %r]\n"
        "from cascade_bench.tests import test_cbench_run as t\n"
        "out = t.cell_run('zamba2-2.7b.doc-qa')\n"
        "found = sorted({m.split('.')[0] for m in sys.modules}"
        " & set(t.run.FORBIDDEN))\n"
        "print(json.dumps([out['correct'], found]))\n"
        % (str(ROOT / "src"), str(ROOT)))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-2000:]
    assert json.loads(res.stdout.splitlines()[-1]) == [True, []]
