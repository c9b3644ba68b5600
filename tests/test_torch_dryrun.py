"""Port parity: the dry run (``repro_torch.launch.dryrun``) against the
JAX package's ``launch/dryrun.py``, on the CPU.

The reference dry run sets ``XLA_FLAGS`` to 512 host devices when it is
imported, which would change every later JAX test of the same worker, so
it runs only in one subprocess (``JAX_PLATFORMS=cpu``, its own timeout):
it writes the reference's ``input_specs`` of every cell, ``model_flops``
and ``active_param_count`` of every arch and shape, and ``run_cell(...,
calibrate=False)`` of six SMOKE-width cells, one per family, into
``tmp_path``.  The port's cells are traced here at the same widths, and
its per-device argument bytes must equal XLA's ``argument_size_in_bytes``
to the byte.  mamba2-1.3b SMOKE's ``in_proj`` (296 columns) does not
divide model 16, which XLA refuses as the port does, so that cell runs
both at d_model 128 (an override both dry runs take); zamba2's likewise;
gemma2-9b SMOKE's ring of 8 slots does not divide data 16 at batch 1
(``long_500k``: the sequence over 'data'), so that cell runs at window 16,
as does danube's prefill whose ``_rules`` override splits its caches'
sequence over 'data' (Stage 4's prefill).
The MoE configs' SMOKE widths hold 8 experts, which data 16 does not
divide, so their cells run at 32 (both dry runs put them over 'data').
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch.launch.dryrun as D
from repro_torch import kernels
from repro_torch.configs import registry as R
from repro_torch.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.ssd import ops as ssd_ops
from repro_torch.launch.mesh import logical_devices, make_production_mesh
from repro_torch.launch.mesh import _make_mesh
from repro_torch.tree import named_leaves, tree_leaves
import repro_torch.models as P

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# one per family: attention decode and train, sliding-window prefill, SSM
# at 500k, an embeds config's decode
CELLS = [("gemma2-9b", "decode_32k", {}), ("gemma2-9b", "train_4k", {}),
         ("h2o-danube-1.8b", "prefill_32k", {}),
         ("mamba2-1.3b", "long_500k", {"d_model": 128}),
         ("musicgen-large", "decode_32k", {}),
         ("zamba2-2.7b", "prefill_32k", {"d_model": 128}),
         ("gemma2-9b", "long_500k", {"window": 16}),
         ("deepseek-moe-16b", "decode_32k", {"n_experts": 32}),
         ("llama4-maverick-400b-a17b", "train_4k", {"n_experts": 32}),
         ("h2o-danube-1.8b", "prefill_32k",
          {"window": 16, "_rules": {"cache_seq": "data"}})]

_REF = r'''
import json, sys
import repro.launch.dryrun as dr
from repro.configs import registry as reg
out, cells = sys.argv[1], json.loads(sys.argv[2])
specs, flops, active = {}, {}, {}
for arch in reg.ARCH_IDS:
    cfg = reg.get_config(arch)
    active[arch] = cfg.active_param_count()
    for name, shape in reg.SHAPES.items():
        specs[f"{arch}@{name}"] = {k: [list(v.shape), str(v.dtype)] for k, v
                                   in dr.input_specs(arch, name).items()}
        flops[f"{arch}@{name}"] = dr.model_flops(cfg, shape)
dr.get_config = lambda a, smoke=False: reg.get_config(a, smoke=True)
mem = {}
for i, (arch, shape, ov) in enumerate(cells):
    r = dr.run_cell(arch, shape, multi_pod=False, out_dir=out,
                    overrides=ov or None, calibrate=False)
    mem[f"{arch}@{shape}@{i}"] = r["memory_analysis"]["argument_bytes"]
json.dump({"specs": specs, "flops": flops, "active": active, "mem": mem},
          open(out + "/ref.json", "w"))
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    subprocess.run([sys.executable, "-c", _REF, str(out), json.dumps(CELLS)],
                   check=True, env=env, timeout=300, cwd=ROOT)
    return out, json.loads((out / "ref.json").read_text())


def test_cells_and_shapes_equal_the_reference():
    from repro.configs import registry as J

    assert R.ARCH_IDS == J.ARCH_IDS
    assert R.SHAPES.keys() == J.SHAPES.keys()
    for k, s in R.SHAPES.items():
        j = J.SHAPES[k]
        assert (s.name, s.seq_len, s.global_batch, s.kind) == \
            (j.name, j.seq_len, j.global_batch, j.kind)
    assert R.LONG_CONTEXT_OK == J.LONG_CONTEXT_OK
    got = [(c.name, c.skipped, c.skip_reason) for c in R.all_cells()]
    want = [(c.name, c.skipped, c.skip_reason) for c in J.all_cells()]
    assert got == want and len(got) == 40


def test_specs_flops_and_active_params_equal_the_reference(reference):
    _, ref = reference
    for arch in R.ARCH_IDS:
        cfg = R.get_config(arch)
        assert cfg.active_param_count() == ref["active"][arch], arch
        for name, shape in R.SHAPES.items():
            key = f"{arch}@{name}"
            assert D.model_flops(cfg, shape) == ref["flops"][key], key
            specs = D.input_specs(arch, name)
            assert {k: [list(v.shape), str(v.dtype).removeprefix("torch.")]
                    for k, v in specs.items()} == ref["specs"][key], key
            assert all(v.device.type == "meta" for v in specs.values())


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("collective_bytes",
                                             "kernel_flops"):
            out |= _keys(v, prefix + k + "/")
    return out


def test_argument_bytes_keys_and_files_equal_xla(reference, tmp_path,
                                                 monkeypatch):
    """Per-device argument bytes equal XLA's ``argument_size_in_bytes``
    to the byte; the JSON has the reference's keys and file names."""
    ref_dir, ref = reference
    monkeypatch.setattr(D, "get_config",
                        lambda a, smoke=False: R.get_config(a, smoke=True))
    for i, (arch, shape, ov) in enumerate(CELLS):
        res = D.run_cell(arch, shape, multi_pod=False, out_dir=str(tmp_path),
                         overrides=ov or None, calibrate=False)
        assert res["memory_analysis"]["argument_bytes"] == \
            ref["mem"][f"{arch}@{shape}@{i}"], (arch, shape, ov)
    names = sorted(p.name for p in tmp_path.glob("*.json"))
    assert names == sorted(p.name for p in ref_dir.glob("*__*.json"))
    for name in names:
        mine = json.loads((tmp_path / name).read_text())
        theirs = json.loads((ref_dir / name).read_text())
        assert _keys(theirs) <= _keys(mine), name
        assert mine["collective_bytes"].keys() == \
            theirs["collective_bytes"].keys()
        assert mine["calibrated"] is False and mine["device"] == D.DEVICE


def test_per_device_flops_times_chips_equal_the_unsharded_program():
    """Where every split divides (danube SMOKE widened to 16 heads), the
    per-device FLOPs of a prefill over the 256 devices, times 256, are the
    one-device program's: nothing is computed twice or left out."""
    cfg = R.get_config("h2o-danube-1.8b", smoke=True).replace(
        n_heads=16, n_kv_heads=16)
    shape = R.SHAPES["prefill_32k"]
    with logical_devices(256, "meta"):
        mesh = make_production_mesh()
    with logical_devices(1, "meta"):
        one = _make_mesh((1, 1), ("data", "model"))
    sharded = D.trace(cfg, mesh, shape)
    whole = D.trace(cfg, one, shape)
    assert sharded["flops"] > 0
    assert sharded["flops"] * 256 == whole["flops"]
    assert sharded["counter"].kernel_flops["flash_attention"] * 256 == \
        whole["counter"].kernel_flops["flash_attention"]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b",
                                  "llama4-maverick-400b-a17b"])
def test_moe_per_device_flops_times_chips_count_the_router_per_shard(arch):
    """With the experts over 'data' (SMOKE widened to 16 heads and 32
    experts, so that every split divides), a prefill's per-device FLOPs
    over the 256 devices, times 256, are the one-device program's plus the
    router product once more per further 'model' shard: each of a row's
    16 shards routes the row's tokens, as XLA's program does; each device
    runs its experts over its share of every row's capacity slots."""
    from repro_torch.models import layer_specs

    cfg = R.get_config(arch, smoke=True).replace(n_heads=16, n_kv_heads=16,
                                                 n_experts=32)
    shape = R.SHAPES["prefill_32k"]
    with logical_devices(256, "meta"):
        mesh = make_production_mesh()
    with logical_devices(1, "meta"):
        one = _make_mesh((1, 1), ("data", "model"))
    sharded = D.trace(cfg, mesh, shape)
    whole = D.trace(cfg, one, shape)
    n_moe = sum(s.kind == "attn_moe" for s in layer_specs(cfg))
    tokens = shape.global_batch * shape.seq_len
    router = 2 * tokens * cfg.d_model * cfg.n_experts * n_moe
    assert sharded["flops"] > 0
    assert sharded["flops"] * 256 == whole["flops"] + 15 * router
    ledger = sharded["counter"].ledger.bytes
    assert ledger["all-to-all"] > 0


def _recorded(fn):
    seen = []
    with kernels.work_sink(lambda *a: seen.append(a)):
        fn()
    return seen


def test_kernel_meta_routes_count_what_the_bounds_count():
    """Each wrapper's meta route returns the output's shape and dtype and
    reports its kernel's count: the same function ``chip_smoke.py``'s
    bounds read, whose numbers are those of its formulas before they
    moved (written out here)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C

    meta = lambda *s, dt=torch.bfloat16: torch.empty(s, dtype=dt,
                                                     device="meta")
    # K2: gemma2's local layer shapes
    Bq, S, H, K, Dh, w = 2, 4096, 16, 8, 256, 4096
    out = []
    seen = _recorded(lambda: out.append(fa_ops.flash_attention(
        meta(Bq, S, H, Dh), meta(Bq, S, K, Dh), meta(Bq, S, K, Dh),
        window=w)))
    assert out[0].shape == (Bq, S, H, Dh) and out[0].device.type == "meta"
    pairs = w * (w + 1) // 2 + (S - w) * w
    want = ((2 * Bq * S * H * Dh + 2 * Bq * S * K * Dh) * 2,
            4 * Dh * H * Bq * pairs)
    assert seen == [("flash_attention", want[1], want[0])]
    assert C.flash_work(Bq, S, H, K, Dh, w, 2) == want
    # K3: mamba2's layer at S = 4500, h0 given, no D
    Bs, S, H, P, N, Q = 1, 4500, 64, 64, 128, 256
    f32 = torch.float32
    seen = _recorded(lambda: ssd_ops.ssd(
        meta(Bs, S, H, P), meta(Bs, S, H, dt=f32), meta(H, dt=f32),
        meta(Bs, S, N), meta(Bs, S, N), chunk=Q,
        h0=meta(Bs, H, P, N, dt=f32)))
    nbytes = (Bs * S * H * P * 6 + 2 * Bs * S * N * 2 + Bs * S * H * 4
              + H * 4 + Bs * H * P * N * 8)
    fl = 0
    for c0 in range(0, S, Q):
        L = min(Q, S - c0)
        pr = L * (L + 1) // 2
        fl += 2 * N * pr + H * (2 * P * pr + 4 * L * P * N)
    assert seen == [("ssd", Bs * fl, nbytes)]
    assert C.ssd_work(Bs, S, H, P, N, Q, 2, True, False) == (nbytes, Bs * fl)
    # K4: zamba2's shared attention over a full cache of 8192 slots
    Bd, S, H, K, Dh = 8, 8192, 32, 32, 160
    seen = _recorded(lambda: da_ops.decode_attention(
        meta(Bd, H, Dh), meta(Bd, S, K, Dh), meta(Bd, S, K, Dh),
        meta(Bd, dt=torch.int32), meta(Bd, S, dt=torch.int32)))
    n = Bd * S
    want = (n * K * 2 * Dh * 2 + Bd * S * 4 + 2 * Bd * H * Dh * 2 + Bd * 4,
            4 * Dh * H * n)
    assert seen == [("decode_attention", want[1], want[0])]
    pos = np.tile(np.arange(S, dtype=np.int32), (Bd, 1))
    assert C.decode_work(pos, np.full(Bd, S - 1), None, H, K, Dh, 2, 2,
                         False)[:2] == want
    # K1: one packed row per request, each token over its row's blocks
    T, H, K, Dh, bs, R_, nb = 6, 16, 8, 256, C.BS, 3, 4
    seen = _recorded(lambda: da_ops.ragged_paged_attention(
        meta(T, H, Dh), meta(64, bs, K, Dh), meta(64, bs, K, Dh),
        meta(R_, nb, dt=torch.int32), meta(T, dt=torch.int32),
        meta(T, dt=torch.int32)))
    bt = np.arange(R_ * nb).reshape(R_, nb)
    rows = np.arange(T) % R_
    tpos = np.full(T, nb * bs - 1)
    vis = T * nb * bs
    want = (R_ * nb * bs * K * 2 * Dh * 2 + 2 * T * H * Dh * 2
            + R_ * nb * 4 + 2 * T * 4, vis * H * 4 * Dh)
    assert seen == [("ragged_paged_attention", want[1], want[0])]
    assert C.work(bt, rows, tpos, None, 2, 2, False, H, K, Dh) == want


def test_uncovered_cells_raise_naming_their_stage(tmp_path, monkeypatch):
    """A cell that needs a stage the port has not reached raises, naming
    it; through the CLI it exits 3 and says so.  No registered cell does,
    and a ``_rules`` override that splits a prefill's caches over the
    sequence runs (Stage 4's prefill, the caches cut out of the rows' and
    sent to their owners: an all-to-all); what is left is Stage 3's
    divisibility: mamba2-1.3b with 512-wide SSM heads has 8 of them, which
    model 16 does not divide.  The prefill runs at SMOKE width (window 16,
    see the module note)."""
    seq = {"_rules": {"cache_seq": "data"}}
    with monkeypatch.context() as mp:
        mp.setattr(D, "get_config",
                   lambda a, smoke=False: R.get_config(a, smoke=True))
        res = D.run_cell("h2o-danube-1.8b", "prefill_32k", multi_pod=False,
                         out_dir=str(tmp_path / "prefill"),
                         overrides={"window": 16, **seq})
    assert res["collective_bytes"]["all-to-all"] > 0
    assert res["fits"]
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "mamba2-1.3b", "--shape", "decode_32k",
                        "--out", str(tmp_path), "--override",
                        "ssm_head_dim=512"],
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == D.UNCOVERED_EXIT, r.stderr[-2000:]
    assert "UNCOVERED" in r.stdout and "Stage 3" in r.stdout
    assert not list(tmp_path.glob("*.json"))


def _placed_bytes(prog, cfg, shape) -> list[int]:
    """Each device's bytes of the cell's arguments as the program places
    them (params, and the optimizer state or the caches, and the batch),
    counted from the placements alone."""
    from repro_torch.core.sharded import ShardedTensor
    from repro_torch.models import init_decode_caches, init_params
    from repro_torch.training.optimizer import get_optimizer
    from repro_torch.tree import named_leaves, tree_leaves

    params = prog.place_params(init_params(cfg, device="meta"))
    batch = prog.place_batch(D.input_specs(cfg.name, shape.name, cfg=cfg,
                                           shape=shape))
    if shape.kind == "train":
        rest = prog.init_state(get_optimizer(cfg.optimizer), params)
    else:
        rest = (params, prog.place_caches(init_decode_caches(
            cfg, shape.global_batch, shape.seq_len, device="meta")))
    out = [0] * prog.mesh.size
    for leaf in tree_leaves((rest, batch)):
        if isinstance(leaf, ShardedTensor):
            for i, t in enumerate(leaf.shards):
                out[i] += t.numel() * t.element_size()
    return out


@pytest.mark.parametrize("arch,shape,rules,multi_pod", [
    ("h2o-danube-1.8b", "train_4k", {"embed": "data"}, False),
    ("h2o-danube-1.8b", "decode_32k", {"cache_seq": "data"}, False),
    ("h2o-danube-1.8b", "decode_32k", {"cache_seq": "data"}, True)])
def test_the_last_layouts_of_the_rules_run_and_place_what_they_trace(
        arch, shape, rules, multi_pod):
    """The reference dry run's own ``_rules`` overrides run: params over
    'data' (``embed``, the fsdp rules) in the train step, and decode
    caches whose sequence lies over 'data' at decode_32k's batch, whose
    batch the rules split too (over 'pod' on the multi-pod mesh, nowhere
    on one pod).  Each device's argument bytes in the trace are the bytes
    the program places for it; fsdp's are below the default cell's, its
    temp above it by at most one layer's gathered weights.  SMOKE width;
    the decode cells at window 16 (see the module note)."""
    cfg = R.get_config(arch, smoke=True)
    if shape == "decode_32k":
        cfg = cfg.replace(window=16)
    cell = R.SHAPES[shape]
    with logical_devices(512 if multi_pod else 256, "meta"):
        mesh = make_production_mesh(multi_pod=multi_pod)
    base = D.make_rules(cfg, mesh, batch=cell.global_batch)
    got = D.trace(cfg, mesh, cell, rules={**base, **rules})
    assert got["args"] == _placed_bytes(got["prog"], cfg, cell)
    assert D.HBM_BYTES > max(got["args"]) > 0
    if "cache_seq" in rules:
        assert got["prog"].seq_groups
        assert len(got["prog"].seq_groups) == (2 if multi_pod else 1)
        return
    assert got["prog"].gathered
    default = D.trace(cfg, mesh, cell)
    assert max(got["args"]) < max(default["args"])
    prog = got["prog"]
    layer = sum(leaf.shards[0].numel() * leaf.shards[0].element_size()
                * len(prog.gathered[f"layers/0/{n}"].peers[0][1])
                for n, leaf in named_leaves(prog.place_params(P.init_params(
                    cfg, device="meta"))["layers"][0])
                if f"layers/0/{n}" in prog.gathered)
    assert 0 < got["peak_bytes"] - default["peak_bytes"] <= layer
    assert got["counter"].ledger.bytes["reduce-scatter"] > 0


def test_the_cli_writes_a_full_width_cell(tmp_path):
    """``python -m repro_torch.launch.dryrun --arch gemma2-9b --shape
    decode_32k`` runs with no card and writes the reference's keys, its
    argument bytes fitting 80 GB."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "gemma2-9b", "--shape", "decode_32k",
                        "--out", str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().startswith("gemma2-9b@decode_32k mp=False")
    res = json.loads((tmp_path / "gemma2-9b__decode_32k.json").read_text())
    assert {"memory_analysis", "cost_analysis", "collective_bytes",
            "roofline"} <= res.keys()
    assert res["roofline"]["dominant"] in ("compute_s", "memory_s",
                                           "collective_s")
    assert 0 < res["memory_analysis"]["argument_bytes"] < D.HBM_BYTES
    assert res["chips"] == 256


def test_the_cli_writes_a_full_width_moe_cell(tmp_path):
    """deepseek-moe-16b's decode_32k at full width puts its 64 experts
    over data 16 (4 a row) and writes its cell, the all-to-alls of the
    dispatch in its collective bytes."""
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "deepseek-moe-16b", "--shape",
                        "decode_32k", "--out", str(tmp_path)],
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert r.returncode == 0, r.stderr[-2000:]
    res = json.loads((tmp_path / "deepseek-moe-16b__decode_32k.json")
                     .read_text())
    assert res["collective_bytes"]["all-to-all"] > 0
    assert 0 < res["memory_analysis"]["argument_bytes"] < D.HBM_BYTES
    assert res["fits"] and res["chips"] == 256
