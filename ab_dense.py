"""Card probe: the port's unsharded dense paths from two checkouts, side by
side.

Each tree is a checkout's root; its own ``src`` and ``chip_smoke.py`` run in
a subprocess of their own, so two versions of the port never share a
process.  Two comparisons:

``ops``: ``forward`` (score), ``forward`` in train mode with
its backward, ``prefill`` and ``DECODE_STEPS`` ``decode_step``s of each of
``OPS_CASES`` (full width, cut to a few layers, seeded weights and
tokens) under a ``TorchDispatchMode`` that counts the aten ops dispatched.
Each entry point's op counts and a SHA-256 of every output's bytes (logits,
the loss, every gradient, the caches) are compared across the trees:
equal counts, bit-equal outputs.

Then the eager ``decode_step`` of ``TIMED`` at full depth (B 8 after a
128-token prefill): the median of ``TIMED_STEPS`` steps, each timed on the
host clock around a synchronized step, and a few more steps under
``torch.profiler`` (``_profiled``: the device's kernel time against the
host's time in aten ops and in Python).

``phases``: ``chip_smoke``'s ``serve_dense`` and ``train`` phases: the
captured and eager TPOT p50 of mamba2-1.3b and zamba2-2.7b and the train
step's p50.

Both run once per letter of ``--order`` (A the first ``--tree``, B the
second; ABBA puts each tree first once), one subprocess each; the op
counts and digests of each tree's first run are compared.

Run on a card from the repository root, with the other tree unpacked
under a git-ignored directory (``git archive <commit> | tar -x -C
.scratch/parent``)::

    python3 ab_dense.py --tree .scratch/parent --tree . --order ABBA

Every JSON line also goes to ``chiprun_out/ab_dense.jsonl``.
"""
import argparse
import hashlib
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

# (arch, n_layers): every dense block kind at full width
OPS_CASES = (("gemma2-9b", 2), ("h2o-danube-1.8b", 2), ("mamba2-1.3b", 2),
             ("zamba2-2.7b", 6), ("musicgen-large", 2),
             ("deepseek-moe-16b", 2))
B, S, MAX_LEN, DECODE_STEPS = 2, 256, 320, 4
TIMED, TIMED_STEPS = ("mamba2-1.3b", "zamba2-2.7b"), 30
OUT = Path("chiprun_out") / "ab_dense.jsonl"


def emit(obj: dict) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    OUT.parent.mkdir(exist_ok=True)
    with OUT.open("a") as f:
        f.write(line + "\n")


# ================================================================ workers
def _setup(tree: Path):
    """The tree's package and script first on the path; the kernels built
    from its sources; the card as ``chip_smoke.main`` sets it."""
    sys.path.insert(0, str(tree / "src"))
    sys.path.insert(0, str(tree))
    import torch

    from repro_torch.kernels import build

    build.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _digest(t) -> str:
    import torch

    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return hashlib.sha256(t.numpy().tobytes()).hexdigest()[:16]


def ops_worker(tree: Path) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    dev = _setup(tree)
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.models import decode_step, forward, prefill
    from repro_torch.tree import named_leaves, tree_leaves, tree_map

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    out = {}
    for arch, n_layers in OPS_CASES:
        cfg = get_config(arch).replace(n_layers=n_layers)
        params = cs._seeded_params(cfg, dev, 0)
        g = torch.Generator(device=dev).manual_seed(1)
        if cfg.input_mode == "embeds":
            toks = torch.randn((B, S + DECODE_STEPS, cfg.d_model),
                               generator=g, device=dev)
        else:
            toks = torch.randint(0, cfg.vocab_size, (B, S + DECODE_STEPS),
                                 generator=g, device=dev, dtype=torch.int32)
        pos = torch.arange(S + DECODE_STEPS, dtype=torch.int32,
                           device=dev)[None].repeat(B, 1)
        res = {}

        def run(name, fn):
            mode = Count()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            with mode:
                outs = fn()
            torch.cuda.synchronize()
            res[name] = {"ops": sum(mode.ops.values()),
                         "by_op": dict(mode.ops),
                         "digests": [_digest(t) for t in tree_leaves(outs)
                                     if isinstance(t, torch.Tensor)],
                         "seconds_counted": time.monotonic() - t0}

        with torch.no_grad():
            run("forward", lambda: forward(params, toks[:, :S], pos[:, :S],
                                           cfg))

        def train():
            views = tree_map(lambda t: t.detach().requires_grad_(), params)
            with torch.enable_grad():
                logits, aux = forward(views, toks[:, :S], pos[:, :S], cfg,
                                      mode="train")
                loss = torch.logsumexp(logits.float(), dim=-1).mean() + aux
                grads = torch.autograd.grad(
                    loss, [t for _, t in named_leaves(views)],
                    materialize_grads=True)
            return [loss.detach()] + list(grads)

        run("train", train)
        with torch.no_grad():
            state = {}

            def pre():
                state["caches"] = prefill(params, toks[:, :S], pos[:, :S],
                                          cfg, max_len=MAX_LEN)[1]
                return state["caches"]

            run("prefill", pre)

            def dec():
                outs = []
                for i in range(S, S + DECODE_STEPS):
                    x = toks[:, i:i + 1] if cfg.input_mode == "embeds" \
                        else toks[:, i]
                    outs.append(decode_step(params, state["caches"], x,
                                            pos[:, i:i + 1], cfg)[0])
                return outs + [state["caches"]]

            run("decode_step", dec)
        out[arch] = res
        del params, state
        torch.cuda.empty_cache()
    timing = {}
    for arch in TIMED:
        cfg = get_config(arch)
        params = cs._seeded_params(cfg, dev, 0)
        toks = torch.randint(0, cfg.vocab_size, (8, 128), device=dev,
                             dtype=torch.int32)
        pos = torch.arange(128, dtype=torch.int32, device=dev)[None].repeat(
            8, 1)
        with torch.no_grad():
            caches = prefill(params, toks, pos, cfg, max_len=256)[1]
            ms = []
            for i in range(TIMED_STEPS):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                decode_step(params, caches, toks[:, i], pos[:, i:i + 1] + 128,
                            cfg)
                torch.cuda.synchronize()
                ms.append((time.monotonic() - t0) * 1e3)
            timing[arch] = {"median_ms": sorted(ms)[len(ms) // 2],
                            **_profiled(lambda: decode_step(
                                params, caches, toks[:, 0],
                                pos[:, :1] + 128, cfg))}
        del params, caches
        torch.cuda.empty_cache()
    return {"cases": out, "decode_step_ms": timing}


def _profiled(step, n: int = 5) -> dict:
    """``n`` steps under ``torch.profiler``, per step: the wall ms, the
    device's kernel ms and kernel count, and the host's self ms in aten
    ops (the rest of the wall on the host is Python)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    aten = sum(e.self_cpu_time_total for e in events
               if e.device_type == DeviceType.CPU
               and e.name.startswith("aten::"))
    return {"profiled_wall_ms": wall * 1e3 / n,
            "kernel_ms": sum(e.self_device_time_total for e in kernels)
            / 1e3 / n, "kernels": len(kernels) / n,
            "aten_self_cpu_ms": aten / 1e3 / n}


def phases_worker(tree: Path) -> dict:
    dev = _setup(tree)
    import chip_smoke as cs

    smi = cs.nvidia_smi()
    t0 = time.monotonic()
    cs.serve_dense_phase(dev, smi)
    cs.train_phase(dev, smi)
    return {"seconds": time.monotonic() - t0}


# ============================================================= comparison
def spawn(kind: str, tree: Path) -> tuple[dict, list]:
    """A worker over ``tree``: (its result, the JSON lines it printed)."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--worker", kind,
         "--tree", str(tree.resolve())], capture_output=True, text=True,
        cwd=tree, timeout=1500)
    lines = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            try:
                lines.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-8000:])
        raise SystemExit(f"{kind} worker over {tree} exited "
                         f"{proc.returncode}")
    result = next(o["result"] for o in reversed(lines) if "result" in o)
    return result, lines


def phase_readings(lines: list) -> dict:
    out = {}
    for o in lines:
        if o.get("phase") == "serve_dense" and "tpot_p50_s" in o:
            key = f'{o["arch"]} {"captured" if o["cuda_graphs"] else "eager"}'
            out.setdefault(key, o["tpot_p50_s"])
        elif o.get("phase") == "train":
            out["train_step_p50_s"] = o["step_p50_s"]
            out["train_losses"] = o["losses"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True)
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--worker", choices=("ops", "phases"))
    args = ap.parse_args()
    if args.worker:
        fn = ops_worker if args.worker == "ops" else phases_worker
        print(json.dumps({"result": fn(Path(args.tree[0]))}), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("ab_dense: no CUDA device; this probe runs on the card",
              file=sys.stderr)
        return 2
    trees = [Path(t) for t in args.tree]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    ops: dict = {}
    for i, letter in enumerate(args.order):
        tree = trees["AB".index(letter)]
        got = spawn("ops", tree)[0]
        ops.setdefault(str(tree), got["cases"])
        emit({"probe": "decode_step_ms", "card": smi, "run": i,
              "tree": str(tree), "letter": letter, **got["decode_step_ms"]})
    ref = ops[str(trees[0])]
    for t in trees[1:]:
        for arch, entries in ops[str(t)].items():
            for name, got in entries.items():
                want = ref[arch][name]
                diff = {k: (want["by_op"].get(k, 0), n) for k, n in
                        got["by_op"].items() if want["by_op"].get(k, 0) != n}
                diff.update({k: (n, 0) for k, n in want["by_op"].items()
                             if k not in got["by_op"]})
                emit({"probe": "ops", "card": smi, "arch": arch,
                      "entry": name, "tree": str(t),
                      "ops": [want["ops"], got["ops"]], "op_diff": diff,
                      "bit_equal": want["digests"] == got["digests"],
                      "outputs": len(got["digests"])})
    for i, letter in enumerate(args.order):
        tree = trees["AB".index(letter)]
        t0 = time.monotonic()
        _, lines = spawn("phases", tree)
        emit({"probe": "phases", "card": smi, "run": i, "tree": str(tree),
              "letter": letter, "seconds": time.monotonic() - t0,
              **phase_readings(lines)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
