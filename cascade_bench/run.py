"""Run one cell of the benchmark once, on the card:

    python3 cascade_bench/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``configs/<name>.json``: the model, its engine, its plain reference) and a
traffic mix (``traffic/<mix>.json``).  Set-up makes the weights on the card
from the seed, builds the engine and warms up the cell's own shapes; the
window then drives the program for ``--seconds``; the reference then
checks what the program served.  The last line of standard output is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones, each
read by ``metrics/<name>.py``), ``device`` and, traced, ``breakdown``;
``checks`` (each number compared beside its limit) comes last, and the same
numbers end standard error.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every cache a run fills lives in the checkout, at a fixed path
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(HERE / ".cache" / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(spec: dict, workload: str) -> tuple[dict, dict]:
    """(the cell, its configuration's file) by the cell's name."""
    cells = {c["name"]: c for c in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    return cell, json.loads((ROOT / conf["file"]).read_text())


def metrics_of(spec: dict, cell: dict, traced: bool) -> list[dict]:
    key = "per_layer" if traced else "end_to_end"
    return [m for m in spec[key]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"cascade_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def limits_of(workload: str) -> dict:
    """The numbers the cell compares, each with its limit and the readings
    it was set from (``limits/<workload>.json``)."""
    path = HERE / "limits" / f"{workload}.json"
    return json.loads(path.read_text())["compared"]


def card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def run_cell(spec: dict, cell: dict, config: dict, mix: dict, seed: int,
             seconds: float, traced: bool, device: str = "cuda",
             t_start: float | None = None, limits: dict | None = None,
             chips: int = 1, control: bool = False) -> dict:
    """One run of ``cell``: set-up, the window, the metrics, the check.
    Returns the result object (``checks`` last).  ``control``: also read
    the float8 reference's gaps on the same sequences and hold them to the
    same limits (``out["control"]``, ``control.py``)."""
    import torch

    from . import correct, serve, traffic
    from . import trace as tracing
    from repro_torch import kernels
    from repro_torch.models.config import ModelConfig

    t_start = time.time() if t_start is None else t_start
    torch.set_num_threads(2)
    ref = correct.reference(config)
    model = config["model"]
    traffic.check_fits(mix, config["engine"]["max_len"])
    if device == "cuda":
        from repro_torch.kernels import build
        build.build()
    cfg = ModelConfig(**model)
    params = ref.make_params(model, seed, device)
    items = traffic.schedule(mix, seed, seconds, model["vocab_size"])
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    def once(attempt: int):
        run = serve.Run(cell, config, mix, seconds)
        engine = serve.build_engine(cfg, params, config["engine"], device)
        serve.warm_up(engine, mix, model["vocab_size"])
        sync()
        gc.collect()
        gc.freeze()
        spans = serve.Spans(run, traced)
        before = kernels.launch_counts()
        prof = None
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if device == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            prof.__enter__()
        run.setup_s = time.time() - t_start
        if traced:
            with torch.profiler.record_function("cbench.window"):
                serve.drive(engine, run, items, spans)
                sync()
        else:
            serve.drive(engine, run, items, spans)
            sync()
        gc.unfreeze()
        after = kernels.launch_counts()
        run.launches = {k: after[k] - before[k] for k in after}
        if prof is not None:
            prof.__exit__(None, None, None)
            run.trace = tracing.read(prof)
            del prof
            # the collector's passes onto the profiler's clock, by the
            # window's start on both
            off = run.trace.window[0] - run.start * 1e9
            run.trace.spans += [(n, a * 1e9 + off, b * 1e9 + off)
                                for n, a, b in run.spans
                                if n.startswith("gc")]
        del engine
        gc.collect()
        return run, run.launches, run.trace

    if traced:
        run, tr, short = tracing.retraced(once)
        run.trace_shortfall = short
    else:
        run = once(1)[0]
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    metrics = {}
    for m in metrics_of(spec, cell, traced):
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if device == "cuda":
        torch.cuda.empty_cache()
    from .reference.common import no_tf32
    no_tf32()
    picks = correct.sample(run.records, seed)
    t_ref = time.time()
    read = correct.readings(ref, params, model, picks, device, control)
    t_ref = time.time() - t_ref
    limits = limits_of(cell["name"]) if limits is None else limits
    checks = correct.checks(run.records, picks, read["program"], limits)
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                    else device),
           "count": chips, "memory_peak_bytes": int(peak)}
    out = {"correct": correct.passed(checks),
           "attempted": len(run.records),
           "failed": sum(1 for r in run.records if r.error),
           "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s()
        out["breakdown"] = run.trace.breakdown()
    out["served"] = dict(read, requests_compared=len(picks),
                         reference_s=t_ref, ticks=len(run.ticks),
                         trace_short=getattr(run, "trace_shortfall", None))
    if control:
        held = correct.checks(run.records, picks, read["control"], limits)
        out["control"] = {"correct": correct.passed(held), "checks": held}
    out["checks"] = checks
    out["_run"] = run
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = load_spec()
    cell, config = cell_of(spec, args.workload)
    from cascade_bench import traffic
    mix = traffic.load_mix(cell["traffic"])
    import torch
    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell["chips"]):
        print(f"cell {cell['name']} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    out = run_cell(spec, cell, config, mix, args.seed, args.seconds,
                   bool(args.trace), "cuda", globals()["T_START"],
                   chips=cell["chips"])
    out.pop("_run")
    found = sorted({m.split(".")[0] for m in sys.modules}
                   & set(FORBIDDEN))
    if found:
        print(f"modules that the benchmark must not load were loaded: "
              f"{found}", file=sys.stderr)
        return 4
    checks = out.pop("checks")
    out["card"] = card()
    out["checks"] = checks
    for name, c in checks.items():
        print(f"{name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    from cascade_bench import run as package_run
    package_run.T_START = T_START
    sys.exit(package_run.main())
