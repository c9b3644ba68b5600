"""Card probe: how many device records torch.profiler keeps of the main
serve run, session after session in one process.

Each session replays ``chip_smoke.trace_phase``'s run (gemma2-9b at full
width, seeded weights, captured ticks) under the profiler, opened by 256
marker kernels (``torch.cuda._sleep``) after a synchronize.  Per session it
prints K1's launches by its wrapper's count, K1's combine records, the
markers kept and every device record kept: the sessions run the same work,
so a session that kept fewer records than the others lost them, and the
markers tell a loss at the window's start from one inside the run.

Run on a card from the repository root::

    python3 trace_records.py [--sessions 12]
"""
import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

MARKERS = 256


def session(i, cfg, params, dev) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.decode_attention import ops
    from repro_torch.serving.engine import ServeEngine

    eng = ServeEngine(cfg, params, n_slots=8, token_budget=512, max_len=8192,
                      num_blocks=1024, device=dev, cuda_graphs=True)
    for r in cs.serve_requests(cfg.vocab_size):
        eng.submit(r)
    ops.ragged_paged_attention.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        eng.run_until_drained()
        torch.cuda.synchronize()
    kernels = cs.device_kernels(prof)
    res = {"session": i, "k1_launches": ops.ragged_paged_attention.launches,
           "k1_records": cs.kernel_launches(prof, ("ragged_combine_kernel",)),
           "markers_kept": cs.kernel_launches(prof, ("spin_kernel",)),
           "device_records": sum(n for n, _ in kernels.values())}
    del eng, prof
    torch.cuda.empty_cache()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("trace_records.py needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi(), flush=True)
    cs.emit({"phase": "env", "torch": torch.__version__,
             "build_s": build.build()})
    cfg = get_config("gemma2-9b")
    params = cs._seeded_params(cfg, dev, 0)
    t0 = time.monotonic()
    runs = [session(i, cfg, params, dev) for i in range(args.sessions)]
    for r in runs:
        cs.emit(r)
    most = max(r["device_records"] for r in runs)
    cs.emit({"sessions": len(runs), "seconds": time.monotonic() - t0,
             "most_device_records": most,
             "sessions_short": sum(r["device_records"] < most for r in runs),
             "markers_lost": [MARKERS - r["markers_kept"] for r in runs],
             "k1_records_lost": [r["k1_launches"] - r["k1_records"]
                                 for r in runs]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
