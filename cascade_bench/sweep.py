"""Find the knee of an open-loop cell once, on the card: the highest of a
few fixed rates whose backlog does not grow over the window.

    python3 cascade_bench/sweep.py --workload deepseek-moe-16b.chat \\
        --seconds 30 --rates 6 8 10 12 14

One process, one set of weights (``--seed``); for each rate a fresh engine
is warmed up, then driven for ``--seconds`` by the cell's mix at that rate.
Each rate prints one JSON line: requests due, finished, still waiting for
a slot at the window's end and at its middle, tokens served per second, and
the p90 of TTFT and TPOT.  The backlog grows where the requests waiting at
the end exceed those waiting at the middle by more than one rate-second.
The chosen rate is written by hand into the mix's file
(``traffic/<mix>.json``'s ``rate_per_s``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from cascade_bench import correct, readers, run, serve, traffic  # noqa: E402


def waiting_at(rec_list, t: float, ticks) -> int:
    """Requests due by ``t`` that held no slot by ``t``."""
    n = 0
    for r in rec_list:
        if r.due > t:
            continue
        if r.issued_tick is None or ticks[r.issued_tick][1] > t:
            n += 1
    return n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    from repro_torch.models.config import ModelConfig
    spec = run.load_spec()
    cell, config = run.cell_of(spec, args.workload)
    mix = traffic.load_mix(cell["traffic"])
    if mix["loop"] != "open":
        raise SystemExit("the sweep is for open-loop cells")
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build()
    ref = correct.reference(config)
    model = config["model"]
    params = ref.make_params(model, args.seed, args.device)
    cfg = ModelConfig(**model)
    for rate in args.rates:
        m = dict(mix, rate_per_s=rate)
        items = traffic.schedule(m, args.seed, args.seconds,
                                 model["vocab_size"])
        engine = serve.build_engine(cfg, params, config["engine"],
                                    args.device)
        serve.warm_up(engine, m, model["vocab_size"])
        rn = serve.Run(cell, config, m, args.seconds)
        serve.drive(engine, rn, items, serve.Spans(rn, False))
        mid = rn.start + args.seconds / 2
        line = {"rate_per_s": rate, "due": len(rn.records),
                "finished": sum(r.done for r in rn.records),
                "waiting_end": waiting_at(rn.records, rn.end, rn.ticks),
                "waiting_mid": waiting_at(rn.records, mid, rn.ticks),
                "tokens_per_s": sum(len(r.token_ticks) for r in rn.records)
                / (rn.end - rn.start),
                "ttft_p90_s": readers.p90(readers.ttfts(rn)),
                "tpot_p90_s": readers.p90(readers.tpots(rn)),
                "ticks": len(rn.ticks)}
        line["grows"] = line["waiting_end"] - line["waiting_mid"] > rate
        print(json.dumps(line), flush=True)
        del engine
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
