"""Read a cell's correctness numbers for the program and for its control
over many seeds in one process, on the card:

    python3 cascade_bench/control.py --workload deepseek-moe-16b.chat \\
        --seconds 40 --seeds 11 12 13

For each seed, one run of the cell as the benchmark makes it (weights and
traffic from the seed, the window at the cell's own load), then the sample
of served requests through the float32 reference and through the control:
the same reference computed in float8 e4m3 (each product's weight with one
scale per output column, its input with one scale per row), the precision
below the configuration's bfloat16.  One JSON line a seed: the program's
numbers and the control's (``logit_gap_max``, ``logit_gap_mean``,
``mismatch_share``), and each side's ``correct`` and ``checks`` as the
harness's comparison gives them under the cell's own
``limits/<workload>.json``: the program's has to come out true and the
control's false.  Those limits are set from these readings (``PERF.md``
gives them).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parent.parent / "src"),
                str(Path(__file__).resolve().parent.parent)]

from cascade_bench import run, traffic  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--no-control", action="store_true",
                    help="read the program's numbers only")
    args = ap.parse_args(argv)
    spec = run.load_spec()
    cell, config = run.cell_of(spec, args.workload)
    mix = traffic.load_mix(cell["traffic"])
    wrong = 0
    for seed in args.seeds:
        out = run.run_cell(spec, cell, config, mix, seed, args.seconds,
                           False, "cuda", control=not args.no_control)
        out.pop("_run")
        line = {"seed": seed, "served": out["served"],
                "metrics": out["metrics"], "correct": out["correct"],
                "checks": out["checks"]}
        if "control" in out:
            line["control"] = out["control"]
            wrong += out["control"]["correct"]
        wrong += not out["correct"]
        print(json.dumps(line), flush=True)
    # 1 where a sound run failed its limits or a control passed them
    return int(wrong > 0)


if __name__ == "__main__":
    sys.exit(main())
