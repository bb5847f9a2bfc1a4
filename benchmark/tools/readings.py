"""The readings that a cell's correctness limits are set from: the program over many
seeds, and the control (the reference computed in the next precision below the
configuration's, put in the program's place) over a few, in one process, at the cell's
own sizes, each with a short window.

    python3 benchmark/tools/readings.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 [--seconds 2] [--fault half_batch] [--out readings.jsonl]

Prints one JSON line a run: the program (``port`` or ``control``), the seed, every
number the check computes, and the run's seconds. Runs on a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH_DIR))
sys.path.insert(1, str(BENCH_DIR.parent))

import run  # noqa: E402
from harness import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--fault", default=None,
                    help="a fault of tools/faults.py planted under the program's runs")
    args = ap.parse_args(argv)
    run.cache_environment()
    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 3
    cell = common.find_cell(common.load_spec(), args.workload)
    if args.fault:
        from tools.faults import FAULTS, Patcher

        FAULTS[args.workload][args.fault](Patcher())
    plan = [("port", s) for s in args.seeds.split(",") if s] + \
           [("control", s) for s in args.control_seeds.split(",") if s]
    sink = open(args.out, "a") if args.out else None
    for program, seed in plan:
        t0 = time.time()
        c = dict(cell, mix=dict(cell["mix"], judge_one_of_first=1))
        # the control is slow and has nothing to tune: one call in its window
        out = run.run_cell(c, int(seed), 0.0 if program == "control" else args.seconds,
                           False, t0, program=program)
        rec = {"workload": args.workload, "program": program, "seed": int(seed),
               "fault": args.fault,
               "checks": {k: v["value"] for k, v in out["checks"].items()},
               "calls": out["result"]["calls"], "seconds": time.time() - t0,
               "metrics": out["line"]["metrics"]}
        print(json.dumps(rec), flush=True)
        if sink:
            sink.write(json.dumps(rec) + "\n")
            sink.flush()
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
