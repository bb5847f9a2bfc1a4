"""Spread of the end-to-end metrics over sets of runs, and the bound they suggest.

    python3 benchmark/tools/spread.py <set1.jsonl> <set2.jsonl> [...]

Each file holds the result lines (the last line of ``run.py``'s output) of one set of
runs of one cell. For each metric it prints each set's median and spread (the distance
between the first and third quartiles, as ``statistics.quantiles(values, n=4)`` gives
them, over the median) and the bound of about five times the widest spread (never under
1%). ``setup_s`` is also given with the first run of each set left out.
"""
from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from harness.common import quartile_spread  # noqa: E402


def main(paths) -> int:
    sets = []
    for p in paths:
        with open(p) as f:
            sets.append([json.loads(line) for line in f if line.strip()])
    names = sorted({m for s in sets for r in s for m in r["metrics"]})
    for name in names:
        widest = 0.0
        for p, runs in zip(paths, sets):
            values = [r["metrics"][name]["value"] for r in runs if name in r["metrics"]]
            if name == "setup_s":
                values = values[1:]
            if len(values) < 2:
                continue
            spread = quartile_spread(values)
            widest = max(widest, spread)
            print(f"{p}: {name} median {statistics.median(values)!r} spread {spread:.5f} "
                  f"n {len(values)} values {values}")
        print(f"{name}: widest spread {widest:.5f} -> bound {max(0.01, 5 * widest):.4f}")
    correct = [r["correct"] for s in sets for r in s]
    print(f"correct: {sum(correct)} of {len(correct)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
