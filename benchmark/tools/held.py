"""Cells held back from ``BENCHMARK.json``: ``held/<cell>.json`` holds the entries (the
workload, and the metrics that list it alone) that adding the cell would add, ready to
be copied in. ``with_held`` gives the spec with them, for the tests and the readings.

    python3 benchmark/tools/held.py <out.json>

writes ``BENCHMARK.json`` with every held cell added, to run one with ``run.py`` from a
copy of the checkout.
"""
import json
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]


def with_held(spec: dict) -> dict:
    """``spec`` with the entries of every held cell that it does not name yet."""
    out = {k: list(v) if isinstance(v, list) else v for k, v in spec.items()}
    for path in sorted((BENCH_DIR / "held").glob("*.json")):
        held = json.loads(path.read_text())
        for key, entries in held.items():
            names = {e["name"] for e in out[key]}
            out[key] += [e for e in entries if e["name"] not in names]
    return out


if __name__ == "__main__":
    spec = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    Path(sys.argv[1]).write_text(json.dumps(with_held(spec), indent=1) + "\n")
