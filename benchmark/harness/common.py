"""What every cell shares: finding a cell's files by name, the process clock, the
device record, the isolation check and the one-line result."""
from __future__ import annotations

import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / ".cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "pantomatrix_tpu")


def process_start_time() -> float:
    """The wall-clock time at which this process started (Linux ``/proc``); the time of
    this call where that cannot be read."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find_cell(spec: dict, name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """The cell ``name`` with its configuration and traffic mix read from their files:
    ``configs/<config>.json`` (the file ``configs`` names) and ``traffic/<traffic>.json``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = dict(cells[name])
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cell["config_file"] = load_json(bench_dir.parent / config["file"])
    cell["mix"] = load_json(bench_dir / "traffic" / f"{cell['traffic']}.json")
    cell["end_to_end"] = [m for m in spec["end_to_end"]
                          if name in m.get("workloads", [name])]
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if name in m.get("workloads", _reports(spec, m["moves"], name))]
    return cell


def _reports(spec: dict, metric: str, cell: str):
    """Cells that report the end-to-end metric ``metric``."""
    m = next(e for e in spec["end_to_end"] if e["name"] == metric)
    return m.get("workloads", [cell])


def load_module(path: Path, name: str):
    """Import the file ``path`` as a module named ``name`` (metric readers and model
    adapters are found by file name, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> list:
    """Top-level names in ``sys.modules`` that the benchmark must not load, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True)
        return r.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def relative_error(a, b) -> float:
    """||a - b|| / ||b|| in float64."""
    a, b = a.double(), b.double()
    den = float(b.norm())
    return float((a - b).norm()) / max(den, 1e-300)


def quartile_spread(values) -> Optional[float]:
    """(Q3 - Q1) / median, as ``statistics.quantiles(values, n=4)`` gives the quartiles."""
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def judge(checks: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number compared beside its limit; a number without a limit is shown, not
    compared. A number that is not finite fails."""
    out = {}
    for name, value in checks.items():
        limit = limits.get(name)
        entry = {"value": value, "limit": limit}
        if limit is not None:
            entry["ok"] = bool(math.isfinite(value) and value <= limit)
        out[name] = entry
    for name in limits:
        if name not in checks:
            out[name] = {"value": None, "limit": limits[name], "ok": False}
    return out


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The numbers compared on standard error, last, then the result as the last line of
    standard output with the checks under the key that comes last."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} limit {c['limit']!r}"
              + ("" if "ok" not in c else (" ok" if c["ok"] else " FAILED")),
              file=sys.stderr, flush=True)
    line = dict(result)
    line["checks"] = {k: [c["value"], c["limit"]] for k, c in checks.items()}
    print(json.dumps(line), flush=True)
