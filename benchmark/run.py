"""Run one cell of the benchmark once, on the machine this runs on.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a configuration and a
traffic mix. Everything else is found by name: the configuration's file names the model
adapter (``models/<family>.py``), the mix (``traffic/<traffic>.json``) names the driver
of its kind (``kinds/<kind>.py``), and each per-layer metric is read by
``metrics/<metric>.py``. With ``--trace 0`` the result holds the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics. The last line of standard output is
one JSON object; the numbers the correctness check compared end standard error.

It measures ``pantomatrix_tpu_torch`` on CUDA cards and fails, printing no result, where
there are fewer cards than the cell asks for.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
for p in (str(BENCH_DIR), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

from harness import common  # noqa: E402


def cache_environment() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = common.CACHE_DIR
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def run_cell(cell: dict, seed: int, seconds: float, traced: bool, t_process: float,
             device: str = "cuda:0", program: str = "port") -> dict:
    """Drive one run of ``cell`` and return the result line's fields (without printing)."""
    import torch

    from harness import peaks, trace

    family = cell["config_file"]["family"]
    adapter_mod = common.load_module(BENCH_DIR / "models" / f"{family}.py", f"bench_model_{family}")
    kind = cell["mix"]["kind"]
    kind_mod = common.load_module(BENCH_DIR / "kinds" / f"{kind}.py", f"bench_kind_{kind}")
    adapter = adapter_mod.Adapter(cell["config_file"], cell["mix"], seed, device, program)
    res = kind_mod.run(adapter, seed, seconds, traced, t_process)
    checks = common.judge(res["checks"], cell["mix"].get("limits", {}))
    correct = all(c.get("ok", True) for c in checks.values())
    dev = torch.device(device)
    device_rec = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                  "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                  "count": int(cell["chips"]), "memory_peak_bytes": int(res["memory_peak_bytes"])}
    line = {"correct": correct, "attempted": res["attempted"], "failed": res["failed"]}
    metrics = {}
    if not traced:
        values = {"setup_s": res["setup_s"]}
        values.update(res.get("end_to_end", {}))
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        summary = trace.summarize(res["profile"])
        ctx = {"result": res, "summary": summary, "adapter": adapter, "cell": cell,
               "peaks": peaks, "precision": adapter.precision}
        for m in cell["per_layer"]:
            reader = common.load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                        "bench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_rec["busy_s"] = summary["busy_s"]
        device_rec["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["metrics"] = metrics
    line["device"] = device_rec
    return {"line": line, "checks": checks, "result": res}


def main(argv=None) -> int:
    t_process = common.process_start_time()
    t_main = time.time()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = common.find_cell(common.load_spec(), args.workload)
    cache_environment()
    import torch

    t_torch = time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s), found {found}",
              file=sys.stderr)
        return 3
    torch.cuda.init()
    print(f"benchmark: set-up {time.time() - t_process:.3f} s at the card (main from "
          f"{t_main - t_process:.3f} s, torch from {t_torch - t_process:.3f} s)",
          file=sys.stderr, flush=True)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_process)
    print(f"benchmark: card {common.card_line()}", file=sys.stderr, flush=True)
    loaded = common.forbidden_modules()
    if loaded:
        print(f"benchmark: forbidden modules loaded in this process: {loaded}", file=sys.stderr)
        return 4
    common.emit(out["line"], out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
