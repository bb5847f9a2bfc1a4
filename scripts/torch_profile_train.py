"""Where the time goes in the PyTorch/CUDA port's train steps, on one NVIDIA GPU.

    python3 scripts/torch_profile_train.py [--steps 10] [--families camn,disco,emage]
        [--out outputs/torch_profile_train.json]

For each family at the full-width cell of ``chip_smoke.py`` phase 18c (CaMN and DisCo
at batch 64 x 128 frames, EMAGE at 56 x 64 frames with random tokenizers; random weights
and one fixed batch from seeds, Adam at the shipped learning rate) and each mode (fp32,
bf16) it runs 3 warm-up steps, then ``--steps`` timed steps (host clock, ending in
``torch.cuda.synchronize()``), then one step under ``torch.profiler``. It reports the
wall-time spread, the kernels launched a step, the device's busy and idle shares, device
time by kernel family, and the host and device time spent in the backward of the LSTM
layers (``LstmLayerFunctionBackward``: the layer recomputed through the plain
recurrence and differentiated). Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_profile_emage import REPO, busy_us, family

WARMUP = 3


def kernels_under(event):
    """The kernels launched under a CPU event, its children included."""
    yield from event.kernels
    for c in event.cpu_children:
        yield from kernels_under(c)


def profile_cell(name: str, compute_dtype, steps: int, card: str) -> dict:
    from chip_smoke import TRAIN_CELLS, train_batch, train_setup

    bs, frames, lr = TRAIN_CELLS[name]
    torch.cuda.reset_peak_memory_stats()
    model, opt, step = train_setup(name, "cuda", tiny=False, lr=lr, compute_dtype=compute_dtype)
    batch = train_batch(name, bs, frames, "cuda")

    def timed(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for i in range(WARMUP):
        timed(i)
    walls = [timed(WARMUP + i) for i in range(steps)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall_us = timed(WARMUP + steps) * 1e6
    events = prof.events()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    by_family = {}
    for e in kernels:
        f = family(e.name)
        by_family[f] = by_family.get(f, 0.0) + e.time_range.elapsed_us()
    kernel_sum = sum(by_family.values())
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
    lstm_bwd = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU
                and e.name.startswith("autograd::engine::evaluate_function")
                and e.name.endswith("LstmLayerFunctionBackward")]
    median = float(np.median(walls))
    cell = {
        "family": name, "mode": compute_dtype or "float32", "batch": bs,
        "model_frames": int(batch["motion"].shape[1]), "steps": steps,
        "wall_ms_median": 1e3 * median, "wall_ms_min": 1e3 * min(walls),
        "wall_ms_max": 1e3 * max(walls), "profiled_wall_ms": prof_wall_us / 1e3,
        "kernels_a_step": len(kernels), "device_ms": kernel_sum / 1e3,
        "device_idle_share": 1 - busy / prof_wall_us,
        # the profiler slows the host; without it the same kernels fill this share
        "device_idle_share_unprofiled": 1 - kernel_sum / 1e3 / (1e3 * median),
        "device_ms_by_family": {k: v / 1e3 for k, v in
                                sorted(by_family.items(), key=lambda kv: -kv[1])},
        "lstm_backward_layers": len(lstm_bwd),
        "lstm_backward_host_ms": sum(e.time_range.elapsed_us() for e in lstm_bwd) / 1e3,
        "lstm_backward_device_ms": sum(k.duration for e in lstm_bwd
                                       for k in kernels_under(e)) / 1e3,
        "lstm_backward_kernels": sum(1 for e in lstm_bwd for _ in kernels_under(e)),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card,
    }
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return cell


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--families", type=str, default="camn,disco,emage")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    out_path = args.out or str(REPO / "outputs" / "torch_profile_train.json")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import import_port, nvidia_smi_line

    import_port()
    card = nvidia_smi_line()
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "cells": []}
    for name in args.families.split(","):
        for mode in (None, "bfloat16"):
            cell = profile_cell(name, mode, args.steps, card)
            results["cells"].append(cell)
            print(json.dumps(cell), flush=True)
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
