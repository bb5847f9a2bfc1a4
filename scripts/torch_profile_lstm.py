"""Where the time goes in the PyTorch/CUDA port's CaMN and DisCo inference, on one
NVIDIA GPU.

    python3 scripts/torch_profile_lstm.py [--reps 5] [--compute_dtype bfloat16]
        [--out outputs/torch_profile_lstm[_bfloat16].json]

For each model (full-width CamnAudioConfig() / DiscoAudioConfig(), random weights from a
seed) and each cell (batch x 28.4 s of 16 kHz audio, 421 frames at 15 fps), in the
serving mode given (``--compute_dtype``; the default is the float32 parity path), it
runs one warm-up call, then ``--reps`` timed calls (host clock, ending in
``torch.cuda.synchronize()``), then one call under ``torch.profiler``. It reports the
wall-time spread and real-time factor, the device's busy and idle shares, and device
time by kernel family (K2 apart), with K2's device time per launch. Imports nothing of
JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from torch_profile_emage import REPO, family, merge

CELLS = [8, 64]
SAMPLES, SECONDS = 454400, 28.4


def profile_cell(model, bs: int, reps: int, g: torch.Generator, compute_dtype=None) -> dict:
    audio = (torch.rand(bs, SAMPLES, generator=g) * 2 - 1).cuda()
    spk = torch.zeros((bs, 1), dtype=torch.long, device="cuda")

    def call():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model(audio, spk, compute_dtype=compute_dtype)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    call()  # warm-up (cuDNN algorithm choice, allocator)
    walls = [call() for _ in range(reps)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        prof_wall_us = call() * 1e6
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    k2 = [e.time_range.elapsed_us() for e in kernels if family(e.name) == "K2 lstm_sequence"]
    by_family = {}
    for e in kernels:
        f = family(e.name)
        by_family[f] = by_family.get(f, 0.0) + e.time_range.elapsed_us()
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = sum(end - start for start, end in merge(intervals))
    kernel_sum = sum(by_family.values())
    median = float(np.median(walls))
    return {
        "batch": bs, "seconds": SECONDS,
        "wall_s_median": median, "wall_s_min": float(min(walls)),
        "wall_s_max": float(max(walls)), "realtime_factor_median": bs * SECONDS / median,
        "profiled_wall_s": prof_wall_us / 1e6, "kernels_traced": len(kernels),
        "device_idle_share": 1 - busy / prof_wall_us,
        # the profiler slows the host; without it the same kernels fill this share
        "device_idle_share_unprofiled": 1 - kernel_sum / 1e6 / median,
        "device_ms_by_family": {k: v / 1e3 for k, v in
                                sorted(by_family.items(), key=lambda kv: -kv[1])},
        "share_of_kernel_time": {k: v / kernel_sum for k, v in by_family.items()},
        "k2_launches": len(k2), "k2_ms_per_launch": sum(k2) / len(k2) / 1e3 if k2 else None,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--compute_dtype", type=str, default=None, choices=["bfloat16", "float32"])
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    mode = f"_{args.compute_dtype}" if args.compute_dtype else ""
    out_path = args.out or str(REPO / "outputs" / f"torch_profile_lstm{mode}.json")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import nvidia_smi_line
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig

    card = nvidia_smi_line()
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "compute_dtype": args.compute_dtype, "cells": []}
    g = torch.Generator().manual_seed(1)
    for name, model in (("camn", CamnAudioModel(CamnAudioConfig(), seed=3)),
                        ("disco", DiscoAudioModel(DiscoAudioConfig(), seed=3))):
        for bs in CELLS:
            cell = {"model": name, "compute_dtype": args.compute_dtype,
                    **profile_cell(model, bs, args.reps, g, args.compute_dtype)}
            results["cells"].append(cell)
            print(json.dumps(cell), flush=True)
        del model
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
