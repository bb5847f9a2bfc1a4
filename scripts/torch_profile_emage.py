"""Where the time goes in the PyTorch/CUDA port's EMAGE main path, on one NVIDIA GPU.

    python3 scripts/torch_profile_emage.py [--reps 5] [--out outputs/torch_profile_emage.json]

For each cell (batch x seconds of 16 kHz audio; full-width EmageAudioConfig() and the
reference tokenizer widths, random weights from a seed) it runs one warm-up call, then
``--reps`` timed calls (host clock around inference + final decode, ending in
``torch.cuda.synchronize()``), then one call under ``torch.profiler``. It reports the
wall-time spread, the split between the AR inference loop and the final decode, the
device's busy and idle shares (union of kernel intervals over the profiled call's wall
time, and kernel time over the unprofiled median wall time), and device time by kernel
family. Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
CELLS = [(8, 20), (128, 60)]


def family(name: str) -> str:
    """Kernel family by name (heuristic: cuDNN and cuBLAS kernel names vary by version)."""
    n = name.lower()
    if "vq_nearest_code" in n:
        return "K1 vq_nearest_code"
    if any(s in n for s in ("conv", "cudnn", "fprop", "winograd", "implicit", "precomputed")):
        return "conv (cuDNN)"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "cublas", "matmul", "dot_kernel")):
        return "gemm (cuBLAS)"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n:
        return "layer_norm"
    if "cat" in n or "copy" in n or "index" in n or "gather" in n or "scatter" in n:
        return "copy / cat / index"
    return "elementwise / reduce / other"


def busy_us(intervals):
    """Length of the union of [start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", type=str, default=str(REPO / "outputs" / "torch_profile_emage.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    sys.path.insert(0, str(REPO))
    from pantomatrix_tpu_torch.cli.test_emage import load_models
    from pantomatrix_tpu_torch.models.emage import _select_decode_inputs

    model, vq = load_models(None, True, "cuda")
    cfg = model.config
    g = torch.Generator().manual_seed(1)
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda, "cells": []}

    for bs, seconds in CELLS:
        audio = (torch.rand(bs, seconds * 16000, generator=g) - 0.5).cuda()
        spk = torch.zeros((bs, 1), dtype=torch.long, device="cuda")
        zero_trans = torch.zeros(1, 3, device="cuda")

        def call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.inference(audio, spk, vq)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            vq.decode(**_select_decode_inputs(cfg, out), get_global_motion=True,
                      ref_trans=zero_trans)
            torch.cuda.synchronize()
            return t1 - t0, time.perf_counter() - t1

        call()  # warm-up (cuDNN algorithm choice, allocator)
        walls = [call() for _ in range(args.reps)]
        total = [a + b for a, b in walls]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            call()
            prof_wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA]
        by_family = {}
        for e in kernels:
            f = family(e.name)
            by_family[f] = by_family.get(f, 0.0) + e.time_range.elapsed_us()
        busy = busy_us([(e.time_range.start, e.time_range.end) for e in kernels])
        kernel_sum = sum(by_family.values())
        cell = {
            "batch": bs, "seconds": seconds,
            "wall_s_median": float(np.median(total)), "wall_s_min": float(min(total)),
            "wall_s_max": float(max(total)),
            "realtime_factor_median": bs * seconds / float(np.median(total)),
            "inference_s_median": float(np.median([a for a, _ in walls])),
            "final_decode_s_median": float(np.median([b for _, b in walls])),
            "profiled_wall_s": prof_wall_us / 1e6,
            "kernels_traced": len(kernels),
            "device_busy_share": busy / prof_wall_us if kernels else None,
            "device_idle_share": 1 - busy / prof_wall_us if kernels else None,
            # the profiler slows the host; without it the same kernels fill this share
            "device_busy_share_unprofiled": (kernel_sum / 1e6 / float(np.median(total))
                                             if kernels else None),
            "device_ms_by_family": {k: v / 1e3 for k, v in
                                    sorted(by_family.items(), key=lambda kv: -kv[1])},
            "share_of_kernel_time": {k: v / kernel_sum for k, v in by_family.items()}
            if kernel_sum else {},
            "top_kernels_ms": [
                (e.key[:100], e.self_device_time_total / 1e3)
                for e in sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:12]
            ],
        }
        results["cells"].append(cell)
        print(json.dumps(cell), flush=True)
        del audio

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
