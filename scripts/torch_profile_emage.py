"""Where the time goes in the PyTorch/CUDA port's EMAGE main path, on one NVIDIA GPU.

    python3 scripts/torch_profile_emage.py [--reps 5] [--compute_dtype bfloat16]
        [--batched_wav] [--out outputs/torch_profile_emage[_bfloat16][_batched_wav].json]

For each cell (batch x seconds of 16 kHz audio; full-width EmageAudioConfig() and the
reference tokenizer widths, random weights from a seed) in the serving mode given
(``--compute_dtype``, ``--batched_wav``; the default is the float32 parity path) it runs
one warm-up call, then
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
sys.path.insert(0, str(REPO / "benchmark"))
from harness.trace import merge  # noqa: E402  (the union of kernel intervals)

CELLS = [(8, 20), (128, 60)]


def family(name: str) -> str:
    """Kernel family by name (heuristic: cuDNN and cuBLAS kernel names vary by version)."""
    n = name.lower()
    if "vq_nearest_code" in n:
        return "K1 vq_nearest_code"
    if "lstm_layer_kernel" in n:
        return "K2 lstm_sequence"
    if any(s in n for s in ("conv", "cudnn", "fprop", "winograd", "implicit", "precomputed")):
        return "conv (cuDNN)"
    if any(s in n for s in ("gemm", "gemv", "cutlass", "cublas", "matmul", "dot_kernel",
                            "nvjet")):
        return "gemm (cuBLAS)"
    if "softmax" in n:
        return "softmax"
    if "layer_norm" in n or "layernorm" in n:
        return "layer_norm"
    if "cat" in n or "copy" in n or "index" in n or "gather" in n or "scatter" in n:
        return "copy / cat / index"
    return "elementwise / reduce / other"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--compute_dtype", type=str, default=None, choices=["bfloat16", "float32"])
    ap.add_argument("--batched_wav", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args()
    mode = "".join(f"_{m}" for m in (args.compute_dtype, args.batched_wav and "batched_wav")
                   if m)
    out_path = args.out or str(REPO / "outputs" / f"torch_profile_emage{mode}.json")
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
    results = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
               "compute_dtype": args.compute_dtype, "batched_wav": args.batched_wav,
               "cells": []}

    for bs, seconds in CELLS:
        audio = (torch.rand(bs, seconds * 16000, generator=g) - 0.5).cuda()
        spk = torch.zeros((bs, 1), dtype=torch.long, device="cuda")
        zero_trans = torch.zeros(1, 3, device="cuda")

        def call():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = model.inference(audio, spk, vq, compute_dtype=args.compute_dtype,
                                  batched_wav=args.batched_wav)
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
        intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
        busy = sum(end - start for start, end in merge(intervals))
        kernel_sum = sum(by_family.values())
        k1 = [e.time_range.elapsed_us() / 1e3
              for e in sorted(kernels, key=lambda e: e.time_range.start)
              if family(e.name) == "K1 vq_nearest_code"]
        cell = {
            "batch": bs, "seconds": seconds, "compute_dtype": args.compute_dtype,
            "batched_wav": args.batched_wav,
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
            "k1_ms_by_launch": k1,  # in launch order: windows, remainder, final decode
            "top_kernels_ms": [
                (e.key[:100], e.self_device_time_total / 1e3)
                for e in sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:12]
            ],
        }
        results["cells"].append(cell)
        print(json.dumps(cell), flush=True)
        del audio

    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    Path(out_path).write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
