"""Throughput benchmark of the port: EMAGE full-body inference on one NVIDIA GPU, by the
protocol of the repository's ``bench.py`` (which times the JAX package).

    python -m pantomatrix_tpu_torch.bench [--compute_dtype bfloat16] [--batched_wav]
        [--reps 5] [--iters 4]

- The work: the full-width model (``EmageAudioConfig()``, the reference tokenizer
  widths, random weights from a seed), batch 128 x 60 s of 16 kHz audio through
  ``EmageAudioModel.inference`` (every full window a CUDA graph replay), head routing,
  and ``EmageVQModel.decode(get_global_motion=True)``.
- Forced completion: the timed region copies a slice of every output to the host, which
  cannot finish before the call has. ``wall_s_full_host_materialization`` is the same
  call with every output copied to the host.
- Timing: ``--reps`` repetitions of an ``--iters``-call loop after one warm-up call
  (which captures the graphs); the headline is the median wall per call, with min and
  max.
- FLOPs by composition: rounds x one full window step + the remainder window + the
  final decode, each counted by ``torch.utils.flop_counter.FlopCounterMode`` over one
  eager call at the full shapes. The counter counts matrix products, convolutions and
  attention; the nearest-code search (its own kernel) and elementwise work are left
  out, so the count is a floor.
- MFU: achieved FLOP/s over the card's dense bf16 peak (``PEAK_BF16_TFLOPS``, by device
  name); the run raises unless mfu < 1.

Prints one JSON line with the card's name and power limit; writes no file.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

BATCH, SECONDS = 128, 60.0
FLOP_COUNTER = "torch.utils.flop_counter.FlopCounterMode"
# dense bf16 tensor-core peak, TFLOP/s, by a substring of torch.cuda.get_device_name
# (NVIDIA's H100 SXM data sheet; the SXM part names itself "H100 80GB HBM3")
PEAK_BF16_TFLOPS = {"H100 80GB HBM3": 989.4, "H100 SXM": 989.4}


def peak_bf16_tflops(device_name: str) -> float:
    for key, peak in PEAK_BF16_TFLOPS.items():
        if key in device_name:
            return peak
    raise ValueError(f"no dense bf16 peak known for {device_name!r}; add it to "
                     "PEAK_BF16_TFLOPS")


def count_flops(model, vq, audio, speaker_id, out, compute_dtype=None) -> dict:
    """FLOPs of one call by composition, from one eager call of each part: a full window
    step, the remainder window and the final decode (``out`` is a call's network
    outputs, which fix the decode's shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    from .models.emage import _select_decode_inputs, _window_step, prepare_ar_inputs
    from .utils.precision import cast_once, compute_dtype_of

    cfg = model.config
    motion, mask, rounds, remain = prepare_ar_inputs(cfg, audio)
    dtype = compute_dtype_of(compute_dtype)
    m = cast_once(model, dtype)
    cast = (lambda x: x) if dtype is None else (lambda x: x.to(dtype))
    window, pre = cfg.pose_length, cfg.seed_frames
    spf = 16000 // 30

    def flops(fn) -> int:
        with FlopCounterMode(display=False) as counter:
            fn()
        return int(counter.get_total_flops())

    def step(size):
        return flops(lambda: _window_step(m, vq, cast(audio[:, :size * spf]), speaker_id,
                                          cast(motion[:, :size]), cast(mask[:, :size])))

    parts = {"window_step": step(window), "rounds": rounds,
             "remainder_window": step(pre + remain) if remain > pre else 0,
             "final_decode": flops(lambda: vq.decode(
                 **_select_decode_inputs(cfg, out), get_global_motion=True,
                 ref_trans=torch.zeros(audio.shape[0], 1, 3, device=audio.device)))}
    parts["total"] = (parts["rounds"] * parts["window_step"] + parts["remainder_window"]
                      + parts["final_decode"])
    return parts


def result_line(*, walls, wall_full, batch, seconds, frames, flops, device_name, card,
                compute_dtype, batched_wav, output_bytes, iters) -> dict:
    """The JSON line from the measured walls (s per call) and the counted FLOPs; raises
    unless the MFU is below 1 (else the loop timed the enqueue, not the work)."""
    wall = float(np.median(walls))
    rtf = batch * frames / 30.0 / wall
    peak = peak_bf16_tflops(device_name)
    tflops = flops["total"] / wall / 1e12
    mfu = tflops / peak
    if not mfu < 1.0:
        raise AssertionError(f"impossible MFU {mfu:.3f} ({tflops:.1f} TFLOP/s against a "
                             f"{peak} TFLOP/s peak): the loop timed dispatch, not completion")
    return {
        "metric": "emage_inference_realtime_factor", "value": rtf,
        "unit": "x_realtime_per_card", "batch": batch, "clip_seconds": seconds,
        "compute_dtype": compute_dtype or "float32", "batched_wav": batched_wav,
        "reps": len(walls), "iters_per_rep": iters, "wall_s_per_call": wall,
        "wall_s_per_call_min": float(min(walls)), "wall_s_per_call_max": float(max(walls)),
        "wall_s_full_host_materialization": wall_full,
        "output_mb_per_call": output_bytes / 1e6, "flops_per_call": flops["total"],
        "flops_by_part": flops, "flop_counter": FLOP_COUNTER, "tflops": tflops,
        "peak_bf16_tflops": peak, "mfu": mfu, "device": device_name, "card": card,
    }


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--compute_dtype", type=str, default=None, choices=["bfloat16", "float32"])
    p.add_argument("--batched_wav", action="store_true")
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--iters", type=int, default=4)
    args = p.parse_args(argv)

    from .cli.test_emage import load_models
    from .models.emage import _select_decode_inputs
    from .utils.device import card_line

    model, vq = load_models(None, True, "cuda")  # raises without a CUDA card
    cfg = model.config
    rng = np.random.RandomState(0)
    audio = torch.from_numpy(rng.uniform(-1, 1, (BATCH, int(SECONDS * 16000)))
                             .astype(np.float32)).cuda()
    spk = torch.zeros((BATCH, 1), dtype=torch.long, device="cuda")
    ref_trans = torch.zeros((BATCH, 1, 3), device="cuda")

    def call():
        out = model.inference(audio, spk, vq, compute_dtype=args.compute_dtype,
                              batched_wav=args.batched_wav)
        dec = vq.decode(**_select_decode_inputs(cfg, out), get_global_motion=True,
                        ref_trans=ref_trans)
        return out, (dec["motion_axis_angle"], dec["expression"], dec["trans"])

    out, outputs = call()  # warm-up: captures the window graphs
    flops = count_flops(model, vq, audio, spk, out, args.compute_dtype)
    del out
    walls = []
    for _ in range(args.reps):
        t0 = time.perf_counter()
        for _ in range(args.iters):
            _, outputs = call()
            # a host copy of a slice of every output: it cannot finish before the call
            probes = [o[:, -1, :1].cpu() for o in outputs]
        walls.append((time.perf_counter() - t0) / args.iters)
    del probes
    t0 = time.perf_counter()
    _, outputs = call()
    host = [o.cpu() for o in outputs]
    wall_full = time.perf_counter() - t0
    print(json.dumps(result_line(
        walls=walls, wall_full=wall_full, batch=BATCH, seconds=SECONDS,
        frames=host[0].shape[1], flops=flops, device_name=torch.cuda.get_device_name(0),
        card=card_line(), compute_dtype=args.compute_dtype, batched_wav=args.batched_wav,
        output_bytes=sum(h.numel() * h.element_size() for h in host), iters=args.iters)))


if __name__ == "__main__":
    main()
