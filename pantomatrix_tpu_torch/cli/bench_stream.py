"""StreamingPool latency on the GPU (counterpart of ``pantomatrix_tpu/cli/bench_stream.py``):
the time of one batched pump wave (window step + batched chunk decode + host emission)
for N concurrent sessions at the full EMAGE config, random weights from a seed.

    python -m pantomatrix_tpu_torch.cli.bench_stream --sessions 8 [--repeats 10]
    python -m pantomatrix_tpu_torch.cli.bench_stream --sessions 1,8,32,64 \
        [--compute_dtype bfloat16]     # one process sweeps every N

Protocol, per N: N sessions each get one full window and one pump primes the pool (its
wall, ``first_pump_s``, includes the capture of the pool's two CUDA graphs); then
``--repeats`` times every session gets one stride of audio and one pump is timed on the
host clock. ``pump`` returns host numpy motion, so a timed wave has finished on the
card. Prints one JSON line per N with the pump's median and nearest-rank p90, the
real-time capacity (each pump emits stride / 30 s of motion per session, so the card
serves sessions * (stride / 30) / pump_s streams in real time), the ``compute_dtype``
and the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def pump_stats(times_ms, sessions: int, stride_frames: int) -> dict:
    """The line's numbers from the timed pumps' wall milliseconds (30 fps motion)."""
    times = sorted(times_ms)
    med = times[len(times) // 2]
    p90 = times[max(0, -(-9 * len(times) // 10) - 1)]  # nearest rank: ceil(0.9 n) - 1
    stride_s = stride_frames / 30
    return {"sessions": sessions, "repeats": len(times), "pump_ms_median": med,
            "pump_ms_p90": p90, "ms_per_stream": med / sessions,
            "motion_seconds_per_pump": stride_s * sessions,
            "realtime_streams_capacity": stride_s * sessions / (med / 1000.0)}


def bench_pool(model, vq, sessions: int, repeats: int, compute_dtype=None) -> dict:
    """Run the protocol on ``model``'s device; returns pump_stats plus ``first_pump_s``."""
    from ..serve import StreamingPool

    cfg = model.config
    pool = StreamingPool(model, vq, batch=sessions, compute_dtype=compute_dtype)
    rng = np.random.RandomState(0)
    sids = [pool.open(speaker_id=0) for _ in range(sessions)]
    window_samples = int(np.ceil(cfg.pose_length * 16000 / 30)) + 8
    stride = cfg.pose_length - cfg.seed_frames
    stride_samples = int(np.ceil(stride * 16000 / 30)) + 8
    for sid in sids:
        pool.feed(sid, rng.uniform(-0.5, 0.5, window_samples).astype(np.float32))
    t0 = time.perf_counter()
    out = pool.pump()
    first = time.perf_counter() - t0
    if len(out) != sessions:
        raise RuntimeError(f"priming pump emitted {len(out)} windows for {sessions} sessions")
    times = []
    for _ in range(repeats):
        for sid in sids:
            pool.feed(sid, rng.uniform(-0.5, 0.5, stride_samples).astype(np.float32))
        t0 = time.perf_counter()
        out = pool.pump()
        times.append((time.perf_counter() - t0) * 1000.0)
        if len(out) != sessions or not all(np.isfinite(r.motion_axis_angle).all()
                                            for _, r in out):
            raise RuntimeError(f"pump at N={sessions}: {len(out)} windows, or non-finite motion")
    return {**pump_stats(times, sessions, stride), "first_pump_s": first}


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--sessions", default="8",
                   help="session count, or a comma list to sweep in one process")
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--compute_dtype", type=str, default=None, choices=["bfloat16", "float32"])
    args = p.parse_args(argv)

    import torch

    from ..utils.device import card_line
    from .test_emage import load_models

    model, vq = load_models(None, True, "cuda")  # raises without a CUDA card
    card = card_line()
    for n in [int(s) for s in str(args.sessions).split(",")]:
        line = bench_pool(model, vq, n, args.repeats, args.compute_dtype)
        line.update(compute_dtype=args.compute_dtype or "float32",
                    device=torch.cuda.get_device_name(0), card=card)
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
