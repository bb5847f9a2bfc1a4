"""Training-throughput benchmark (counterpart of ``pantomatrix_tpu/cli/bench_train.py``):
ms a step for each family at the reference training configs, on one card.

    python -m pantomatrix_tpu_torch.cli.bench_train --family camn|disco|emage
        [--dtype bfloat16] [--batch 64] [--frames 128] [--k 10] [--repeats 5]
        [--device cuda|cpu]

- The work: the full-width model (``CamnAudioConfig()``, ``DiscoAudioConfig()``, or
  ``EmageAudioConfig()`` with dropout and random tokenizers), random weights from a
  seed, Adam at 1.5e-4, on one synthetic batch from a numpy seed (the JAX CLI's
  ``_camn_like_batch`` and ``_emage_batch``): 64 clips x 128 frames for CaMN and DisCo,
  56 x 64 for EMAGE, unless ``--batch`` / ``--frames`` say otherwise.
- Timing: one warm-up round, then ``--repeats`` rounds of ``--k`` steps one after
  another (the JAX package fuses them into one program; the port does not), each round
  ending in ``torch.cuda.synchronize()`` and a read of the last loss (forced
  completion); the headline is the median ms a step over the rounds, with min and max.
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one step, forward and
  backward. It counts PyTorch's matrix products and convolutions; K2's forward launch
  (ctypes) is not among them, so on the card the count is a floor.
- MFU: achieved FLOP/s over the card's dense bf16 peak (``bench.PEAK_BF16_TFLOPS``); the
  run raises unless mfu < 1. On the CPU there is no peak, and mfu is null.
- K2 launches a step (8 for CaMN, 4 for DisCo on the card) and K1 launches (none).

Prints one JSON line with the JAX CLI's keys, the card's name and power limit, the
launch counts and the counter's name.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _camn_like_batch(rng, bs, frames, motion_ch, labels=False):
    """Audio long enough for ``frames`` frames at 15 fps from the WavEncoder (1066
    samples a frame), motion at the encoder's output length."""
    from ..nn.blocks import wav_encoder_out_len

    n = frames * 1066
    t = wav_encoder_out_len(n, 128, "camn")
    batch = {"motion": rng.uniform(-0.5, 0.5, (bs, t, motion_ch)).astype("float32"),
             "audio": rng.uniform(-1, 1, (bs, n)).astype("float32")}
    if labels:
        batch["rhythm_label"] = rng.randint(0, 4, (bs, 1))
        batch["content_label"] = rng.randint(0, 8, (bs, 1))
    return batch


def _emage_batch(rng, bs, frames):
    return {
        "motion": rng.uniform(-0.5, 0.5, (bs, frames, 165)).astype("float32"),
        "audio": rng.uniform(-1, 1, (bs, frames * 533)).astype("float32"),
        "expressions": rng.uniform(-1, 1, (bs, frames, 100)).astype("float32"),
        "trans": rng.uniform(-1, 1, (bs, frames, 3)).astype("float32"),
        "foot_contact": (rng.uniform(size=(bs, frames, 4)) < 0.5).astype("float32"),
    }


def setup(family: str, bs: int, frames: int, dtype, device):
    """The model, its train step and the batch on ``device``."""
    from ..models.api import CamnAudioModel, DiscoAudioModel, EmageAudioModel, EmageVQModel
    from ..models.configs import CamnAudioConfig, DiscoAudioConfig, EmageAudioConfig
    from ..train.optim import make_optimizer
    from ..train.steps import make_camn_train_step, make_disco_train_step, make_emage_train_step

    rng = np.random.RandomState(0)
    if family == "emage":
        model = EmageAudioModel(EmageAudioConfig(), seed=0, device=device)
        suite = EmageVQModel.random(seed=1, device=device)
        opt = make_optimizer(model.parameters(), learning_rate=1.5e-4)
        step = make_emage_train_step(model, suite, opt, compute_dtype=dtype)
        batch = _emage_batch(rng, bs, frames)
    else:
        model_cls, cfg, make = {
            "camn": (CamnAudioModel, CamnAudioConfig(), make_camn_train_step),
            "disco": (DiscoAudioModel, DiscoAudioConfig(), make_disco_train_step)}[family]
        model = model_cls(cfg, seed=0, device=device)
        opt = make_optimizer(model.parameters(), learning_rate=1.5e-4)
        step = make(model, opt, compute_dtype=dtype)
        batch = _camn_like_batch(rng, bs, frames, cfg.pose_dims // 2,
                                 labels=(family == "disco"))
    return model, step, {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--family", choices=("camn", "disco", "emage"), required=True)
    p.add_argument("--dtype", default=None, choices=(None, "float32", "bfloat16"))
    p.add_argument("--batch", type=int, default=0)  # 0 = the reference config's
    p.add_argument("--frames", type=int, default=0)
    p.add_argument("--k", type=int, default=10, help="steps a timed round")
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from torch.utils.flop_counter import FlopCounterMode

    from ..bench import peak_bf16_tflops
    from ..models.api import resolve_device
    from ..ops import lstm_cuda, vq_cuda
    from ..utils.device import card_line

    device = resolve_device(args.device)
    on_card = device.type == "cuda"
    dtype = None if args.dtype in (None, "float32") else args.dtype
    emage = args.family == "emage"
    bs = args.batch or (56 if emage else 64)
    frames = args.frames or (64 if emage else 128)
    _, step, batch = setup(args.family, bs, frames, dtype, device)
    key = "all" if emage else "all_loss"
    k = args.k
    iteration = 0

    def rounds():
        nonlocal iteration
        for _ in range(k):
            losses = step(batch, iteration)
            iteration += 1
        if on_card:
            torch.cuda.synchronize()
        probe = float(losses[key])  # forced completion: the last step's loss on the host
        if not np.isfinite(probe):
            raise AssertionError(f"non-finite {key} {probe}")

    t0 = time.perf_counter()
    rounds()  # warm-up: builds the kernels, cuDNN plans and the optimizer state
    warmup_s = time.perf_counter() - t0
    launches0 = (lstm_cuda.launches, vq_cuda.launches)
    times = []
    for _ in range(args.repeats):
        t0 = time.perf_counter()
        rounds()
        times.append((time.perf_counter() - t0) / k * 1e3)
    steps = args.repeats * k
    k2 = (lstm_cuda.launches - launches0[0]) / steps
    k1 = vq_cuda.launches - launches0[1]
    with FlopCounterMode(display=False) as counter:
        step(batch, iteration)
    flops = int(counter.get_total_flops())

    med = float(np.median(times))
    tflops = flops / (med / 1e3) / 1e12
    mfu = None
    if on_card:
        mfu = tflops / peak_bf16_tflops(torch.cuda.get_device_name(device))
        if not mfu < 1.0:
            raise AssertionError(f"impossible MFU {mfu:.3f}: the timing did not force "
                                 "completion")
    print(json.dumps({
        "family": args.family, "dtype": args.dtype or "float32", "batch": bs,
        "frames": frames, "k": k, "repeats": args.repeats, "ms_per_step": med,
        "ms_min": min(times), "ms_max": max(times), "steps_per_s": 1e3 / med,
        "flops_per_step": flops, "tflops": tflops, "mfu": mfu, "compile_s": warmup_s,
        "k2_launches_per_step": k2, "k1_launches": k1,
        "flop_counter": "torch.utils.flop_counter.FlopCounterMode",
        "device": str(device), "card": card_line() if on_card else None,
    }))


if __name__ == "__main__":
    main()
