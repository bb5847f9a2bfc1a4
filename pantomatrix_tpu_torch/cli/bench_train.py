"""Training-throughput benchmark (counterpart of ``pantomatrix_tpu/cli/bench_train.py``):
ms a step for each family at the reference training configs, over every card of a host.

    python -m pantomatrix_tpu_torch.cli.bench_train --family camn|disco|emage
        [--dtype bfloat16] [--batch 64] [--frames 128] [--k 10] [--repeats 5]
        [--device cuda|cpu] [--cards N]

- The work: the full-width model (``CamnAudioConfig()``, ``DiscoAudioConfig()``, or
  ``EmageAudioConfig()`` with dropout and random tokenizers), random weights from a
  seed, Adam at 1.5e-4, on one synthetic global batch from a numpy seed (the JAX CLI's
  ``_camn_like_batch`` and ``_emage_batch``): 64 clips x 128 frames for CaMN and DisCo,
  56 x 64 for EMAGE, unless ``--batch`` / ``--frames`` say otherwise.
- Processes, as the JAX CLI splits the batch over every local device
  (``make_data_mesh(bs)``): under torchrun or the ``PANTO_*`` variables each process
  joins the group (``train/mesh.maybe_init_distributed``). Started plainly, the CLI
  takes ``--cards`` cards (default: every visible card; on the CPU, 1), shrunk to the
  largest count that divides ``--batch`` (``train/mesh.data_axis_size``), and spawns one
  process a card (NCCL; ``--device cpu``: gloo processes on the CPU); at one it runs in
  this process without a group. Every process builds the same model from the same
  seeds, takes rank 0's weights (``replicate``), builds the same global batch and keeps
  its block of rows (``shard_batch``); the step runs on the data mesh (synced BatchNorm,
  draws at the global shape, one gradient all-reduce a step).
- Timing: one warm-up round, then ``--repeats`` rounds of ``--k`` steps one after
  another (the JAX package fuses them into one program; the port does not), each round
  after a barrier and ending in ``torch.cuda.synchronize()`` and a read of the last loss
  (forced completion); a round's time is the slowest process's (an all-reduce MAX). The
  headline is the median ms a step over the rounds, with min and max.
- FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one step, forward and
  backward, summed over the processes (the global step), plus ``k2_forward_flops``: the
  recurrent products of K2's forward launches in that step (``ops/lstm_cuda.layer_flops``
  per launch), which the counter cannot see in a ctypes launch. On the CPU the plain
  recurrence runs instead, the counter counts it, and nothing is added.
- MFU: the global FLOP/s over ``cards`` times one card's dense bf16 peak
  (``utils/device.PEAK_BF16_TFLOPS``), a per-card share; the run raises unless mfu < 1.
  On the CPU there is no peak, and mfu is null.
- K2 launches a step (8 for CaMN, 4 for DisCo on the card), process 0's and each
  process's, and K1 launches (none).

Process 0 prints one JSON line: the JAX CLI's keys, the card's name and power limit, the
launch counts, the counter's name, and ``processes``, ``cards`` (the distinct cards used,
0 on the CPU), ``local_batch``, ``backend`` (null without a group), ``last_loss`` (the
last round's loss read, averaged over the processes: the global batch's) and
``k2_forward_flops``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist


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


def setup(family: str, bs: int, frames: int, dtype, device, mesh=None):
    """The model, its train step and this process's rows of the global batch on
    ``device``; on a mesh the weights (and EMAGE's tokenizers) are rank 0's."""
    from ..models.api import CamnAudioModel, DiscoAudioModel, EmageAudioModel, EmageVQModel
    from ..models.configs import CamnAudioConfig, DiscoAudioConfig, EmageAudioConfig
    from ..train.mesh import replicate, shard_batch
    from ..train.optim import make_optimizer
    from ..train.steps import make_camn_train_step, make_disco_train_step, make_emage_train_step

    rng = np.random.RandomState(0)
    if family == "emage":
        model = EmageAudioModel(EmageAudioConfig(), seed=0, device=device)
        suite = EmageVQModel.random(seed=1, device=device)
        if mesh is not None:
            replicate(suite, mesh)
        opt = make_optimizer(model.parameters(), learning_rate=1.5e-4)
        step = make_emage_train_step(model, suite, opt, compute_dtype=dtype, mesh=mesh)
        batch = _emage_batch(rng, bs, frames)
    else:
        model_cls, cfg, make = {
            "camn": (CamnAudioModel, CamnAudioConfig(), make_camn_train_step),
            "disco": (DiscoAudioModel, DiscoAudioConfig(), make_disco_train_step)}[family]
        model = model_cls(cfg, seed=0, device=device)
        opt = make_optimizer(model.parameters(), learning_rate=1.5e-4)
        step = make(model, opt, compute_dtype=dtype, mesh=mesh)
        batch = _camn_like_batch(rng, bs, frames, cfg.pose_dims // 2,
                                 labels=(family == "disco"))
    if mesh is not None:
        replicate(model, mesh)
    batch = {k: torch.from_numpy(np.asarray(v)).to(device) for k, v in batch.items()}
    if mesh is not None:
        batch = shard_batch(batch, mesh)
    return model, step, batch


def _cards_used(device: torch.device) -> int:
    """The distinct cards of the job (0 on the CPU): one a process under NCCL; where
    processes share cards over gloo, each host's ``min(LOCAL_WORLD_SIZE, cards)``
    (``train/mesh.backend_and_card`` puts local rank r on card r modulo the cards)."""
    if device.type != "cuda":
        return 0
    if not dist.is_initialized():
        return 1
    world = dist.get_world_size()
    if dist.get_backend() == "nccl":
        return world
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    return min(local, torch.cuda.device_count()) * (world // local)


def measure(args: dict) -> dict:
    """The benchmark in this process, within the process group if there is one: every
    process returns the line (``args``: the parsed flags as a dict)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.api import resolve_device
    from ..ops import lstm_cuda, vq_cuda
    from ..train.mesh import make_data_mesh
    from ..utils.device import card_line, peak_bf16_tflops

    device = resolve_device(args["device"])
    on_card = device.type == "cuda"
    if on_card:
        device = torch.device("cuda", torch.cuda.current_device())
    grouped = dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    backend = dist.get_backend() if grouped else None
    # gloo reduces host tensors natively; NCCL only device tensors
    coll_device = device if backend == "nccl" else torch.device("cpu")

    def all_reduce(values, op=dist.ReduceOp.SUM):
        t = torch.tensor(values, dtype=torch.float64, device=coll_device)
        if grouped:
            dist.all_reduce(t, op=op)
        return t.tolist()

    dtype = None if args["dtype"] in (None, "float32") else args["dtype"]
    emage = args["family"] == "emage"
    bs = args["batch"] or (56 if emage else 64)
    frames = args["frames"] or (64 if emage else 128)
    mesh = make_data_mesh(bs) if grouped else None
    _, step, batch = setup(args["family"], bs, frames, dtype, device, mesh)
    key = "all" if emage else "all_loss"
    k = args["k"]
    iteration = 0

    def one_round():
        nonlocal iteration
        all_reduce([0.0])  # barrier: every process starts the round together
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            losses = step(batch, iteration)
            iteration += 1
        if on_card:
            torch.cuda.synchronize()
        probe = float(losses[key])  # forced completion: the last step's loss on the host
        elapsed = time.perf_counter() - t0
        if not np.isfinite(probe):
            raise AssertionError(f"non-finite {key} {probe}")
        return all_reduce([elapsed], dist.ReduceOp.MAX)[0], probe

    warmup_s, _ = one_round()  # builds the kernels, cuDNN plans and the optimizer state
    launches0 = (lstm_cuda.launches, vq_cuda.launches)
    times = []
    for _ in range(args["repeats"]):
        elapsed, probe = one_round()
        times.append(elapsed / k * 1e3)
    steps = args["repeats"] * k
    k2 = (lstm_cuda.launches - launches0[0]) / steps
    k2_by_process = [0.0] * world
    k2_by_process[rank] = k2
    k2_by_process = all_reduce(k2_by_process)
    k1 = vq_cuda.launches - launches0[1]
    k2_flops0 = lstm_cuda.forward_flops
    with FlopCounterMode(display=False) as counter:
        step(batch, iteration)
    counted, k2_flops, loss_sum = all_reduce([
        float(counter.get_total_flops()), float(lstm_cuda.forward_flops - k2_flops0), probe])
    flops = int(counted + k2_flops)

    med = float(np.median(times))
    tflops = flops / (med / 1e3) / 1e12
    cards = _cards_used(device)
    mfu = None
    if on_card:
        mfu = tflops / (cards * peak_bf16_tflops(torch.cuda.get_device_name(device)))
        if not mfu < 1.0:
            raise AssertionError(f"impossible MFU {mfu:.3f}: the timing did not force "
                                 "completion")
    return {
        "family": args["family"], "dtype": args["dtype"] or "float32", "batch": bs,
        "frames": frames, "k": k, "repeats": args["repeats"], "ms_per_step": med,
        "ms_min": min(times), "ms_max": max(times), "steps_per_s": 1e3 / med,
        "flops_per_step": flops, "tflops": tflops, "mfu": mfu, "compile_s": warmup_s,
        "k2_launches_per_step": k2, "k2_launches_per_step_by_process": k2_by_process,
        "k1_launches": k1, "k2_forward_flops": int(k2_flops),
        "flop_counter": "torch.utils.flop_counter.FlopCounterMode",
        "processes": world, "cards": cards, "local_batch": bs // world, "backend": backend,
        "last_loss": loss_sum / world,
        "device": str(device), "card": card_line() if on_card else None,
    }


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
    p.add_argument("--cards", type=int, default=0,
                   help="processes of a plain start, one a card (gloo processes with "
                        "--device cpu); 0 = every visible card (1 on the CPU); shrunk to "
                        "divide --batch. A torchrun / PANTO_* launch sets its own")
    args = vars(p.parse_args(argv))

    from ..models.api import resolve_device
    from ..train.mesh import data_axis_size, maybe_init_distributed, run_processes

    rank, world = maybe_init_distributed(args["device"])
    if dist.is_initialized():
        try:
            line = measure(args)
        finally:
            dist.destroy_process_group()
        if rank == 0:
            print(json.dumps(line), flush=True)
        return
    device = resolve_device(args["device"])
    wanted = args["cards"] or (torch.cuda.device_count() if device.type == "cuda" else 1)
    bs = args["batch"] or (56 if args["family"] == "emage" else 64)
    n = data_axis_size(bs, wanted)
    if n > 1:
        line = run_processes(measure, n, args["device"], (args,), timeout_s=3600.0,
                             threads=max(1, torch.get_num_threads() // n),
                             what=f"bench_train over {n} processes")[0]
    else:
        line = measure(args)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
