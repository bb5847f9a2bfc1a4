"""Where the time goes in the PyTorch/CUDA port's train steps, on one NVIDIA GPU.

    python3 scripts/torch_profile_train.py [--steps 10] [--families camn,disco,emage]
        [--out outputs/torch_profile_train.json]
    python3 scripts/torch_profile_train.py --ladder [--batch 56] [--frames 64]
        [--dtype bfloat16|float32] [--k 10] [--repeats 5] [--rungs 0,1,2,3,4,5,6]
        [--device cuda|cpu]

For each family at the full-width cell of ``chip_smoke.py`` phase 18c (CaMN and DisCo
at batch 64 x 128 frames, EMAGE at 56 x 64 frames with random tokenizers; random weights
and one fixed batch from seeds, Adam at the shipped learning rate) and each mode (fp32,
bf16) it runs 3 warm-up steps, then ``--steps`` timed steps (host clock, ending in
``torch.cuda.synchronize()``), then one step under ``torch.profiler``. It reports the
wall-time spread, the kernels launched a step, the device's busy and idle shares, device
time by kernel family, and the host and device time spent in the backward of the LSTM
layers (``LstmLayerFunctionBackward``: the layer recomputed through the plain
recurrence and differentiated).

``--ladder`` (the port of ``scripts/profile_train.py``) splits the EMAGE train step by
stage: it times a ladder of reduced steps, each adding one stage of the objective of
``train/steps.make_emage_train_step``, then the shipped step, so consecutive deltas are
the stages' marginal costs and the deltas sum to the shipped step's ms:

  L0 optimizer only   a zero loss over every trainable parameter (each gets a zero
                      gradient) and the Adam update
  L1 +targets         the frozen tokenizers' targets (vq_map2index, vq_map2latent) under
                      no_grad; eager PyTorch runs them without a term in the loss, so
                      none is added (the JAX ladder's 1e-9 term only kept XLA from
                      dropping them)
  L2 +WavEncoders     the two shared WavEncoders forward and backward, their BatchNorm
                      statistics amplified to three passes' (_amplify_bn_updates); a
                      1e-6-weighted mean of their features keeps them differentiated
                      while no pass reads them (this rung only)
  L3, L4, L5          pass 1 (seed mask), pass 2 (random mask, audio), pass 3 (no audio),
                      each with rec_loss and cls_loss
  L6 shipped          make_emage_train_step itself

The rungs restate the shipped step's loss from the port's own pieces (compute_params,
call, step_seed / mix_seed, mask_ratio_schedule, rand_rows, dropout_rng, _make_step)
with the same seeds, so L5 computes what the shipped step computes in one process: the
same losses and the same update (the zero loss adds exact zeros). Every rung starts from
the same weights and a fresh Adam, on one batch from numpy seed 0 (cli/bench_train's
EMAGE batch; full-width EmageAudioConfig() with dropout, random tokenizers). The protocol
is cli/bench_train's: one warm-up round, then --repeats rounds of --k steps, each ending
in a synchronize and a loss read; the median ms a step. Each rung reports that, its delta
from the rung before, the FLOPs of one step (FlopCounterMode), TFLOP/s and MFU against
utils/device.peak_bf16_tflops, the device ms and kernels of one profiled step and the peak
memory (these three on the card only), and its first step's losses. One row a rung is
printed as it goes (a rung that fails leaves the earlier rows), then one JSON line. It
runs on the card unless --device cpu is given.

Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_profile_emage import REPO, family, merge  # noqa: E402

WARMUP = 3
RUNGS = ("L0 optimizer only", "L1 +tokenizer targets", "L2 +shared WavEncoders",
         "L3 +pass 1 (seed mask)", "L4 +pass 2 (random mask)", "L5 +pass 3 (no audio)",
         "L6 shipped make_emage_train_step")
SHIPPED = len(RUNGS) - 1


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
    intervals = [(e.time_range.start, e.time_range.end) for e in kernels]
    busy = sum(end - start for start, end in merge(intervals))
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


def ladder_step(model, suite, optimizer, upto: int, compute_dtype=None, seed: int = 0,
                mask_schedule: str = "reference"):
    """Rung ``upto`` (0-5) of the ladder: ``make_emage_train_step``'s objective (its
    shared-WavEncoder path, no checkpointing) cut after ``upto`` stages, plus a zero loss
    over every trainable parameter, as an update step."""
    from pantomatrix_tpu_torch.models.emage_vq import vq_map2index, vq_map2latent
    from pantomatrix_tpu_torch.nn.layers import BatchNorm1d, DropoutRng, dropout_rng, mix_seed
    from pantomatrix_tpu_torch.train.losses import cls_loss, rec_loss
    from pantomatrix_tpu_torch.train.steps import (_amplify_bn_updates, _cast, _make_step,
                                                   _rot6d, _speaker, call, compute_params,
                                                   mask_ratio_schedule, step_seed,
                                                   sub_params)
    from pantomatrix_tpu_torch.utils.distributed import rand_rows
    from pantomatrix_tpu_torch.utils.precision import compute_dtype_of

    cfg = model.config
    dtype = compute_dtype_of(compute_dtype)
    w = dict(lu=cfg.lu, ll=cfg.ll, lh=cfg.lh, lf=cfg.lf)
    c = dict(cu=cfg.cu, cl=cfg.cl, ch=cfg.ch, cf=cfg.cf)
    encoders = ("audio_encoder_face", "audio_encoder_body")
    trainable = [p for p in model.parameters() if p.requires_grad]

    def run_pass(params, pass_seed, audio, speaker_id, masked_motion, mask, use_audio,
                 features):
        with dropout_rng(DropoutRng(pass_seed, audio.device)):
            pred = call(model, params, audio, speaker_id, masked_motion, mask,
                        use_audio=use_audio, audio_features=features)
        return {k: v.float() for k, v in pred.items()}

    def loss_fn(batch, iteration):
        total = torch.stack([p.sum() for p in trainable]).sum() * 0.0
        rot6d = _rot6d(batch["motion"])
        speaker_id = _speaker(batch)
        if upto >= 1:
            with torch.no_grad():
                args = (suite, rot6d, batch["expressions"], batch["foot_contact"],
                        batch["trans"])
                target_idx, target_lat = vq_map2index(*args), vq_map2latent(*args)
        masked_motion = torch.cat([rot6d, batch["trans"], batch["foot_contact"]], dim=-1)
        params = compute_params(model, dtype)
        audio, masked_motion = _cast(dtype, batch["audio"]), _cast(dtype, masked_motion)
        seed0 = step_seed(seed, iteration)
        features = None
        if upto >= 2:
            snapshot = {bn: (bn.running_mean.clone(), bn.running_var.clone())
                        for name in encoders for bn in getattr(model, name).modules()
                        if isinstance(bn, BatchNorm1d)}
            with dropout_rng(DropoutRng(mix_seed(seed0, 0), audio.device)):
                features = tuple(call(getattr(model, name), sub_params(params, name), audio)
                                 for name in encoders)
            _amplify_bn_updates(snapshot, 3)
            if upto == 2:
                total = total + 1e-6 * sum(f.float().mean() for f in features)
        losses = {}
        if upto >= 3:
            mask1 = torch.ones_like(masked_motion)
            mask1[:, :cfg.seed_frames] = 0.0
            pred = run_pass(params, mix_seed(seed0, 1), audio, speaker_id, masked_motion,
                            mask1, True, features)
            losses["rec_seed"] = rec_loss(pred, target_lat, **w)
            losses["cls_seed"] = cls_loss(pred, target_idx, **c)
        if upto >= 4:
            ratio = mask_ratio_schedule(float(iteration), mask_schedule)
            g = torch.Generator(masked_motion.device).manual_seed(mix_seed(seed0, 4))
            mask2 = (rand_rows(masked_motion.shape, g, masked_motion.device)
                     < ratio).to(masked_motion.dtype)
            pred = run_pass(params, mix_seed(seed0, 2), audio, speaker_id, masked_motion,
                            mask2, True, features)
            losses["rec_audio"] = rec_loss(pred, target_lat, **w)
            losses["cls_audio"] = cls_loss(pred, target_idx, **c)
        if upto >= 5:
            pred = run_pass(params, mix_seed(seed0, 3), audio, speaker_id, masked_motion,
                            mask2, False, features)
            losses["rec_mask"] = rec_loss(pred, target_lat, **w)
            losses["cls_mask"] = cls_loss(pred, target_idx, **c)
        if losses:
            losses["all"] = sum(losses.values())
            total = total + losses["all"]
        else:
            losses["all"] = total
        return total, losses

    return _make_step(model, optimizer, loss_fn, dtype)


def make_rung(i: int, model, suite, optimizer, compute_dtype=None, seed: int = 0):
    """The step of rung ``i`` of ``RUNGS``: a reduced step, or (``SHIPPED``) the shipped
    one."""
    from pantomatrix_tpu_torch.train.steps import make_emage_train_step

    if i == SHIPPED:
        return make_emage_train_step(model, suite, optimizer, compute_dtype=compute_dtype,
                                     seed=seed)
    return ladder_step(model, suite, optimizer, i, compute_dtype=compute_dtype, seed=seed)


def profile_step(fn):
    """(device ms, kernels) of one call of ``fn`` under torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def run_ladder(model, suite, batch, rungs, k: int, repeats: int, compute_dtype=None,
               lr: float = 1.5e-4, emit=print, profile: bool = True) -> dict:
    """Each rung of ``rungs`` (indices into ``RUNGS``) from the model's present weights
    and a fresh Adam, timed as cli/bench_train times a step; {rung name: row}. On the
    card one more step runs under torch.profiler unless ``profile`` is False."""
    from torch.utils.flop_counter import FlopCounterMode

    from pantomatrix_tpu_torch.train.optim import make_optimizer
    from pantomatrix_tpu_torch.utils.device import peak_bf16_tflops

    device = next(model.parameters()).device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    peak = peak_bf16_tflops(torch.cuda.get_device_name(device)) if on_card else None
    init = {name: t.detach().clone() for name, t in model.state_dict().items()}
    rows, prev = {}, 0.0
    for i in rungs:
        model.load_state_dict(init)
        step = make_rung(i, model, suite, make_optimizer(model.parameters(), learning_rate=lr),
                         compute_dtype)
        if on_card:
            sync()
            torch.cuda.reset_peak_memory_stats()
        iteration, first = 0, None

        def one_round():
            nonlocal iteration, first
            t0 = time.perf_counter()
            for _ in range(k):
                losses = step(batch, iteration)
                if first is None:  # the warm-up round's first step (a sync: not timed)
                    first = {name: float(v) for name, v in losses.items()}
                iteration += 1
            sync()
            probe = float(losses["all"])  # forced completion
            if not np.isfinite(probe):
                raise AssertionError(f"{RUNGS[i]}: non-finite loss {probe}")
            return time.perf_counter() - t0

        warmup_s = one_round()
        times = [one_round() / k * 1e3 for _ in range(repeats)]
        with FlopCounterMode(display=False) as counter:
            step(batch, iteration)
        iteration += 1
        device_ms, kernels = profile_step(lambda: step(batch, iteration)) \
            if on_card and profile else (None, None)
        med = float(np.median(times))
        flops = int(counter.get_total_flops())
        tflops = flops / (med / 1e3) / 1e12
        row = {"ms_per_step": med, "delta_ms": med - prev, "ms_min": min(times),
               "ms_max": max(times), "flops_per_step": flops, "tflops": tflops,
               "mfu": tflops / peak if on_card else None, "device_ms": device_ms,
               "kernels_per_step": kernels,
               "peak_mem_gb": torch.cuda.max_memory_allocated(device) / 1e9 if on_card else None,
               "warmup_s": warmup_s, "first_step_losses": first}
        prev = med
        rows[RUNGS[i]] = row
        emit(f"{RUNGS[i]:36s} {med:9.2f} ms/step  delta {row['delta_ms']:8.2f} ms  "
             f"{tflops:7.2f} TFLOP/s  device "
             + ("-" if device_ms is None else f"{device_ms:.2f} ms, {kernels} kernels"))
    model.load_state_dict(init)
    return rows


def ladder_main(args) -> dict:
    """The ladder at full width on ``args.device``: one JSON line."""
    from pantomatrix_tpu_torch.cli.bench_train import _emage_batch
    from pantomatrix_tpu_torch.models.api import EmageAudioModel, EmageVQModel, resolve_device
    from pantomatrix_tpu_torch.models.configs import EmageAudioConfig

    from pantomatrix_tpu_torch.utils.device import card_line

    device = resolve_device(args.device)
    card = card_line() if device.type == "cuda" else None
    model = EmageAudioModel(EmageAudioConfig(), seed=0, device=device)
    suite = EmageVQModel.random(seed=1, device=device)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in _emage_batch(np.random.RandomState(0), args.batch, args.frames).items()}
    dtype = None if args.dtype == "float32" else args.dtype
    rungs = [int(i) for i in args.rungs.split(",")]
    rows = run_ladder(model, suite, batch, rungs, args.k, args.repeats, dtype,
                      emit=lambda line: print(line, flush=True))
    result = {"batch": args.batch, "frames": args.frames, "dtype": args.dtype, "k": args.k,
              "repeats": args.repeats, "device": str(device), "card": card, "rungs": rows}
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--families", type=str, default="camn,disco,emage")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--ladder", action="store_true",
                    help="the EMAGE train-step ladder instead of the whole-step profiles")
    ap.add_argument("--batch", type=int, default=56)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--dtype", default="bfloat16", choices=("float32", "bfloat16"))
    ap.add_argument("--k", type=int, default=10, help="steps a timed round")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--rungs", default=",".join(str(i) for i in range(len(RUNGS))),
                    help="comma-separated indices into the ladder (6 = the shipped step)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the ladder's device: cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    if args.ladder:
        return ladder_main(args)
    out_path = args.out or str(REPO / "outputs" / "torch_profile_train.json")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
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
