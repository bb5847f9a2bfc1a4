"""Smoke run of the PyTorch/CUDA port (pantomatrix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each of which raises on failure (nothing is caught):
  1. device: the card's name and power limit (nvidia-smi); no CUDA device -> error;
  2. build: compile the CUDA kernels of pantomatrix_tpu_torch/csrc with nvcc;
  3. K1 (VQ nearest-code search) against its plain PyTorch version on the card, at
     the test shapes and every shape the main path gives it (rows that differ must be
     near-ties), two calls bitwise equal, with each shape's launch plan; device time per
     launch (CUDA events around 20 back-to-back launches, replayed from a CUDA graph so
     that the host's cost per call is out of it) of the kernel, the plain version and
     torch.cdist(z, cb).argmin(-1) as a library yardstick; the kernel's 20 launches
     issued eagerly (eager_ms) and one call alone (call_ms), which show the wrapper's
     host cost; and the bounds: split TF32 on the tensor cores (bound_ms) and fp32 FMA
     (bound_fp32_ms);
  4. parity: a tiny EMAGE config through inference + decode on the CPU (plain K1) and
     on the card (the kernel), both in full float32;
  5. main path at full width (EmageAudioConfig(), reference tokenizer widths, random
     weights from a seed): batch 8 x 20 s through EmageAudioModel.inference and
     EmageVQModel.decode, counting K1 launches; then one timed call at batch 128 x 60 s;
  6. the CLI (python -m pantomatrix_tpu_torch.cli.test_emage --random_init) on a 3 s WAV;
  7. K2 (the persistent LSTM layer kernel) against its plain PyTorch version on the card,
     for one direction (lstm_direction) and for both directions of a layer in one launch
     (lstm_bidirectional): at the test and edge shapes to atol 1e-5, and at the CaMN/DisCo
     path shapes (T = 421, B = 8 and 64, H = 512) against a float64 run; two calls must
     be bitwise equal. CUDA-event timings of each layer launch and its us per step (with
     B = 1 as the per-step latency floor), the plain version and, as library yardsticks,
     cuDNN's torch.nn.LSTM(1024, 512) (one direction) and torch.nn.LSTM(1024, 512,
     bidirectional=True) for one layer, beside matmul projection + K2;
  8. parity: tiny CaMN and DisCo configs on the CPU (plain K2) and on the card;
  9. CaMN at full width (CamnAudioConfig(), random weights from a seed): batch 8 x 28.4 s
     once, checking shapes and 8 K2 launches (one per bidirectional layer), then timed
     calls at batch 8 and 64;
 10. DisCo at full width, the same, with 4 K2 launches;
 11. the CaMN CLI (python -m pantomatrix_tpu_torch.cli.test_camn --random_init) on a 3 s WAV.
It ends with a JSON line of per-kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX or of pantomatrix_tpu.
"""
from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
import wave
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores, dense TF32
# on the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES_PER_S = 3.35e12
K1_REPS = 20  # back-to-back launches per pair of CUDA events

K1_SHAPES = [
    # the kernel tests' shapes
    (512, 256, 256), (37, 16, 24), (640, 106, 256),
    # the main path's: batch 8 x 20 s (window, remainder window, final decode) ...
    (8 * 64, 256, 256), (8 * 60, 256, 256), (8 * 600, 256, 256),
    # ... and batch 128 x 60 s, whose final decode is the headline shape
    (128 * 64, 256, 256), (128 * 60, 256, 256), (128 * 1800, 256, 256),
]
K1_HEADLINE = (128 * 1800, 256, 256)
# (T, B, H): the K2 tests' shapes and edge shapes of the launch plan (one row, ragged
# batch groups, more rows than one pass of the grid), then CaMN/DisCo's at 28.4 s (421
# frames at 15 fps), and B = 1 for the per-step latency floor
K2_TEST_SHAPES = [(12, 8, 128), (9, 5, 96), (20, 16, 512),
                  (9, 1, 48), (9, 13, 96), (12, 128, 128), (5, 256, 512)]
K2_PATH_SHAPES = [(421, 8, 512), (421, 64, 512)]
K2_FLOOR_SHAPE = (421, 1, 512)
K2_HEADLINE = (421, 64, 512)
K2_ATOL = 1e-5
LSTM_SECONDS, LSTM_SAMPLES, LSTM_FRAMES = 28.4, 454400, 421
PARITY_ATOL = 1e-4
# decoded rotations pass through the reference's sqrt-based matrix -> quaternion step,
# which turns ~1e-6 float32 differences upstream into up to ~1e-3 near a zero
# quaternion component (tests/test_torch_emage.py)
PARITY_ROT_ATOL = 2e-3


def log(*args):
    print(*args, flush=True)


def nvidia_smi_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def import_port():
    """The port from this checkout, never from elsewhere on the path."""
    sys.path.insert(0, str(HERE))
    import pantomatrix_tpu_torch

    where = Path(pantomatrix_tpu_torch.__file__).resolve().parent.parent
    if where != HERE:
        raise RuntimeError(f"pantomatrix_tpu_torch imported from {where}, not {HERE}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of one call of ``fn`` after ``warmup`` calls:
    device time plus the host's launch gap where the host is slower than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def eager_ms(fn, reps: int = K1_REPS, runs: int = 5, warmup: int = 3) -> float:
    """Time per call of ``reps`` calls of ``fn`` issued back to back from Python, between
    two CUDA events (median of ``runs``): the device time, or the host's rate where the
    host takes longer per call than the device."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def graph_ms(fn, reps: int = K1_REPS, runs: int = 5) -> float:
    """Device time per call of ``fn``: ``reps`` back-to-back calls captured in a CUDA
    graph and replayed between two CUDA events, so that the host's cost per call is out
    of it (median of ``runs`` replays, divided by ``reps``)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graph capture wants
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def k1_bound(n: int, d: int, k: int):
    """Least time for fp32-grade indices on an H100: each input read once and the
    indices written once, against the split-TF32 product (three TF32 products of
    2*N*K*D each on the tensor cores). Also the bound of the same search in fp32 FMA
    (2*N*K*D plus the code norms and the N*K distances at the fp32 peak)."""
    nbytes = 4.0 * (n * d + k * d + n)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 3 * 2.0 * n * k * d / PEAK_TF32_FLOPS
    t_fp32 = (2.0 * n * k * d + 2.0 * k * d + 2.0 * n * k) / PEAK_FP32_FLOPS
    return (1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes",
            1e3 * max(t_fp32, t_bytes))


def phase_k1(device):
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.ops import vq_cuda

    g = torch.Generator().manual_seed(0)
    rows = []
    with strict_fp32():
        for shape in K1_SHAPES + [((2, 8), 16, 16)]:
            lead, d, k = shape
            lead = lead if isinstance(lead, tuple) else (lead,)
            z = torch.randn(*lead, d, generator=g).to(device)
            cb = torch.randn(k, d, generator=g).to(device)
            got, again = vq_cuda.nearest_code(z, cb), vq_cuda.nearest_code(z, cb)
            want = vq_cuda.nearest_code_plain(z, cb)
            model = vq_cuda.nearest_code_split_plain(z, cb)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.int32:
                raise AssertionError(f"K1 {shape}: {got.shape}/{got.dtype} vs {want.shape}")
            if not torch.equal(got, again):
                raise AssertionError(f"K1 {shape}: two calls differ")
            # rows that differ must be genuine near-ties: their two codes' distances,
            # recomputed in float64, within 1e-5 relative; and under 0.1% of rows
            z64, cb64 = z.reshape(-1, d).double(), cb.double()
            n = z64.shape[0]
            dist = lambda idx: ((z64 - cb64[idx.reshape(-1).long()]) ** 2).sum(-1)
            d_got, d_want = dist(got), dist(want)
            gap = (d_got - d_want).abs()
            differ = (got.reshape(-1) != want.reshape(-1))
            n_diff = int(differ.sum())
            rel = (gap / d_want.abs().clamp_min(1e-30))[differ]
            if n_diff and (float(rel.max()) >= 1e-5 or n_diff >= 1e-3 * n):
                raise AssertionError(f"K1 {shape}: {n_diff} rows differ, max rel gap "
                                     f"{float(rel.max())}")
            plan = vq_cuda.plan_search(n, d, k, torch.cuda.get_device_properties(
                device).multi_processor_count)
            row = {"shape": [n, d, k], "mismatches": n_diff, "max_abs_err": float(gap.max()),
                   "split_model_mismatches": int((got != model).sum()),
                   "bitwise_repeatable": True,
                   "plan": {"cluster": plan.cluster, "ctas": plan.ctas,
                            "codes_per_cta": plan.codes_per_cta,
                            "smem_bytes": plan.smem_bytes}}
            if len(lead) == 1:
                zc, cbc = z.contiguous(), cb.contiguous()
                kernel = lambda: vq_cuda.nearest_code(zc, cbc)
                row["kernel_ms"] = graph_ms(kernel)
                row["eager_ms"] = eager_ms(kernel)
                row["call_ms"] = cuda_ms(kernel)
                row["plain_ms"] = graph_ms(lambda: vq_cuda.nearest_code_plain(zc, cbc))
                row["library_ms"] = graph_ms(lambda: torch.cdist(zc, cbc).argmin(-1))
                row["bound_ms"], row["bound_by"], row["bound_fp32_ms"] = k1_bound(n, d, k)
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            rows.append(row)
            log(f"K1 vq_nearest_code {row}")
    return rows


def tiny_models(device):
    from pantomatrix_tpu_torch.models.api import (
        EmageAudioModel,
        EmageVAEConv,
        EmageVQModel,
        EmageVQVAEConv,
    )
    from pantomatrix_tpu_torch.models.configs import (
        EmageAudioConfig,
        EmageVAEConvConfig,
        EmageVQVAEConvConfig,
    )

    cb = 16  # the tiny config of tests/test_models_emage.py
    cfg = EmageAudioConfig(audio_f=32, motion_f=16, hidden_size=32, speaker_dims=4,
                           pose_length=8, seed_frames=2, vae_codebook_size=cb,
                           vae_length=cb, dropout_prob=0.0)
    part = lambda dim, seed: EmageVQVAEConv(
        EmageVQVAEConvConfig(vae_test_dim=dim, vae_length=cb, vae_codebook_size=cb),
        seed=seed, device=device)
    vq = EmageVQModel(face=part(106, 1), upper=part(78, 2), hands=part(180, 3),
                      lower=part(61, 4),
                      global_motion=EmageVAEConv(EmageVAEConvConfig(vae_layer=4, vae_length=48,
                                                                    vae_test_dim=61),
                                                 seed=5, device=device))
    # unit-scale codes, so decoded 6D rows are unit scale (tests/test_torch_emage.py)
    with torch.no_grad():
        for i, name in enumerate(("face", "upper", "hands", "lower")):
            w = getattr(vq, name).quantizer.embedding.weight
            w.copy_(torch.randn(w.shape, generator=torch.Generator().manual_seed(20 + i)))
    return cfg, EmageAudioModel(cfg, seed=6, device=device), vq


def run_tiny(device):
    from pantomatrix_tpu_torch.models.emage import _select_decode_inputs

    cfg, model, vq = tiny_models(device)
    audio = torch.rand(2, 23 * 533, generator=torch.Generator().manual_seed(7)) - 0.5
    spk = torch.tensor([[1], [2]])
    out = model.inference(audio.to(device), spk.to(device), vq)
    sel = _select_decode_inputs(cfg, out)
    dec = vq.decode(**sel, get_global_motion=True, ref_trans=torch.zeros(1, 3, device=device))
    return {k: v.cpu() for k, v in out.items()}, \
        {k: v.cpu() for k, v in sel.items() if v is not None}, \
        {k: v.cpu() for k, v in dec.items()}


def phase_parity():
    cpu = run_tiny("cpu")
    gpu = run_tiny("cuda")
    worst = {}
    for k in cpu[1]:
        if k.endswith("_index") and not torch.equal(cpu[1][k], gpu[1][k]):
            raise AssertionError(f"parity: head indices {k} differ between CPU and GPU")
    for name, a, b in [(k, cpu[0][k], gpu[0][k]) for k in cpu[0]] + \
            [(k, cpu[2][k], gpu[2][k]) for k in cpu[2]]:
        if name == "all_motion4inference":
            pairs = [("rot6d", a[..., :330], b[..., :330], PARITY_ROT_ATOL),
                     ("transfoot", a[..., 330:], b[..., 330:], PARITY_ATOL)]
        else:
            pairs = [(name, a, b, PARITY_ROT_ATOL if name == "motion_axis_angle"
                      else PARITY_ATOL)]
        for label, x, y, atol in pairs:
            err = float((x - y).abs().max())
            worst[label] = err
            if not err <= atol:
                raise AssertionError(f"parity: {label} differs by {err} > {atol}")
    log(f"parity CPU vs GPU (tiny config, full fp32): max abs err {worst}")


def phase_main_path(device, card, counted=(8, 20), timed=(128, 60)):
    """Generate ``counted`` = (batch, seconds) once, checking the outputs and the K1
    launch count, then time one call at ``timed`` after a warm-up."""
    from pantomatrix_tpu_torch.cli.test_emage import load_models
    from pantomatrix_tpu_torch.models.emage import _select_decode_inputs
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda

    t0 = time.time()
    model, vq = load_models(None, True, device)
    log(f"main path: full-width random init + upload {time.time() - t0:.1f} s")
    cfg = model.config
    g = torch.Generator().manual_seed(1)

    def generate(bs, seconds):
        audio = (torch.rand(bs, seconds * 16000, generator=g) - 0.5).to(device)
        spk = torch.zeros((bs, 1), dtype=torch.long, device=device)
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = model.inference(audio, spk, vq)
        dec = vq.decode(**_select_decode_inputs(cfg, out), get_global_motion=True,
                        ref_trans=torch.zeros(1, 3, device=device))
        torch.cuda.synchronize()
        return dec, time.perf_counter() - t_start

    bs, seconds = counted
    frames = seconds * 30
    rounds = (frames - cfg.seed_frames) // (cfg.pose_length - cfg.seed_frames)
    vq_cuda.launches = lstm_cuda.launches = 0
    dec, wall = generate(bs, seconds)
    launches = vq_cuda.launches
    if lstm_cuda.launches != 0:
        raise AssertionError(f"main path: K2 launched {lstm_cuda.launches} times, want 0")
    expect = {"motion_axis_angle": (bs, frames, 165), "expression": (bs, frames, 100),
              "trans": (bs, frames, 3)}
    for k, shape in expect.items():
        if tuple(dec[k].shape) != shape or not bool(torch.isfinite(dec[k]).all()):
            raise AssertionError(f"main path: {k} {tuple(dec[k].shape)} (want {shape}), "
                                 f"finite={bool(torch.isfinite(dec[k]).all())}")
    if launches != rounds + 1 + 1:
        raise AssertionError(f"main path: K1 launched {launches} times, want {rounds + 2}")
    log(f"main path: batch {bs} x {seconds} s -> {expect}, finite; K1 launches {launches} "
        f"({rounds} windows + remainder + final decode); first call {wall:.3f} s")

    bs, seconds = timed
    generate(bs, seconds)  # warm-up
    vq_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _, wall = generate(bs, seconds)
    result = {"batch": bs, "seconds": seconds, "wall_s": wall,
              "realtime_factor": bs * seconds / wall, "k1_launches": vq_cuda.launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log(f"main path timed: {json.dumps(result)}")
    return launches


def k2_bound(t: int, b: int, h: int, d: int = 1):
    """Least time for a layer of ``d`` directions on an H100: per direction 2*T*B*4H*H
    FMA work plus ~10*T*B*H gate operations, against xp and out moved once and W_hh
    read once."""
    flops = d * (2.0 * t * b * 4 * h * h + 10.0 * t * b * h)
    nbytes = d * 4.0 * (t * b * 4 * h + t * b * h + 4 * h * h)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def k2_fns(d: int):
    """The wrapper and the plain version of K2 for a layer of ``d`` directions."""
    from pantomatrix_tpu_torch.ops import lstm_cuda

    if d == 1:
        return lstm_cuda.lstm_direction, lstm_cuda.lstm_direction_plain
    return lstm_cuda.lstm_bidirectional, lstm_cuda.lstm_bidirectional_plain


def k2_check(d, shape, got, again, want):
    """Shape, agreement with the plain version (atol K2_ATOL) and bitwise repeatability."""
    t, b, h = shape
    err = float((got - want).abs().max())
    if got.shape != (t, b, d * h) or not err <= K2_ATOL:
        raise AssertionError(f"K2 D={d} {shape}: shape {tuple(got.shape)}, max abs err "
                             f"{err} > {K2_ATOL}")
    if not torch.equal(got, again):
        raise AssertionError(f"K2 D={d} {shape}: two calls differ")
    return err


def phase_k2(device):
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.ops import lstm_cuda

    g = torch.Generator().manual_seed(2)
    sms, smem = lstm_cuda.device_limits(torch.cuda.current_device())
    rows = []
    with strict_fp32():
        for d in (1, 2):
            kernel, plain = k2_fns(d)
            for t, b, h in K2_TEST_SHAPES:  # the JAX kernel test's inputs
                xp = torch.randn(t, b, d * 4 * h, generator=g).to(device)
                w_hh = (0.2 * torch.randn(d, 4 * h, h, generator=g)).to(device)
                w_hh = w_hh[0] if d == 1 else w_hh
                got, again = kernel(xp, w_hh, h), kernel(xp, w_hh, h)
                want = plain(xp, w_hh, h)
                torch.cuda.synchronize()
                err = k2_check(d, (t, b, h), got, again, want)
                plan = lstm_cuda.plan_layer(t, b, h, d, sms, smem)
                rows.append({"directions": d, "shape": [t, b, h], "max_abs_err": err,
                             "bitwise_repeatable": True, "plan": plan._asdict()})
                log(f"K2 lstm_layer {rows[-1]}")
        for t, b, h in [K2_FLOOR_SHAPE] + K2_PATH_SHAPES:
            # torch-default layers (U(+-1/sqrt(H))) on N(0, 1) input of the inner layers'
            # width 2H, as CaMN/DisCo's LSTMs see it
            bound = h ** -0.5
            u = lambda *shape: ((torch.rand(*shape, generator=g) * 2 - 1) * bound).to(device)
            w_ih, w_hh, b_ih, b_hh = u(2, 4 * h, 2 * h), u(2, 4 * h, h), u(2, 4 * h), u(2, 4 * h)
            x = torch.randn(t, b, 2 * h, generator=g).to(device)
            for d in (1, 2):
                kernel, plain = k2_fns(d)
                wi = w_ih[0] if d == 1 else w_ih.reshape(8 * h, 2 * h)
                bias = (b_ih[0] + b_hh[0]) if d == 1 else (b_ih + b_hh).reshape(8 * h)
                wh = w_hh[0] if d == 1 else w_hh
                xp = torch.matmul(x, wi.T) + bias
                got, again = kernel(xp, wh, h), kernel(xp, wh, h)
                want = plain(xp, wh, h)
                exact = plain(xp.double(), wh.double(), h)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K2 D={d} {(t, b, h)}: two calls differ")
                err = float((got - want).abs().max())
                err64 = float((got.double() - exact).abs().max())
                plain_err64 = float((want.double() - exact).abs().max())
                if not err64 <= 2 * plain_err64 + 1e-6:
                    raise AssertionError(f"K2 D={d} {(t, b, h)}: kernel off float64 by {err64}, "
                                         f"plain fp32 by {plain_err64}")
                plan = lstm_cuda.plan_layer(t, b, h, d, sms, smem)
                row = {"directions": d, "shape": [t, b, h], "max_abs_err": err,
                       "kernel_err_vs_fp64": err64, "plain_err_vs_fp64": plain_err64,
                       "bitwise_repeatable": True, "plan": plan._asdict()}
                row["kernel_ms"] = cuda_ms(lambda: kernel(xp, wh, h), reps=10)
                row["us_per_step"] = 1e3 * row["kernel_ms"] / t
                row["bound_ms"], row["bound_by"] = k2_bound(t, b, h, d)
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
                if (t, b, h) != K2_FLOOR_SHAPE:
                    row["plain_ms"] = cuda_ms(lambda: plain(xp, wh, h), reps=3, warmup=1)
                    # the yardstick computes projection + recurrence, so beside it matmul + K2
                    cudnn = torch.nn.LSTM(2 * h, h, bidirectional=d == 2).to(device)
                    with torch.no_grad():
                        for k in range(d):
                            sfx = "_reverse" if k else ""
                            for name, w in (("weight_ih_l0", w_ih), ("weight_hh_l0", w_hh),
                                            ("bias_ih_l0", b_ih), ("bias_hh_l0", b_hh)):
                                getattr(cudnn, name + sfx).copy_(w[k])
                        lib_out, _ = cudnn(x)
                        row["library_max_abs_diff"] = float((lib_out - got).abs().max())
                        row["library_ms"] = cuda_ms(lambda: cudnn(x), reps=10)
                    row["projection_plus_kernel_ms"] = cuda_ms(
                        lambda: kernel(torch.matmul(x, wi.T) + bias, wh, h), reps=10)
                rows.append(row)
                log(f"K2 lstm_layer {row}")
    return rows


def run_tiny_lstm(device):
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig

    # the SMALL config of tests/test_models_camn_disco.py
    small = dict(audio_f=128, speaker_f=8, speaker_dims=4, hidden_size=48, n_layer=2,
                 pose_dims=258, body_dims=78, hands_dims=180, dropout_prob=0.0)
    audio = torch.rand(2, 16000, generator=torch.Generator().manual_seed(8)) * 2 - 1
    spk = torch.tensor([[0], [3]])
    seed = torch.rand(2, 14, 258, generator=torch.Generator().manual_seed(9)) * 2 - 1
    camn = CamnAudioModel(CamnAudioConfig(**small), seed=10, device=device)
    disco = DiscoAudioModel(DiscoAudioConfig(**small), seed=11, device=device)
    outs = {}
    for name, model, kw in (("camn", camn, {}), ("camn_seed", camn, {"seed_motion": seed}),
                            ("disco", disco, {})):
        kw = {k: v.to(device) for k, v in kw.items()}
        out = model(audio.to(device), spk.to(device), **kw)
        outs.update({f"{name}.{k}": v.cpu() for k, v in out.items()})
    return outs


def phase_lstm_parity():
    cpu, gpu = run_tiny_lstm("cpu"), run_tiny_lstm("cuda")
    worst = {}
    for k in cpu:
        atol = PARITY_ROT_ATOL if k.endswith("motion_axis_angle") else PARITY_ATOL
        worst[k] = float((cpu[k] - gpu[k]).abs().max())
        if cpu[k].shape != gpu[k].shape or not worst[k] <= atol:
            raise AssertionError(f"LSTM parity: {k} differs by {worst[k]} > {atol}")
    log(f"parity CPU vs GPU (tiny CaMN/DisCo, full fp32): max abs err {worst}")


def phase_lstm_path(name, card, counted_bs=8, timed=(8, 64)):
    """Run CaMN or DisCo at full width on ``counted_bs`` x 28.4 s once, checking the
    outputs and the K2 launch count, then time one warm call per batch in ``timed``."""
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda

    model_cls, cfg_cls, want_launches = {
        "camn": (CamnAudioModel, CamnAudioConfig, 8),
        "disco": (DiscoAudioModel, DiscoAudioConfig, 4)}[name]
    model = model_cls(cfg_cls(), seed=3, device="cuda")
    g = torch.Generator().manual_seed(4)

    def generate(bs):
        audio = (torch.rand(bs, LSTM_SAMPLES, generator=g) * 2 - 1).cuda()
        spk = torch.zeros((bs, 1), dtype=torch.long, device="cuda")
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = model(audio, spk)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t_start

    lstm_cuda.launches = vq_cuda.launches = 0
    out, wall = generate(counted_bs)
    launches = lstm_cuda.launches
    expect = {"motion": (counted_bs, LSTM_FRAMES, 258),
              "motion_axis_angle": (counted_bs, LSTM_FRAMES, 165)}
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape or not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{name} path: {k} {tuple(out[k].shape)} (want {shape}), "
                                 f"finite={bool(torch.isfinite(out[k]).all())}")
    if launches != want_launches or vq_cuda.launches != 0:
        raise AssertionError(f"{name} path: K2 launched {launches} times (want "
                             f"{want_launches}), K1 {vq_cuda.launches} (want 0)")
    log(f"{name} path: batch {counted_bs} x {LSTM_SECONDS} s -> {expect}, finite; K2 launches "
        f"{launches}; first call {wall:.3f} s")
    for bs in timed:
        generate(bs)  # warm-up
        lstm_cuda.launches = 0
        torch.cuda.reset_peak_memory_stats()
        _, wall = generate(bs)
        result = {"model": name, "batch": bs, "seconds": LSTM_SECONDS, "wall_s": wall,
                  "realtime_factor": bs * LSTM_SECONDS / wall, "k2_launches": lstm_cuda.launches,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
        log(f"{name} path timed: {json.dumps(result)}")
    return launches


def write_wav(path: Path, seconds: int = 3):
    t = np.arange(seconds * 16000) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 1.5 * t)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes((x * 32767).astype("<i2").tobytes())


def run_cli(module: str, want: dict):
    """Run ``python -m <module> --random_init`` on a 3 s WAV and check the saved npz."""
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir, out_dir = Path(tmp, "audio"), Path(tmp, "out")
        audio_dir.mkdir()
        write_wav(audio_dir / "clip.wav")
        r = subprocess.run(
            [sys.executable, "-m", module, "--random_init", "--audio_folder", str(audio_dir),
             "--save_folder", str(out_dir), "--device", "cuda"],
            cwd=str(HERE), capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{module} failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        out = np.load(out_dir / "clip_output.npz")
        for k, shape in want.items():
            if out[k].shape != shape or not np.isfinite(out[k]).all():
                raise AssertionError(f"{module}: {k} {out[k].shape}, want {shape}")
        log(f"CLI {module}: {r.stdout.strip()}")


def phase_cli():
    frames = 3 * 30
    run_cli("pantomatrix_tpu_torch.cli.test_emage",
            {"poses": (frames, 165), "expressions": (frames, 100), "trans": (frames, 3)})


def main():
    t_all = time.time()
    # 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs the port on an NVIDIA GPU")
    card = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    import_port()
    from pantomatrix_tpu_torch.ops import build

    # 2. build
    t0 = time.time()
    libs = build.build(["vq_nearest_code", "lstm_sequence"])
    log(f"build: {time.time() - t0:.1f} s -> {[str(p.relative_to(HERE)) for p in libs.values()]}")
    for p in libs.values():
        log(Path(f"{p}.log").read_text().strip() if Path(f"{p}.log").exists() else "")

    # 3. K1 against its plain version
    k1_rows = phase_k1("cuda")
    # 4. parity at the tiny config
    phase_parity()
    # 5. main path at full width (counts K1 launches)
    main_launches = phase_main_path("cuda", card)
    # 6. CLI
    phase_cli()
    # 7. K2 against its plain version
    k2_rows = phase_k2("cuda")
    # 8. parity at the tiny CaMN/DisCo configs
    phase_lstm_parity()
    # 9-10. CaMN and DisCo at full width (each counts K2 launches)
    k2_launches = {name: phase_lstm_path(name, card) for name in ("camn", "disco")}
    # 11. CaMN CLI: 3 s at 15 fps, saved upsampled to 30 fps
    run_cli("pantomatrix_tpu_torch.cli.test_camn", {"poses": (90, 165)})

    head = next(r for r in k1_rows if tuple(r["shape"]) == K1_HEADLINE)
    kernels = [{
        "name": "vq_nearest_code",
        "route": "cuda",
        "source": "pantomatrix_tpu_torch/csrc/vq_nearest_code.cu",
        "replaces": "pantomatrix_tpu/ops/vq_pallas.py:27",
        "launches": main_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k1_rows),
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "call_ms": head["call_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "bound_fp32_ms": head["bound_fp32_ms"],
        "share_of_bound": head["share_of_bound"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "by_shape": k1_rows,
    }]
    head = next(r for r in k2_rows
                if tuple(r["shape"]) == K2_HEADLINE and r["directions"] == 2)
    kernels.append({
        "name": "lstm_sequence",
        "route": "cuda",
        "directions": 2,
        "source": "pantomatrix_tpu_torch/csrc/lstm_sequence.cu",
        "replaces": "pantomatrix_tpu/ops/lstm_pallas.py:30",
        "launches": k2_launches["camn"],
        "launches_by_path": k2_launches,
        "max_abs_err": max(r["max_abs_err"] for r in k2_rows),
        "ms": head["kernel_ms"],
        "kernel_ms": head["kernel_ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "by_shape": k2_rows,
    })
    log(f"total {time.time() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
