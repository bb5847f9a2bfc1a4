"""Smoke run of the PyTorch/CUDA port (pantomatrix_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

Phases, each of which raises on failure (nothing is caught):
  1. device: the card's name and power limit (nvidia-smi); no CUDA device -> error;
  2. build: compile the CUDA kernels of pantomatrix_tpu_torch/csrc with nvcc;
  3. K1 (VQ nearest-code search) against its plain PyTorch version on the card, at
     the test shapes and every shape the main path gives it; CUDA-event timings of the
     kernel, the plain version and torch.cdist(z, cb).argmin(-1) as a library yardstick;
  4. parity: a tiny EMAGE config through inference + decode on the CPU (plain K1) and
     on the card (the kernel), both in full float32;
  5. main path at full width (EmageAudioConfig(), reference tokenizer widths, random
     weights from a seed): batch 8 x 20 s through EmageAudioModel.inference and
     EmageVQModel.decode, counting K1 launches; then one timed call at batch 128 x 60 s;
  6. the CLI (python -m pantomatrix_tpu_torch.cli.test_emage --random_init) on a 3 s WAV.
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

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

K1_SHAPES = [
    # the kernel tests' shapes
    (512, 256, 256), (37, 16, 24), (640, 106, 256),
    # the main path's: batch 8 x 20 s (window, remainder window, final decode) ...
    (8 * 64, 256, 256), (8 * 60, 256, 256), (8 * 600, 256, 256),
    # ... and batch 128 x 60 s, whose final decode is the headline shape
    (128 * 64, 256, 256), (128 * 60, 256, 256), (128 * 1800, 256, 256),
]
K1_HEADLINE = (128 * 1800, 256, 256)
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
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
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


def k1_bound(n: int, d: int, k: int):
    """Least time for the search on an H100: each input read once and the indices
    written once, against 2*N*K*D FMA work plus the code norms and the N*K distances."""
    flops = 2.0 * n * k * d + 2.0 * k * d + 2.0 * n * k
    nbytes = 4.0 * (n * d + k * d + n)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


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
            got = vq_cuda.nearest_code(z, cb)
            want = vq_cuda.nearest_code_plain(z, cb)
            torch.cuda.synchronize()
            if got.shape != want.shape or got.dtype != torch.int32:
                raise AssertionError(f"K1 {shape}: {got.shape}/{got.dtype} vs {want.shape}")
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
            row = {"shape": [n, d, k], "mismatches": n_diff, "max_abs_err": float(gap.max())}
            if len(lead) == 1:
                zc, cbc = z.contiguous(), cb.contiguous()
                row["kernel_ms"] = cuda_ms(lambda: vq_cuda.nearest_code(zc, cbc))
                row["plain_ms"] = cuda_ms(lambda: vq_cuda.nearest_code_plain(zc, cbc))
                row["library_ms"] = cuda_ms(lambda: torch.cdist(zc, cbc).argmin(-1))
                row["bound_ms"], row["bound_by"] = k1_bound(n, d, k)
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
    from pantomatrix_tpu_torch.ops import vq_cuda

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
    vq_cuda.launches = 0
    dec, wall = generate(bs, seconds)
    launches = vq_cuda.launches
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


def phase_cli(device="cuda"):
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir, out_dir = Path(tmp, "audio"), Path(tmp, "out")
        audio_dir.mkdir()
        t = np.arange(3 * 16000) / 16000
        x = 0.3 * np.sin(2 * np.pi * 220 * t) * np.sin(2 * np.pi * 1.5 * t)
        with wave.open(str(audio_dir / "clip.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((x * 32767).astype("<i2").tobytes())
        r = subprocess.run(
            [sys.executable, "-m", "pantomatrix_tpu_torch.cli.test_emage", "--random_init",
             "--audio_folder", str(audio_dir), "--save_folder", str(out_dir),
             "--device", device],
            cwd=str(HERE), capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"CLI failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        out = np.load(out_dir / "clip_output.npz")
        frames = 3 * 30
        for k, width in (("poses", 165), ("expressions", 100), ("trans", 3)):
            if out[k].shape != (frames, width) or not np.isfinite(out[k]).all():
                raise AssertionError(f"CLI: {k} {out[k].shape}, want ({frames}, {width})")
        log(f"CLI: {r.stdout.strip()}")


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
    libs = build.build(["vq_nearest_code"])
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
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shape": head["shape"],
        "by_shape": k1_rows,
    }]
    log(f"total {time.time() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
