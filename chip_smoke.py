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
     EmageVQModel.decode, twice: the first call captures the window step's CUDA graph
     (its K1 count, with the capture's warm-up launches, is logged), the second replays
     it and is the one whose K1 launches are counted; then one timed call at batch
     128 x 60 s;
  6. the CLI (python -m pantomatrix_tpu_torch.cli.test_emage --random_init) on a 3 s WAV;
  7. K2 (the persistent LSTM layer kernel) against its plain PyTorch version on the card,
     for one direction (lstm_direction) and for both directions of a layer in one launch
     (lstm_bidirectional): at the test and edge shapes to atol 1e-5, and at the CaMN/DisCo
     path shapes (T = 421, B = 8, 16, 32 and 64, H = 512), cli.bench_train's and CaMN
     training's (T = 127 and 64, B = 64) and evaluation's (T = 960, B = 1, H = 512: a 64 s
     take at 15 fps) against a float64 run (no further from it than twice the plain fp32
     version + 1e-6); two calls must be bitwise equal. Each row gives the gate product
     its plan takes (ffma or the split-TF32 mma), the launches lstm_cuda.mma_launches
     counted (2 where the product is mma, else 0) and the kernel's largest difference
     from lstm_*_split_plain, the plain model of the mma arithmetic. CUDA-event timings
     of each layer launch and its us per step (with B = 1 as the per-step latency floor),
     the plain version and, as library yardsticks, cuDNN's torch.nn.LSTM(1024, 512) (one
     direction) and torch.nn.LSTM(1024, 512, bidirectional=True) for one layer, beside
     matmul projection + K2;
  8. parity: tiny CaMN and DisCo configs on the CPU (plain K2) and on the card;
  9. CaMN at full width (CamnAudioConfig(), random weights from a seed): batch 8 x 28.4 s
     once, checking shapes and 8 K2 launches (one per bidirectional layer), then timed
     calls at batch 8 and 64, each with its K2 launches on the tensor cores
     (lstm_cuda.mma_launches: 8 at batch 64, 0 at batch 8, as the plans take them);
 10. DisCo at full width, the same, with 4 K2 launches (4 and 0 on the tensor cores);
 11. the CaMN CLI (python -m pantomatrix_tpu_torch.cli.test_camn --random_init) on a 3 s WAV;
 12. bf16 serving (compute_dtype="bfloat16", and EMAGE's batched_wav) at full width:
     EMAGE at batch 8 x 20 s in bf16 with and without batched_wav (finite, network
     outputs bf16 and decoded outputs fp32, 11 K1 launches, decoded poses correlated
     with the fp32 run) and at 128 x 60 s (31 K1 launches); CaMN and DisCo at batch 8
     and 64 x 28.4 s in bf16 against fp32 (rot6d correlated > 0.98, 8 and 4 K2
     launches a forward); wall times of these runs, bf16 beside fp32, in turns, but for
     the benchmark cells' own (EMAGE 128 x 60 s and CaMN 64 x 28.4 s in bf16); the
     weights' cast and the LSTM x_proj upcast on the card; one EMAGE window
     in bf16 against fp32 on the same inputs (every network output correlated > 0.99,
     head indices agreeing on > 95% of frames outside near-ties of the random weights'
     logits, see head_agreement); the EMAGE and CaMN CLIs with --compute_dtype
     bfloat16. It also writes outputs/chip_smoke_bf16.json;
 13. the window step as a CUDA graph (models/emage_graph.py) against the eager step on
     the same inputs, at batch 8 and 128, in fp32, bf16 and bf16 with batched_wav
     features: fp32 within 1e-5, bf16 within one bf16 ulp, head indices equal, bitwise
     equality logged, K1 counted once per replay; CUDA-event ms per window of each; a
     float32 window's seed decoded from the heads' last seed_decode_frames (11) frames
     bitwise equal to the seed decoded from all 64, at 1, 8 and 128 rows; then the wall
     of EMAGE (inference + decode) with graphs against the eager loop, in turns, at
     8 x 20 s in each mode and at 128 x 60 s in fp32, with the device's idle share of the
     graph paths at 8 x 20 s (kernel time under torch.profiler over the unprofiled median
     wall);
 14. streaming: StreamingEmageGenerator at batch 1 against offline emage_inference
     (latents within 1e-5, head indices and frame count equal); a StreamingPool of 8
     uneven sessions (frame counts equal to offline, first-window latents correlated
     > 0.999 with the single stream, each session's translation continuing from its own
     previous chunk); the bench_stream protocol at N = 1 and 64 in fp32 and bf16;
 15. the daemon: MotionServer on 127.0.0.1, two MotionClients over HTTP with 3 s of
     audio each, frames as expected and finite, equal to an in-process StreamingPool;
 16. SequenceGenerator for CaMN and DisCo at batch 8 (8 and 4 K2 launches) and entry()
     at full width. Phases 13-16 write outputs/chip_smoke_serving.json;
 17. evaluation: a synthetic BEAT2 layout (speaker 2, 4 test takes of 64 s), a synthetic
     SMPL-X archive at the real archive's shapes (V = 10475, F = 20908, SMPLX_MODEL_PATH),
     a random AESKConv state dict as emage_evaltools/AESKConv_240_100.bin and full-width
     checkpoints of EMAGE (with its tokenizers), CaMN and DisCo; python -m
     pantomatrix_tpu_torch.cli.evaluate five times (emage from --beat2_root, emage
     --vq_roundtrip, camn, disco, and disco without the AESKConv file), each metrics.json
     with the JAX CLI's keys, finite, fgd_embedder "aeskconv" / "stats"; then in process,
     per 64 s take: CaMN 8 and DisCo 4 K2 launches, each family's motion against the
     same take through the same checkpoint on the CPU (plain K2) to 2e-3, EMAGE 33 K1
     launches (phase 3 holds K1 at their shapes, N = 64, 60 and 1920), the VQ round
     trip 4 K1 launches whose indices equal map2index's and whose motion matches the CPU
     (plain K1) to 2e-3 on rotations and 1e-4 on expressions and translation; generate
     seconds (first and warm), FK seconds and peak memory at V = 10475, and
     evaluate_clips on the card against the CPU (FGD, L1div, LVD, MSE within 1e-4
     relative, BC equal). It writes outputs/chip_smoke_eval.json;
 18. training: (a) K2 under autograd (ops/lstm_cuda.LstmLayerFunction) at the K2 test
     shapes, the CaMN training shape (64, 64, 512) and cli.bench_train's (127, 64, 512)
     (phase 19e): the forward bitwise equal to
     lstm_bidirectional, the x_proj and w_hh gradients equal to the plain version's
     autograd (1e-6) and no further from a float64 run than twice the plain fp32
     gradients plus 1e-6; CUDA-event ms of the forward, the recompute backward, a layer
     with its projection, and cuDNN's nn.LSTM forward and forward + backward; (b) one SGD
     step (iteration 1, TF32 off) of tiny CaMN, DisCo and EMAGE on the CPU and on the
     card: losses within 1e-5 relative, parameters 1e-4, BatchNorm buffers 1e-5; (c) 6
     Adam steps at the shipped learning rate on one fixed batch at full width,
     CamnAudioConfig() and DiscoAudioConfig() at 64 x 128 frames, EmageAudioConfig() at
     56 x 64 frames with random tokenizers, in fp32 and bf16: finite losses, the last
     below the first, K2 8 (CaMN) / 4 (DisCo) launches a step, K1 none; median ms a step,
     frames a second, peak memory; EMAGE also with gradient checkpointing (first-step
     losses within 1e-5, less memory); (d) the three train CLIs with --debug (and
     --random_vq) at the shipped configs on a synthetic BEAT2 with the device-resident
     loader, a resume of the CaMN run from its last.bin continuing at step 5, and the
     device-resident batches bitwise equal to the host loader's on the card. It writes
     outputs/chip_smoke_train.json;
 19. tokenizer pretraining and data preparation: (a) a synthetic BEAT2 of 8 takes of 20 s
     (scripts/torch_make_synth_beat2.py's takes) and a synthetic SMPL-X archive at the real
     shapes; python's cli.preprocess index (64- and 128-frame clips), footcontact on the
     card and disco (the port's k-means); foot contact on the card equal to the CPU's but
     at frames whose float64 velocity lies within 1e-6 relative of the threshold (counted
     and reported); (b) one SGD step of a tiny tokenizer suite with dead-code restarts
     from the same usage state on the CPU and on the card: losses 1e-5 relative,
     parameters 1e-4, dead masks equal, usage within 1e-7; (c) 10 Adam steps at the
     shipped learning rate of the five tokenizers at init_vq_suite widths on one batch of
     64 x 64 frames, restarts on, in fp32 and bf16: finite losses, the last below the
     first, K1 and K2 never launched; median ms a step, peak memory, kernels a step and
     device ms of one profiled step; (d) cli.train_emage_vq --debug on the corpus on the
     card: the export's five directories, no K1 launch in its validation (the round trip
     decodes from indices, as the JAX CLI's does; launches_vq_val = 0), the exported
     suite decoding bitwise as its best-val state, then cli.train_emage --vq_path on the
     export, where K1 launches exactly once per val batch per validation (the face decoded
     from its latent head; launches_train_emage_val), and K1 against its plain version at
     that run's val batch shapes; (e) cli.bench_train for the three
     families in fp32 and bf16 at --k 2 --repeats 1: each line parses, mfu < 1, K2 8
     (CaMN) / 4 (DisCo) / 0 launches a step, K1 none. It writes
     outputs/chip_smoke_pretrain.json;
 20. visualization: (a) a synthetic SMPL-X archive at the real shapes whose faces join
     neighbouring vertices of closed surfaces, and the g++ builds of native/rasterizer.cpp
     and native/jpeg.cpp; (b) cli.test_emage and cli.test_camn --random_init
     --visualization on one 20 s take on the card (600-frame skeleton AVIs read back; K1
     and K2 launches counted, CaMN 8); (c) render_one_sequence (pred | GT) and
     render_one_sequence_with_face of the take with its WAV: the FK vertices against the
     CPU's (1e-4), the skeleton and mesh frames from the card's FK against the CPU's
     (differing pixels counted, at most 0.1%), the JPEG coefficients of the card's DCT
     against the CPU's (only +-1 at rounding near-ties, at most 1e-4 of them), each AVI
     read back (600 frames, 320,000 audio samples, idx1 consistent); (d) ms a frame of
     the FK, the drawing, the rasterizer, the JPEG transform on the card (and its copies
     in and out) and its Huffman coding on the host, and the AVI writing; frames a second
     end to end; host CPUs; peak host RSS and device memory. It writes
     outputs/chip_smoke_viz.json;
 21. multi-process training (train/mesh.py over torch.distributed): (a) world 1 over
     NCCL on the card: in process, 3 SGD steps (TF32 off) of the phase-18c CaMN and EMAGE
     cells without a process group, on the world-1 mesh, and without again: the first
     step's losses bitwise equal, the rest within twice the run-to-run spread of the
     single-process runs plus 4 ulps (the card's backward kernels are not deterministic),
     step ms of each, K2 launches a CaMN step on the rank (8), the gradient all-reduce's
     bytes and CUDA-event ms; then train_camn under torchrun and train_emage with the
     PANTO_* variables at world 1 against the same CLI without a process group (3 SGD
     steps at the full-width cells, tests/test_torch_multiprocess.py's bounds); (b) the
     tiny EMAGE (plain and FSDP, with process 0's test pass) and DisCo CLI runs of that
     test file (tests/_torch_mp_runs.py), two processes sharing the card over gloo (NCCL
     with two cards or more) against one, process 1 writing no checkpoint; (c)
     dryrun_multichip(2, device="cuda"); (a)'s CLI runs, (b) and (c) run at once. It
     writes outputs/chip_smoke_multiprocess.json;
 22. the last gaps: (a) cli.bench_train for CaMN fp32 (64 x 128, --k 2 --repeats 1) under
     torch.distributed.run --nproc_per_node 1, one process over NCCL: its line beside
     phase 19e's in-process one, processes 1, K2 8 a step, mfu < 1, k2_forward_flops = 8
     launches x lstm_cuda.layer_flops(127, 64, 512); (b) cli.bench_train for DisCo fp32 at
     8 x 32 under --nproc_per_node 2, two processes sharing the card over gloo: processes
     2, cards 1, K2 4 a step on each, a finite last_loss; (c) the EMAGE train-step ladder of
     scripts/torch_profile_train.py (its run_ladder, without the profiled step) in fp32 at
     8 x 64 frames, --k 1 --repeats 1, every rung: finite, L5's first-step losses within
     1e-6 relative of the shipped step's, no K1 launch; (d) the
     Euler-angle, quaternion-algebra and random-rotation helpers on the card against the
     CPU within 1e-5, all 12 conventions. (a) runs alone, then (b) while (c) and (d) run.
     It writes outputs/chip_smoke_gaps.json.
Depth cut to keep the whole run inside its limit (with phase 22): phase 13 times the
128 x 60 s calls in 2 turns (3 before) and profiles only the graph paths at 8 x 20 s (all
six, and the graph paths at 128 x 60 s, before), phase 14 sweeps bench_stream at N = 1
and 64 (1, 8, 32, 64 before), phase 17 runs its five CLI runs at once, phase 18d its three
families' CLI runs at once and phase 21 its world-1 CLIs beside (b) and (c) (one after
another before; their walls are concurrent ones), phase 18c takes 6 Adam steps a cell (12
before), phase 19c 10 VQ steps (20 before). Every check keeps its bound and every kernel
shape stays checked. It ends with a JSON line of per-kernel numbers, the nvidia-smi line, and last
{"ok": true, "device": {...}}. It imports nothing of JAX or of pantomatrix_tpu.
"""
from __future__ import annotations

import json
import re
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
    # ... the window steps' and remainder's seed decode over the heads' last 11 frames
    # (models/emage.seed_decode_frames) at batch 128, 8 and 1
    (128 * 11, 256, 256), (8 * 11, 256, 256), (11, 256, 256),
    # evaluation at batch 1: the AR window and remainder window of a take, and the VQ
    # round trip and final decode of a 64 s take
    (64, 256, 256), (60, 256, 256), (1920, 256, 256),
    # train_emage's validation at the shipped train_bs 56 x 64 frames (the face decoded
    # from its latent head); phase 19d also checks the val batches of its own run
    (56 * 64, 256, 256),
]
K1_HEADLINE = (128 * 1800, 256, 256)
# (T, B, H): the K2 tests' shapes and edge shapes of the launch plan (one row, ragged
# batch groups, more rows than one pass of the grid), then CaMN/DisCo's at 28.4 s (421
# frames at 15 fps) and evaluation's 64 s take at batch 1 (960 frames), and B = 1 for the
# per-step latency floor
K2_TEST_SHAPES = [(12, 8, 128), (9, 5, 96), (20, 16, 512),
                  (9, 1, 48), (9, 13, 96), (12, 128, 128), (5, 256, 512),
                  # the tensor-core product: a ragged second tile (24 of 32 rows), H = 128
                  # in 25-row CTAs (two 16-wide k blocks a half, six warps idle), and
                  # H = 1024; at H = 48, whose halves are no whole 32-float segments for
                  # the TMA copies of h, FFMA
                  (5, 96, 512), (9, 200, 128), (9, 256, 48), (5, 32, 1024)]
# cli.bench_train's CaMN/DisCo batch: 64 clips x 128 frames at 15 fps, 127 LSTM steps from
# the WavEncoder (wav_encoder_out_len)
K2_BENCH_SHAPE = (127, 64, 512)
# B = 16 and 32 beside 8 and 64, where the gate product changes (ops/lstm_cuda.plan_layer),
# and CaMN's training shape (TRAIN_K2_SHAPE)
K2_PATH_SHAPES = [(421, 8, 512), (421, 16, 512), (421, 32, 512), (421, 64, 512),
                  (960, 1, 512), K2_BENCH_SHAPE, (64, 64, 512)]
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
            row = k1_check(z, cb, device)
            if len(lead) == 1:
                zc, cbc = z.contiguous(), cb.contiguous()
                kernel = lambda: vq_cuda.nearest_code(zc, cbc)
                row["kernel_ms"] = graph_ms(kernel)
                row["eager_ms"] = eager_ms(kernel)
                row["call_ms"] = cuda_ms(kernel)
                row["plain_ms"] = graph_ms(lambda: vq_cuda.nearest_code_plain(zc, cbc))
                row["library_ms"] = graph_ms(lambda: torch.cdist(zc, cbc).argmin(-1))
                row["bound_ms"], row["bound_by"], row["bound_fp32_ms"] = k1_bound(*row["shape"])
                row["share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            rows.append(row)
            log(f"K1 vq_nearest_code {row}")
    return rows


def k1_check(z, cb, device) -> dict:
    """K1 on ``z`` (..., D) and ``cb`` (K, D) against its plain version: int32 indices of
    the right shape, two calls bitwise equal, and rows that differ only genuine near-ties
    (their two codes' distances within 1e-5 relative in float64) and under 0.1% of rows."""
    from pantomatrix_tpu_torch.ops import vq_cuda

    k, d = cb.shape
    shape = tuple(z.shape[:-1]), d, k
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
    return {"shape": [n, d, k], "mismatches": n_diff, "max_abs_err": float(gap.max()),
            "split_model_mismatches": int((got != model).sum()),
            "bitwise_repeatable": True,
            "plan": {"cluster": plan.cluster, "ctas": plan.ctas,
                     "codes_per_cta": plan.codes_per_cta,
                     "smem_bytes": plan.smem_bytes}}


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
    """Generate ``counted`` = (batch, seconds) twice, checking the outputs and the K1
    launch count of the second (warm) call, then time one call at ``timed`` after a
    warm-up."""
    from pantomatrix_tpu_torch.cli.test_emage import load_models
    from pantomatrix_tpu_torch.models.emage import _select_decode_inputs
    from pantomatrix_tpu_torch.models.emage_graph import WARMUP_CALLS
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
    # the first call captures the window step's CUDA graph (its warm-up calls launch K1
    # eagerly); the main path is the next call, which replays it
    vq_cuda.launches = lstm_cuda.launches = 0
    _, first_wall = generate(bs, seconds)
    first_launches = vq_cuda.launches
    if first_launches != rounds + 2 + WARMUP_CALLS:
        raise AssertionError(f"main path first call: K1 launched {first_launches} times, want "
                             f"{rounds + 2 + WARMUP_CALLS} (with the capture's warm-up)")
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
        f"({rounds} graph-replayed windows + remainder + final decode); first call (graph "
        f"capture) {first_wall:.3f} s with {first_launches} K1 launches; warm call {wall:.3f} s")

    bs, seconds = timed
    generate(bs, seconds)  # warm-up
    vq_cuda.launches = 0
    torch.cuda.reset_peak_memory_stats()
    _, wall = generate(bs, seconds)
    result = {"batch": bs, "seconds": seconds, "wall_s": wall,
              "realtime_factor": bs * seconds / wall, "k1_launches": vq_cuda.launches,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
    log(f"main path timed: {json.dumps(result)}")
    want = (seconds * 30 - cfg.seed_frames) // (cfg.pose_length - cfg.seed_frames) + 2
    if result["k1_launches"] != want:
        raise AssertionError(f"main path {bs} x {seconds} s: K1 launched "
                             f"{result['k1_launches']} times, want {want}")
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


def k2_split_fn(d: int):
    """The plain model of K2's tensor-core arithmetic for a layer of ``d`` directions."""
    from pantomatrix_tpu_torch.ops import lstm_cuda

    return lstm_cuda.lstm_direction_split_plain if d == 1 else \
        lstm_cuda.lstm_bidirectional_split_plain


def k2_calls(kernel, plan, *args):
    """Two calls of ``kernel``, checking that ``lstm_cuda.mma_launches`` counts them
    exactly where ``plan`` takes the tensor-core product; returns both outputs and the
    count."""
    from pantomatrix_tpu_torch.ops import lstm_cuda

    before = lstm_cuda.mma_launches
    got, again = kernel(*args), kernel(*args)
    counted = lstm_cuda.mma_launches - before
    if counted != (2 if plan.product == "mma" else 0):
        raise AssertionError(f"K2 {plan}: mma_launches counted {counted} of 2 launches")
    return got, again, counted


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
                plan = lstm_cuda.plan_layer(t, b, h, d, sms, smem)
                got, again, counted = k2_calls(kernel, plan, xp, w_hh, h)
                want = plain(xp, w_hh, h)
                split = k2_split_fn(d)(xp, w_hh, h)
                torch.cuda.synchronize()
                err = k2_check(d, (t, b, h), got, again, want)
                rows.append({"directions": d, "shape": [t, b, h], "max_abs_err": err,
                             "bitwise_repeatable": True, "product": plan.product,
                             "mma_launches": counted,
                             "split_model_max_abs_diff": float((got - split).abs().max()),
                             "plan": plan._asdict()})
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
                plan = lstm_cuda.plan_layer(t, b, h, d, sms, smem)
                got, again, counted = k2_calls(kernel, plan, xp, wh, h)
                want = plain(xp, wh, h)
                exact = plain(xp.double(), wh.double(), h)
                split = k2_split_fn(d)(xp, wh, h)
                torch.cuda.synchronize()
                if not torch.equal(got, again):
                    raise AssertionError(f"K2 D={d} {(t, b, h)}: two calls differ")
                err = float((got - want).abs().max())
                err64 = float((got.double() - exact).abs().max())
                plain_err64 = float((want.double() - exact).abs().max())
                if not err64 <= 2 * plain_err64 + 1e-6:
                    raise AssertionError(f"K2 D={d} {(t, b, h)}: kernel off float64 by {err64}, "
                                         f"plain fp32 by {plain_err64}")
                row = {"directions": d, "shape": [t, b, h], "max_abs_err": err,
                       "kernel_err_vs_fp64": err64, "plain_err_vs_fp64": plain_err64,
                       "bitwise_repeatable": True, "product": plan.product,
                       "mma_launches": counted,
                       "split_model_max_abs_diff": float((got - split).abs().max()),
                       "plan": plan._asdict()}
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

    sms, smem = lstm_cuda.device_limits(torch.cuda.current_device())

    def want_mma(bs):  # every layer takes the tensor-core product where its plan does
        plan = lstm_cuda.plan_layer(LSTM_FRAMES, bs, model.config.hidden_size, 2, sms, smem)
        return want_launches if plan.product == "mma" else 0

    lstm_cuda.launches = lstm_cuda.mma_launches = vq_cuda.launches = 0
    out, wall = generate(counted_bs)
    launches = lstm_cuda.launches
    expect = {"motion": (counted_bs, LSTM_FRAMES, 258),
              "motion_axis_angle": (counted_bs, LSTM_FRAMES, 165)}
    for k, shape in expect.items():
        if tuple(out[k].shape) != shape or not bool(torch.isfinite(out[k]).all()):
            raise AssertionError(f"{name} path: {k} {tuple(out[k].shape)} (want {shape}), "
                                 f"finite={bool(torch.isfinite(out[k]).all())}")
    if launches != want_launches or vq_cuda.launches != 0 or \
            lstm_cuda.mma_launches != want_mma(counted_bs):
        raise AssertionError(f"{name} path: K2 launched {launches} times (want "
                             f"{want_launches}), {lstm_cuda.mma_launches} on the tensor cores "
                             f"(want {want_mma(counted_bs)}), K1 {vq_cuda.launches} (want 0)")
    log(f"{name} path: batch {counted_bs} x {LSTM_SECONDS} s -> {expect}, finite; K2 launches "
        f"{launches} ({lstm_cuda.mma_launches} on the tensor cores); first call {wall:.3f} s")
    for bs in timed:
        generate(bs)  # warm-up
        lstm_cuda.launches = lstm_cuda.mma_launches = 0
        torch.cuda.reset_peak_memory_stats()
        _, wall = generate(bs)
        result = {"model": name, "batch": bs, "seconds": LSTM_SECONDS, "wall_s": wall,
                  "realtime_factor": bs * LSTM_SECONDS / wall, "k2_launches": lstm_cuda.launches,
                  "k2_mma_launches": lstm_cuda.mma_launches,
                  "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "card": card}
        if lstm_cuda.mma_launches != want_mma(bs):
            raise AssertionError(f"{name} path timed: {result} (want {want_mma(bs)} K2 "
                                 f"launches on the tensor cores)")
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


def run_cli(module: str, want: dict, flags=()):
    """Run ``python -m <module> --random_init [flags]`` on a 3 s WAV and check the saved
    npz."""
    with tempfile.TemporaryDirectory() as tmp:
        audio_dir, out_dir = Path(tmp, "audio"), Path(tmp, "out")
        audio_dir.mkdir()
        write_wav(audio_dir / "clip.wav")
        r = subprocess.run(
            [sys.executable, "-m", module, "--random_init", "--audio_folder", str(audio_dir),
             "--save_folder", str(out_dir), "--device", "cuda", *flags],
            cwd=str(HERE), capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            raise RuntimeError(f"{module} failed ({r.returncode}):\n{r.stdout}\n{r.stderr}")
        out = np.load(out_dir / "clip_output.npz")
        for k, shape in want.items():
            if out[k].shape != shape or not np.isfinite(out[k]).all():
                raise AssertionError(f"{module}: {k} {out[k].shape}, want {shape}")
        log(f"CLI {module} {' '.join(flags)}: {r.stdout.strip()}")


def phase_cli():
    frames = 3 * 30
    run_cli("pantomatrix_tpu_torch.cli.test_emage",
            {"poses": (frames, 165), "expressions": (frames, 100), "trans": (frames, 3)})


BF16_EMAGE_CELLS = [(8, 20), (128, 60)]
BF16_LSTM_BATCHES = [8, 64]
BF16_REPS = 5


def corr(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(torch.corrcoef(torch.stack([a, b]))[0, 1])


def wall_stats(walls):
    return {"median": float(np.median(walls)), "min": float(min(walls)),
            "max": float(max(walls)), "n": len(walls)}


def timed_in_turns(calls: dict, reps: int = BF16_REPS) -> dict:
    """Host wall seconds of each call (ending in a synchronize), one warm-up each, then
    ``reps`` rounds that take the calls in turns (a b c, c b a, ...)."""
    names = list(calls)
    for name in names:
        calls[name]()
    walls = {name: [] for name in names}
    for r in range(reps):
        for name in (names if r % 2 == 0 else names[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            calls[name]()
            torch.cuda.synchronize()
            walls[name].append(time.perf_counter() - t0)
    return {name: wall_stats(w) for name, w in walls.items()}


def cast_cost(module, reps: int = 5) -> dict:
    """What casting ``module``'s weights to bf16 costs each time: host wall ms of
    ``cast_floating`` (ending in a synchronize), and of ``cast_once`` finding its kept
    copy valid."""
    from pantomatrix_tpu_torch.utils.precision import cast_floating, cast_once

    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cast_floating(module, torch.bfloat16)
        torch.cuda.synchronize()
        walls.append(1e3 * (time.perf_counter() - t0))
    cast_once(module, torch.bfloat16)
    kept = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cast_once(module, torch.bfloat16)
        kept.append(1e3 * (time.perf_counter() - t0))
    n_tensors = sum(1 for _ in module.parameters()) + sum(1 for _ in module.buffers())
    n_bytes = sum(t.numel() * t.element_size() for t in module.parameters())
    return {"cast_floating_ms": float(np.median(walls)),
            "cast_once_kept_ms": float(np.median(kept)), "tensors": n_tensors,
            "fp32_param_bytes": n_bytes}


def head_agreement(want: torch.Tensor, got: torch.Tensor) -> dict:
    """How often the head's argmax over the codebook logits agrees between an fp32
    (``want``) and a bf16 (``got``) run: over all frames, and outside near-ties, where a
    frame whose two argmaxes' fp32 logits differ by less than 2^-6 of the row's largest
    |logit| (about two bf16 ulps there) counts as agreeing."""
    want = want.float()
    a32, a16 = want.argmax(-1, keepdim=True), got.float().argmax(-1, keepdim=True)
    gap = (want.gather(-1, a32) - want.gather(-1, a16)).squeeze(-1)
    tie = gap < 2.0 ** -6 * want.abs().amax(-1)
    same = (a32 == a16).squeeze(-1)
    return {"all": float(same.float().mean()),
            "outside_near_ties": float((same | tie).float().mean()),
            "near_tie_flips": int((~same & tie).sum()),
            "other_flips": int((~same & ~tie).sum())}


def phase_bf16(card):
    """12. bf16 serving at full width; see the module docstring."""
    from pantomatrix_tpu_torch.cli.test_emage import load_models
    from pantomatrix_tpu_torch.models import emage
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig
    from pantomatrix_tpu_torch.models.emage import PARTS, _select_decode_inputs
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda
    from pantomatrix_tpu_torch.utils.precision import cast_floating

    bf16 = torch.bfloat16
    result = {"card": card}
    model, vq = load_models(None, True, "cuda")
    cfg = model.config
    g = torch.Generator().manual_seed(12)

    # counted AR runs
    def generate(audio, spk, **mode):
        out = model.inference(audio, spk, vq, **mode)
        dec = vq.decode(**_select_decode_inputs(cfg, out), get_global_motion=True,
                        ref_trans=torch.zeros(1, 3, device="cuda"))
        torch.cuda.synchronize()
        return out, dec

    emage_inputs = {}
    modes = {"fp32": {}, "bf16": {"compute_dtype": "bfloat16"},
             "bf16_batched_wav": {"compute_dtype": "bfloat16", "batched_wav": True}}
    result["emage_runs"] = []
    for bs, seconds in BF16_EMAGE_CELLS:
        audio = (torch.rand(bs, seconds * 16000, generator=g) - 0.5).cuda()
        spk = torch.zeros((bs, 1), dtype=torch.long, device="cuda")
        emage_inputs[(bs, seconds)] = audio, spk
        frames = seconds * 30
        rounds, remain = divmod(frames - cfg.seed_frames, cfg.pose_length - cfg.seed_frames)
        want_k1 = rounds + int(remain > cfg.seed_frames) + 1  # windows, remainder, decode
        ref = None
        for name, mode in modes.items():
            if (bs, seconds) != BF16_EMAGE_CELLS[0] and name != "bf16":
                continue  # at 128 x 60 s: the bf16 path only (fp32 is phase 5's)
            generate(audio, spk, **mode)  # captures this mode's window graph
            vq_cuda.launches = lstm_cuda.launches = 0
            out, dec = generate(audio, spk, **mode)
            launches = vq_cuda.launches
            net_dtype = bf16 if "compute_dtype" in mode else torch.float32
            bad = [k for k, v in out.items() if v.dtype != net_dtype]
            bad += [k for k in ("motion_axis_angle", "expression", "trans")
                    if dec[k].dtype != torch.float32 or not bool(torch.isfinite(dec[k]).all())
                    or dec[k].shape[:2] != (bs, frames)]
            if bad or launches != want_k1 or lstm_cuda.launches != 0:
                raise AssertionError(f"bf16 EMAGE {name} {bs} x {seconds} s: bad outputs {bad}, "
                                     f"K1 launches {launches} (want {want_k1}), K2 "
                                     f"{lstm_cuda.launches}")
            row = {"mode": name, "batch": bs, "seconds": seconds, "k1_launches": launches}
            if name == "fp32":
                ref = dec
            elif ref is not None:
                row["poses_corr_vs_fp32"] = corr(dec["motion_axis_angle"], ref["motion_axis_angle"])
                row["trans_corr_vs_fp32"] = corr(dec["trans"], ref["trans"])
            result["emage_runs"].append(row)
            log(f"bf16 serving: EMAGE {row}")
        del out, dec, ref

    # CaMN and DisCo, bf16 against fp32
    lstm_models = {"camn": (CamnAudioModel(CamnAudioConfig(), seed=3), 8),
                   "disco": (DiscoAudioModel(DiscoAudioConfig(), seed=3), 4)}
    lstm_inputs = {}
    result["lstm_runs"] = []
    for name, (m, want_k2) in lstm_models.items():
        for bs in BF16_LSTM_BATCHES:
            audio = lstm_inputs.setdefault(
                bs, ((torch.rand(bs, LSTM_SAMPLES, generator=g) * 2 - 1).cuda(),
                     torch.zeros((bs, 1), dtype=torch.long, device="cuda")))
            want = m(*audio)
            lstm_cuda.launches = vq_cuda.launches = 0
            got = m(*audio, compute_dtype="bfloat16")
            torch.cuda.synchronize()
            launches = lstm_cuda.launches
            c = corr(got["motion"], want["motion"])
            ok = all(got[k].dtype == torch.float32 and bool(torch.isfinite(got[k]).all())
                     for k in ("motion", "motion_axis_angle"))
            if not ok or c <= 0.98 or launches != want_k2 or vq_cuda.launches != 0:
                raise AssertionError(f"bf16 {name} {bs} x {LSTM_SECONDS} s: rot6d corr {c}, "
                                     f"fp32 finite outputs {ok}, K2 launches {launches} "
                                     f"(want {want_k2}), K1 {vq_cuda.launches}")
            row = {"model": name, "batch": bs, "rot6d_corr_vs_fp32": c,
                   "axis_angle_corr_vs_fp32": corr(got["motion_axis_angle"],
                                                   want["motion_axis_angle"]),
                   "k2_launches": launches}
            result["lstm_runs"].append(row)
            log(f"bf16 serving: {row}")

    # wall times, bf16 beside fp32, in turns, where no benchmark cell takes them
    timings = []
    for (bs, seconds), reps in zip(BF16_EMAGE_CELLS, (BF16_REPS, 3)):
        audio, spk = emage_inputs[(bs, seconds)]
        # at 128 x 60 s fp32 only: bf16 there is emage-offline-bf16 (BENCHMARK.json)
        calls = {name: (lambda mode=mode: generate(audio, spk, **mode))
                 for name, mode in modes.items()
                 if (bs, seconds) == BF16_EMAGE_CELLS[0] or name == "fp32"}
        for name, stats in timed_in_turns(calls, reps).items():
            timings.append({"cell": f"EMAGE {bs} x {seconds} s", "mode": name, "wall_s": stats,
                            "realtime_factor": bs * seconds / stats["median"]})
    for name, (m, _) in lstm_models.items():
        for bs in BF16_LSTM_BATCHES:
            audio = lstm_inputs[bs]

            def call(dt=None, m=m, audio=audio):
                m(*audio, compute_dtype=dt)
            calls = {"fp32": call, "bf16": lambda: call("bfloat16")}
            if (name, bs) == ("camn", 64):  # bf16 there is camn-offline-bf16
                del calls["bf16"]
            for mode, stats in timed_in_turns(calls).items():
                timings.append({"cell": f"{name} {bs} x {LSTM_SECONDS} s", "mode": mode,
                                "wall_s": stats, "realtime_factor": bs * LSTM_SECONDS
                                / stats["median"]})
    for row in timings:
        log(f"bf16 serving timed: {json.dumps(row)}")
    result["timings"] = timings

    # the weights' cast, against the calls it would be paid on, and the x_proj upcast
    walls = {(r["cell"], r["mode"]): r["wall_s"]["median"] for r in timings}
    costs = {"emage": cast_cost(model), "camn": cast_cost(lstm_models["camn"][0]),
             "disco": cast_cost(lstm_models["disco"][0])}
    for name, cost in costs.items():
        cells = [c for (c, mode) in walls if mode == "bf16" and c.lower().startswith(name)]
        cost["share_of_bf16_call"] = {c: cost["cast_floating_ms"] / 1e3 / walls[(c, "bf16")]
                                      for c in cells}
    xp = torch.randn(LSTM_FRAMES, 64, 8 * 512, device="cuda").to(bf16)
    costs["x_proj_upcast_ms_at_b64"] = cuda_ms(lambda: xp.float(), reps=10)
    w_hh = torch.randn(2, 4 * 512, 512, device="cuda").to(bf16)
    costs["w_hh_upcast_ms"] = cuda_ms(lambda: w_hh.float(), reps=10)
    result["cast"] = costs
    log(f"bf16 serving: cast cost {json.dumps(costs)}")
    # one window, bf16 against fp32 on the same inputs (last: its check reads how
    # near-tied the random weights' head logits are)
    bs, t = 8, cfg.pose_length
    audio = (torch.rand(bs, t * emage.SAMPLES_PER_FRAME, generator=g) - 0.5).cuda()
    spk = torch.randint(0, cfg.speaker_dims, (bs, 1), generator=g).cuda()
    motion = (torch.rand(bs, t, 337, generator=g) * 2 - 1).cuda()
    mask = torch.ones(bs, t, 337, device="cuda")
    mask[:, :cfg.seed_frames] = 0
    want = emage.emage_forward(model, audio, spk, motion, mask)
    got = emage.emage_forward(cast_floating(model, bf16), audio.to(bf16), spk, motion.to(bf16),
                              mask.to(bf16))
    window = {k: corr(got[k], want[k]) for k in want}
    agree = {k: head_agreement(want[f"cls_{k}"], got[f"cls_{k}"]) for k in PARTS}
    if any(got[k].dtype != bf16 for k in got) or min(window.values()) <= 0.99 \
            or min(a["outside_near_ties"] for a in agree.values()) <= 0.95:
        raise AssertionError(f"bf16 window: corr {window}, head agreement {agree}, dtypes "
                             f"{ {k: str(v.dtype) for k, v in got.items()} }")
    result["emage_window"] = {"corr": window, "head_agreement": agree}
    log(f"bf16 serving: one EMAGE window, bf16 vs fp32: corr {window}, head agreement {agree}")
    del xp, w_hh, lstm_models, lstm_inputs, emage_inputs, model, vq
    torch.cuda.empty_cache()

    # the CLIs in bf16
    frames = 3 * 30
    run_cli("pantomatrix_tpu_torch.cli.test_emage",
            {"poses": (frames, 165), "expressions": (frames, 100), "trans": (frames, 3)},
            ("--compute_dtype", "bfloat16", "--batched_wav"))
    run_cli("pantomatrix_tpu_torch.cli.test_camn", {"poses": (frames, 165)},
            ("--compute_dtype", "bfloat16"))
    return result


GRAPH_BATCHES = (8, 128)
GRAPH_MODES = {"fp32": (None, False), "bf16": ("bfloat16", False),
               "bf16_batched_wav": ("bfloat16", True)}
GRAPH_FP32_ATOL = 1e-5
GRAPH_LONG_REPS = 2  # turns of the 128 x 60 s calls
TAIL_SEED_BATCHES = (1, 8, 128)
PUMP_SESSIONS = (1, 64)  # bench_stream's N


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bfloat16 ulp at |x| (8 significant bits), for values in the normal range."""
    a = x.float().abs().clamp_min(2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def window_inputs(model, bs, mode, g):
    """One full window's inputs at batch ``bs`` in ``mode``: the module as called, audio,
    speaker ids, motion, mask and (batched_wav) the WavEncoder features."""
    from pantomatrix_tpu_torch.models.emage import SAMPLES_PER_FRAME, batched_audio_features
    from pantomatrix_tpu_torch.utils.precision import cast_once, compute_dtype_of

    cfg = model.config
    dtype, features = GRAPH_MODES[mode]
    dt = compute_dtype_of(dtype)
    m = cast_once(model, dt)
    cast = (lambda x: x) if dt is None else (lambda x: x.to(dt))
    t = cfg.pose_length
    audio = cast((torch.rand(bs, t * SAMPLES_PER_FRAME, generator=g) - 0.5).cuda())
    spk = torch.randint(0, cfg.speaker_dims, (bs, 1), generator=g).cuda()
    motion = cast((torch.rand(bs, t, 337, generator=g) * 2 - 1).cuda())
    mask = torch.ones(bs, t, 337, device="cuda")
    mask[:, :cfg.seed_frames] = 0
    feats = batched_audio_features(m, audio, 1)[0] if features else None
    return m, (audio, spk, motion, cast(mask)), feats


def tail_seed_check(model, vq, g) -> list:
    """At each of TAIL_SEED_BATCHES rows, a float32 window's seed decoded from the heads'
    last seed_decode_frames (11) frames against the seed decoded from all 64: bitwise
    equal, else it raises."""
    from pantomatrix_tpu_torch.models import emage
    from pantomatrix_tpu_torch.models.emage_vq import vq_decode
    from pantomatrix_tpu_torch.nn.layers import strict_fp32

    cfg = model.config
    tail = emage.seed_decode_frames(cfg.seed_frames, vq, cfg.pose_length)
    rows = []
    for bs in TAIL_SEED_BATCHES:
        _, ins, _ = window_inputs(model, bs, "fp32", g)
        with torch.no_grad(), strict_fp32():
            net = emage.emage_forward(model, *ins)

            def seed(frames):
                heads = {k: v[:, -frames:] for k, v in net.items()}
                out = vq_decode(vq, **emage._select_decode_inputs(cfg, heads))
                return out["all_motion4inference"][:, -cfg.seed_frames:]
            want, got = seed(cfg.pose_length), seed(tail)
        row = {"batch": bs, "frames": tail, "bitwise_equal": torch.equal(got, want),
               "max_abs_err": float((got - want).abs().max())}
        log(f"tail seed: {json.dumps(row)}")
        if not row["bitwise_equal"]:
            raise AssertionError(f"fp32 seed from the last {tail} frames differs from the "
                                 f"whole window's: {row}")
        rows.append(row)
        del net, ins
    return rows


def profiled_kernel_ms(fn):
    """(device ms of the kernels traced over one call of ``fn``, kernels traced)."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3, len(kernels)


def phase_graph(card, model, vq):
    """13. The window step as a CUDA graph against the eager step, and the AR call's wall
    with graphs against without, in each serving mode."""
    from pantomatrix_tpu_torch.models import emage
    from pantomatrix_tpu_torch.models.emage_graph import WARMUP_CALLS, graphs_of
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.ops import vq_cuda

    cfg = model.config
    g = torch.Generator().manual_seed(13)
    graph_step = emage.graph_window_step(graphs_of(model))
    result = {"card": card, "windows": [], "calls": []}
    for bs in GRAPH_BATCHES:
        for mode in GRAPH_MODES:
            m, ins, feats = window_inputs(model, bs, mode, g)
            want_net, want_last = emage._window_step(m, vq, *ins, feats)
            want = {**want_net, "last_motion": want_last}
            before = vq_cuda.launches
            net, last = graph_step(m, vq, *ins, feats)
            got = {k: v.clone() for k, v in {**net, "last_motion": last}.items()}
            torch.cuda.synchronize()
            first_launches = vq_cuda.launches - before
            row = {"batch": bs, "mode": mode, "first_call_k1_launches": first_launches,
                   "bitwise_equal": all(torch.equal(got[k], want[k]) for k in want),
                   "max_abs_err": {k: float((got[k].float() - want[k].float()).abs().max())
                                   for k in want}}
            if mode == "fp32":
                bad = [k for k, e in row["max_abs_err"].items() if not e <= GRAPH_FP32_ATOL]
            else:
                row["max_err_in_bf16_ulps"] = {
                    k: float(((got[k].float() - want[k].float()).abs()
                              / bf16_ulp(torch.maximum(got[k].float().abs(),
                                                       want[k].float().abs()))).max())
                    for k in want if want[k].dtype == torch.bfloat16}
                bad = [k for k, e in row["max_err_in_bf16_ulps"].items() if not e <= 1.0]
                bad += [k for k, v in want.items() if v.dtype != torch.bfloat16
                        and not row["max_abs_err"][k] <= GRAPH_FP32_ATOL]
            heads = {p: torch.equal(got[f"cls_{p}"].argmax(-1), want[f"cls_{p}"].argmax(-1))
                     for p in ("face", "upper", "hands", "lower")}
            if bad or not all(heads.values()) or first_launches != 1 + WARMUP_CALLS:
                raise AssertionError(f"graph step {bs} {mode}: off {bad}, heads {heads}, "
                                     f"first call K1 launches {first_launches}: {row}")
            before = vq_cuda.launches
            graph_step(m, vq, *ins, feats)
            if vq_cuda.launches - before != 1:
                raise AssertionError(f"graph step {bs} {mode}: a replay counted "
                                     f"{vq_cuda.launches - before} K1 launches, want 1")
            row["eager_ms"] = cuda_ms(lambda: emage._window_step(m, vq, *ins, feats), reps=10)
            row["replay_ms"] = cuda_ms(lambda: graph_step(m, vq, *ins, feats), reps=10)
            result["windows"].append(row)
            log(f"graph step: {json.dumps(row)}")
            del want, got, net, last, ins, feats
    result["tail_seed"] = tail_seed_check(model, vq, g)

    # the AR call with graphs (emage_inference) against the eager loop, in turns
    for (bs, seconds), reps in zip(BF16_EMAGE_CELLS, (BF16_REPS, GRAPH_LONG_REPS)):
        audio = (torch.rand(bs, seconds * 16000, generator=g) - 0.5).cuda()
        spk = torch.zeros((bs, 1), dtype=torch.long, device="cuda")
        zero = torch.zeros(1, 3, device="cuda")
        calls = {}
        for mode, (dtype, bw) in GRAPH_MODES.items():
            if dtype is not None and (bs, seconds) != BF16_EMAGE_CELLS[0]:
                continue  # bf16 at 128 x 60 s is emage-offline-bf16 (BENCHMARK.json)

            def call(eager, dtype=dtype, bw=bw):
                if eager:  # emage_inference's loop with the eager step for every window
                    with torch.no_grad(), strict_fp32():
                        out = emage._inference_loop(model, audio, spk, vq, None, None, dtype,
                                                    bw, emage._window_step)
                else:
                    out = emage.emage_inference(model, audio, spk, vq, compute_dtype=dtype,
                                                batched_wav=bw)
                vq.decode(**emage._select_decode_inputs(cfg, out), get_global_motion=True,
                          ref_trans=zero)
            calls[f"{mode} graph"] = lambda call=call: call(False)
            calls[f"{mode} eager"] = lambda call=call: call(True)
        walls = timed_in_turns(calls, reps)
        for name, stats in walls.items():
            row = {"cell": f"EMAGE {bs} x {seconds} s", "path": name, "wall_s": stats,
                   "realtime_factor": bs * seconds / stats["median"], "card": card}
            if (bs, seconds) == BF16_EMAGE_CELLS[0] and name.endswith("graph"):
                # profiling a call costs seconds of host time per path: only the graph
                # paths at 8 x 20 s (the other idle shares are in PERF.md)
                kernel_ms, traced = profiled_kernel_ms(calls[name])
                row.update(profiled_kernel_ms=kernel_ms, kernels_traced=traced,
                           device_idle_share=1 - kernel_ms / 1e3 / stats["median"])
            result["calls"].append(row)
            log(f"graph vs eager: {json.dumps(row)}")
        del audio
    return result


def stream_session(gen, wave):
    """Push ``wave`` in four uneven pieces, then flush; the emitted results."""
    n = len(wave)
    cuts = [0, 1000, n // 3, 2 * n // 3 + 1, n]
    return [gen.push(wave[a:b]) for a, b in zip(cuts, cuts[1:])] + [gen.flush()]


def phase_streaming(card, model, vq):
    """14. Streaming against offline, the pool's sessions, and the pump sweep."""
    from pantomatrix_tpu_torch.cli.bench_stream import bench_pool
    from pantomatrix_tpu_torch.models.emage import emage_inference
    from pantomatrix_tpu_torch.serve import StreamingEmageGenerator, StreamingPool

    rng = np.random.RandomState(14)
    result = {"card": card}
    # one stream at batch 1 against offline emage_inference at batch 1 (10 s of audio)
    wave = rng.uniform(-0.5, 0.5, 10 * 16000).astype(np.float32)
    off = emage_inference(model, torch.from_numpy(wave)[None].cuda(),
                          torch.zeros((1, 1), dtype=torch.long, device="cuda"), vq)
    off = {k: v.cpu().numpy() for k, v in off.items()}
    gen = StreamingEmageGenerator(model, vq, collect_latents=True)
    outs = stream_session(gen, wave)
    streamed = {k: np.concatenate([lat[k] for lat in gen.latents], 1) for k in gen.latents[0]}
    frames = sum(o.motion_axis_angle.shape[0] for o in outs)
    err = {k: float(np.abs(streamed[k] - off[k]).max()) for k in off}
    heads = all(np.array_equal(streamed[f"cls_{p}"].argmax(-1), off[f"cls_{p}"].argmax(-1))
                for p in ("face", "upper", "hands", "lower"))
    if frames != off["rec_face"].shape[1] or max(err.values()) > 1e-5 or not heads:
        raise AssertionError(f"streaming vs offline: {frames} frames (want "
                             f"{off['rec_face'].shape[1]}), latents off by {err}, heads {heads}")
    result["stream_vs_offline"] = {"frames": frames, "max_abs_err": err}
    log(f"streaming: batch-1 stream vs offline: {frames} frames, latents max abs err {err}")

    # StreamingPool at N = 8 sessions of uneven length against their offline runs
    lens = [int(16000 * s) for s in (3.1, 4.0, 5.5, 2.6, 6.2, 3.7, 4.9, 5.0)]
    waves = [rng.uniform(-0.5, 0.5, n).astype(np.float32) for n in lens]
    pool = StreamingPool(model, vq, batch=8)
    sids = [pool.open(speaker_id=0, collect_latents=True) for _ in range(8)]
    emitted = {sid: [] for sid in sids}
    cuts = [0, 20000, 45000, 70000, max(lens)]
    for a, b in zip(cuts, cuts[1:]):
        for sid, w in zip(sids, waves):
            if a < len(w):
                pool.feed(sid, w[a:min(b, len(w))])
        for sid, res in pool.pump():
            emitted[sid].append(res)
    for sid in sids:
        emitted[sid].append(pool.flush(sid))
    rows = []
    for i, (sid, w) in enumerate(zip(sids, waves)):
        want = emage_inference(model, torch.from_numpy(w)[None].cuda(),
                               torch.zeros((1, 1), dtype=torch.long, device="cuda"), vq)
        single = StreamingEmageGenerator(model, vq, collect_latents=True)
        single_outs = stream_session(single, w)
        lat = pool.session(sid).latents
        frames = sum(r.motion_axis_angle.shape[0] for r in emitted[sid])
        c = corr(torch.from_numpy(lat[0]["rec_face"]), torch.from_numpy(
            single.latents[0]["rec_face"]))
        chunks = [r for r in emitted[sid] if r.trans.shape[0]]
        # x and z integrate from the previous chunk's last position (y is direct)
        jumps = [float(np.abs(b.trans[0, [0, 2]] - a.trans[-1, [0, 2]]).max())
                 for a, b in zip(chunks, chunks[1:])]
        row = {"session": i, "frames": frames, "offline_frames": want["rec_face"].shape[1],
               "first_window_rec_face_corr_vs_single": c,
               "trans_continuity_max_abs": max(jumps), "chunks": len(chunks),
               "last_trans": chunks[-1].trans[-1].tolist(),
               "single_last_trans": single_outs[-1].trans[-1].tolist()
               if single_outs[-1].trans.shape[0] else None}
        rows.append(row)
        if frames != row["offline_frames"] or not c > 0.999 or max(jumps) > 1e-6:
            raise AssertionError(f"pool session {i}: {row}")
    ends = {tuple(np.round(r["last_trans"], 6)) for r in rows}
    if len(ends) < 2:
        raise AssertionError("pool: every session ended at one translation; the continuity "
                             "check cannot tell sessions apart")
    result["pool_sessions"] = rows
    log(f"streaming: pool of 8 uneven sessions: {json.dumps(rows)}")

    # the bench_stream protocol, swept over N in both modes
    result["pump"] = []
    for dtype in (None, "bfloat16"):
        for n in PUMP_SESSIONS:
            line = bench_pool(model, vq, n, 10, dtype)
            line.update(compute_dtype=dtype or "float32", card=card)
            result["pump"].append(line)
            log(f"bench_stream: {json.dumps(line)}")
    return result


def phase_daemon(card, model, vq):
    """15. MotionServer on 127.0.0.1, two clients over HTTP, against an in-process pool."""
    from pantomatrix_tpu_torch.serve import StreamingPool
    from pantomatrix_tpu_torch.serve_http import MotionClient, MotionServer

    rng = np.random.RandomState(15)
    waves = [rng.uniform(-0.5, 0.5, 3 * 16000).astype(np.float32) for _ in range(2)]
    frames = 3 * 30
    server = MotionServer(model, vq, batch=2).start()
    try:
        clients = [MotionClient(server.host, server.port) for _ in waves]
        sids = [c.open_session(speaker_id=0) for c in clients]
        for c, sid, w in zip(clients, sids, waves):
            c.send_audio(sid, w)
        got = []
        for c, sid in zip(clients, sids):
            chunks, n = [], 0
            deadline = time.monotonic() + 120
            stride = model.config.pose_length - model.config.seed_frames
            while n < (frames - model.config.seed_frames) // stride * stride:
                if time.monotonic() > deadline:
                    raise AssertionError(f"daemon: {n} frames before the deadline")
                r = c.read_motion(sid, timeout_ms=1000)
                chunks.append(r)
                n += r.motion_axis_angle.shape[0]
            chunks.append(c.flush(sid))
            c.close_session(sid)
            got.append(chunks)
        health = clients[0].health()
    finally:
        server.stop()
    pool = StreamingPool(model, vq, batch=2)
    psids = [pool.open(speaker_id=0) for _ in range(2)]
    want = {sid: [] for sid in psids}
    for sid, w in zip(psids, waves):
        pool.feed(sid, w)
    for sid, r in pool.pump():
        want[sid].append(r)
    for sid in psids:
        want[sid].append(pool.flush(sid))
    cat = lambda rs, f: np.concatenate([getattr(r, f) for r in rs])
    errs = []
    for chunks, sid in zip(got, psids):
        e = {f: float(np.abs(cat(chunks, f) - cat(want[sid], f)).max())
             for f in ("motion_axis_angle", "expressions", "trans")}
        t = cat(chunks, "motion_axis_angle").shape[0]
        ok = all(np.isfinite(cat(chunks, f)).all() for f in ("motion_axis_angle", "trans"))
        if t != frames or not ok or max(e.values()) > 1e-5:
            raise AssertionError(f"daemon: {t} frames (want {frames}), finite {ok}, against "
                                 f"the in-process pool {e}")
        errs.append(e)
    log(f"daemon: two HTTP clients x 3 s -> {frames} frames each, finite; against an "
        f"in-process pool at batch 2: max abs err {errs}; health {health}")
    return {"max_abs_err": errs, "health": health, "card": card}


def phase_rest(card):
    """16. SequenceGenerator for CaMN and DisCo, and entry()."""
    from pantomatrix_tpu_torch.entry import entry
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig
    from pantomatrix_tpu_torch.ops import lstm_cuda
    from pantomatrix_tpu_torch.serve import SequenceGenerator

    rng = np.random.RandomState(16)
    waves = [rng.uniform(-0.5, 0.5, int(16000 * s)).astype(np.float32)
             for s in (2.0, 3.5, 5.0, 4.2, 6.0, 2.7, 7.9, 3.3)]
    result = {"card": card}
    for name, cls, cfg_cls, want in (("camn", CamnAudioModel, CamnAudioConfig, 8),
                                     ("disco", DiscoAudioModel, DiscoAudioConfig, 4)):
        gen = SequenceGenerator(cls(cfg_cls(), seed=3), batch_size=8, bucket_seconds=8.0)
        lstm_cuda.launches = 0
        out = gen.generate(waves, speaker_ids=[0] * 8)
        fps = gen.model.config.pose_fps
        ok = all(m.shape == (len(w) * fps // 16000, 165) and np.isfinite(m).all()
                 for m, w in zip(out, waves))
        if not ok or lstm_cuda.launches != want:
            raise AssertionError(f"SequenceGenerator {name}: shapes/finite {ok}, K2 launches "
                                 f"{lstm_cuda.launches} (want {want})")
        result[f"{name}_k2_launches"] = lstm_cuda.launches
        log(f"SequenceGenerator {name}: 8 clips in one batch-8 bucket, K2 launches "
            f"{lstm_cuda.launches}")
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    if shapes["rec_face"] != (1, 64, 256) or not all(bool(torch.isfinite(v).all())
                                                     for v in out.values()):
        raise AssertionError(f"entry(): {shapes}")
    log(f"entry(): full-width window forward -> {shapes}, finite")
    return result


PARTS = ("face", "upper", "hands", "lower")
EVAL_TAKES = 4
EVAL_SECONDS = 64
EVAL_FRAMES = EVAL_SECONDS * 30
SMPLX_V, SMPLX_F = 10475, 20908  # the real SMPLX_NEUTRAL_2020.npz's vertex and face counts
EVAL_METRIC_RTOL = 1e-4
EVAL_EXPR_ATOL = 1e-4


def write_smplx_archive(archive: Path, rng) -> Path:
    """A synthetic SMPLX_NEUTRAL_2020.npz at the real archive's shapes (V = 10475, F =
    20908, the SMPL-X kinematic tree), drawn from ``rng``."""
    from pantomatrix_tpu_torch.eval.fgd_encoder import SMPLX_PARENTS

    v, f = SMPLX_V, SMPLX_F
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = [2**32 - 1] + list(SMPLX_PARENTS[1:])
    kintree[1] = np.arange(55)
    jreg = np.abs(rng.normal(0, 1, (55, v))).astype(np.float32)
    weights = np.abs(rng.normal(0, 1, (v, 55))).astype(np.float32)
    bary = rng.uniform(0.1, 1, (51, 3))
    np.savez(archive, v_template=rng.normal(0, 0.3, (v, 3)).astype(np.float32),
             shapedirs=rng.normal(0, 0.01, (v, 3, 400)).astype(np.float32),
             posedirs=rng.normal(0, 0.01, (v, 3, 486)).astype(np.float32),
             J_regressor=jreg / jreg.sum(1, keepdims=True), kintree_table=kintree,
             weights=weights / weights.sum(1, keepdims=True),
             hands_meanl=rng.normal(0, 0.1, 45).astype(np.float32),
             hands_meanr=rng.normal(0, 0.1, 45).astype(np.float32),
             f=rng.randint(0, v, (f, 3)).astype(np.int64),
             lmk_faces_idx=rng.randint(0, f, 51).astype(np.int64),
             lmk_bary_coords=(bary / bary.sum(1, keepdims=True)).astype(np.float32))
    return archive


def write_eval_data(root: Path) -> dict:
    """Everything phase 17 reads, from numpy and torch seeds: a BEAT2 layout (speaker 2,
    EVAL_TAKES test takes of EVAL_SECONDS s), a synthetic SMPL-X archive at the real
    archive's shapes, a random AESKConv state dict as emage_evaltools/AESKConv_240_100.bin
    under a working directory, and full-width checkpoints of the three families."""
    from pantomatrix_tpu_torch.cli.test_emage import load_models
    from pantomatrix_tpu_torch.data.preprocess import build_clip_index
    from pantomatrix_tpu_torch.eval.fgd_encoder import AESKConv
    from pantomatrix_tpu_torch.io.hf_checkpoint import save_checkpoint
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig

    rng = np.random.RandomState(17)
    beat2 = root / "beat2"
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        (beat2 / sub).mkdir(parents=True)
    rows = ["id,type"]
    for i in range(EVAL_TAKES):
        vid = f"2_scott_0_{i + 1}_{i + 1}"
        t = EVAL_FRAMES
        poses = np.cumsum(rng.normal(0, 0.02, (t, 165)), axis=0) + rng.uniform(-0.3, 0.3, 165)
        np.savez(beat2 / "smplxflame_30" / f"{vid}.npz",
                 betas=rng.normal(0, 1, 300).astype(np.float32), poses=poses.astype(np.float32),
                 expressions=rng.normal(0, 0.5, (t, 100)).astype(np.float32),
                 trans=np.cumsum(rng.normal(0, 0.01, (t, 3)), axis=0).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        np.save(beat2 / "footcontact" / f"{vid}.npy",
                (rng.uniform(size=(t, 4)) < 0.5).astype(np.float32))
        n = EVAL_SECONDS * 16000
        x = rng.normal(0, 0.01, n)  # noise bursts on a quiet floor: onsets for BC
        for start in rng.randint(0, n - 1600, n // 6000):
            x[start:start + 1600] += rng.normal(0, 0.3, 1600) * np.hanning(1600)
        with wave.open(str(beat2 / "wave16k" / f"{vid}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
        rows.append(f"{vid},test")
    (beat2 / "train_test_split.csv").write_text("\n".join(rows) + "\n")

    archive = write_smplx_archive(root / "SMPLX_NEUTRAL_2020.npz", rng)

    work = root / "work"
    (work / "emage_evaltools").mkdir(parents=True)
    enc = AESKConv(generator=torch.Generator().manual_seed(17))
    torch.save({f"encoder.{k}": t for k, t in enc.state_dict().items()},
               work / "emage_evaltools" / "AESKConv_240_100.bin")
    (root / "work_without_fgd").mkdir()

    ckpt = {"emage": root / "emage", "camn": root / "camn", "disco": root / "disco"}
    model, vq = load_models(None, True, "cuda")
    model.save_pretrained(str(ckpt["emage"]))
    for part, name in (("face", "face"), ("upper", "upper"), ("hands", "hands"),
                       ("lower", "lower"), ("global_motion", "global")):
        module = getattr(vq, part)
        save_checkpoint(str(ckpt["emage"] / "emage_vq" / name), module.state_dict(),
                        module.config)
    del model, vq
    CamnAudioModel(CamnAudioConfig(), seed=3, device="cuda").save_pretrained(str(ckpt["camn"]))
    DiscoAudioModel(DiscoAudioConfig(), seed=3, device="cuda").save_pretrained(
        str(ckpt["disco"]))
    torch.cuda.empty_cache()
    meta = build_clip_index(str(beat2), str(root / "index"))
    return {"beat2": beat2, "archive": archive, "work": work,
            "work_without_fgd": root / "work_without_fgd", "ckpt": ckpt, "meta": meta}


def run_evaluate_cli(data: dict, family: str, flags, out: Path, with_fgd: bool = True) -> dict:
    """``python -m pantomatrix_tpu_torch.cli.evaluate`` on the card; its metrics.json."""
    import os

    env = dict(os.environ, SMPLX_MODEL_PATH=str(data["archive"]),
               PYTHONPATH=str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "pantomatrix_tpu_torch.cli.evaluate", "--family", family,
           "--model_path", str(data["ckpt"][family]), "--save_folder", str(out),
           "--device", "cuda", *flags]
    t0 = time.time()
    r = subprocess.run(cmd, cwd=str(data["work"] if with_fgd else data["work_without_fgd"]),
                       env=env, capture_output=True, text=True, timeout=900)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"evaluate {family} {flags} failed ({r.returncode}):\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    metrics = json.loads((out / "metrics.json").read_text())
    want = {"fgd", "fgd_embedder", "bc", "l1"} | ({"lvd", "mse"} if family == "emage" else set())
    finite = all(np.isfinite(metrics[k]) for k in want if k != "fgd_embedder")
    embedder = "aeskconv" if with_fgd else "stats"
    if set(metrics) != want or not finite or metrics["fgd_embedder"] != embedder:
        raise AssertionError(f"evaluate {family} {flags}: metrics {metrics}; want keys "
                             f"{sorted(want)}, finite values, fgd_embedder {embedder}")
    cost = next((line for line in r.stdout.splitlines() if line.startswith("cost ")), "")
    log(f"CLI evaluate --family {family} {' '.join(flags)} ({embedder}): {wall:.1f} s wall; "
        f"{cost}; {json.dumps(metrics)}")
    return {"family": family, "flags": list(flags), "wall_s": wall, "cost_line": cost,
            "metrics": metrics}


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def metrics_agree(got: dict, want: dict) -> dict:
    """Card against CPU: FGD, L1div, LVD, MSE within EVAL_METRIC_RTOL, BC equal."""
    rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
           for k in ("fgd", "l1", "lvd", "mse")}
    if (set(got) != set(want) or got["bc"] != want["bc"] or max(rel.values()) > EVAL_METRIC_RTOL
            or got["fgd_embedder"] != want["fgd_embedder"]):
        raise AssertionError(f"evaluate_clips card {got} against CPU {want}: rel {rel}")
    return rel


def phase_eval(card):
    """17. Evaluation: the CLI five times, then the generate functions with the kernels
    counted, and evaluate_clips on the card against the CPU."""
    from concurrent.futures import ThreadPoolExecutor

    from pantomatrix_tpu_torch.core.motion_rep import get_motion_rep
    from pantomatrix_tpu_torch.core.rotations import axis_angle_to_rotation_6d
    from pantomatrix_tpu_torch.core.smplx import load_smplx
    from pantomatrix_tpu_torch.data.audio import load_audio
    from pantomatrix_tpu_torch.eval import test_flow
    from pantomatrix_tpu_torch.eval.pipeline import evaluate_clips
    from pantomatrix_tpu_torch.models.api import AutoModel, EmageVQModel
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda

    result = {"card": card, "takes": EVAL_TAKES, "seconds": EVAL_SECONDS}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        t0 = time.time()
        data = write_eval_data(root)
        result["setup_s"] = time.time() - t0
        log(f"evaluation: {EVAL_TAKES} takes x {EVAL_SECONDS} s, SMPL-X archive V = {SMPLX_V}, "
            f"F = {SMPLX_F}, checkpoints written in {result['setup_s']:.1f} s")
        meta = ["--meta", data["meta"]]
        root_flags = ["--beat2_root", str(data["beat2"])]
        # the five runs share the card at once: their walls are concurrent ones
        runs = [("emage", root_flags, "out_emage", True),
                ("emage", root_flags + ["--vq_roundtrip"], "out_rt", True),
                ("camn", meta, "out_camn", True), ("disco", meta, "out_disco", True),
                ("disco", meta, "out_stats", False)]
        t0 = time.time()
        with ThreadPoolExecutor(len(runs)) as pool:
            result["cli"] = list(pool.map(
                lambda r: run_evaluate_cli(data, r[0], r[1], root / r[2], with_fgd=r[3]), runs))
        result["cli_s"] = time.time() - t0

        test_list = test_flow.unique_test_clips([data["meta"]])
        wave0, wave1 = (torch.from_numpy(load_audio(m["audio_path"]))[None]
                        for m in test_list[:2])
        spk = torch.zeros((1, 1), dtype=torch.long)
        gen_s, launches, seq_err = {}, {}, {}
        for family, make, want in (("camn", test_flow.make_camn_generate, 8),
                                   ("disco", test_flow.make_disco_generate, 4)):
            gen = make(AutoModel.from_pretrained(str(data["ckpt"][family]), device="cuda"))
            _, first = timed(lambda: gen(wave0, spk))
            vq_cuda.launches = lstm_cuda.launches = 0
            out, warm = timed(lambda: gen(wave1, spk))
            launches[family] = lstm_cuda.launches
            if lstm_cuda.launches != want or vq_cuda.launches != 0 or \
                    not np.isfinite(out["motion"]).all():
                raise AssertionError(f"{family} generate: K2 {lstm_cuda.launches} launches "
                                     f"(want {want}), K1 {vq_cuda.launches}")
            gen_s[family] = {"first": first, "warm": warm}
            # the same take through the same checkpoint on the CPU, where K2 is its plain
            # version
            cpu_out = make(AutoModel.from_pretrained(str(data["ckpt"][family]),
                                                     device="cpu"))(wave1, spk)
            seq_err[family] = float(np.abs(out["motion"] - cpu_out["motion"]).max())
            if out["motion"].shape != cpu_out["motion"].shape or \
                    not seq_err[family] <= PARITY_ROT_ATOL:
                raise AssertionError(f"{family} generate on the card against the CPU: "
                                     f"{out['motion'].shape} vs {cpu_out['motion'].shape}, "
                                     f"max abs err {seq_err[family]} > {PARITY_ROT_ATOL}")

        model = AutoModel.from_pretrained(str(data["ckpt"]["emage"]), device="cuda")
        vq = EmageVQModel.from_pretrained(str(data["ckpt"]["emage"]), "cuda")
        gen = test_flow.make_emage_generate(model, vq)
        _, first = timed(lambda: gen(wave0, spk))  # captures the window step's graph
        vq_cuda.launches = 0
        out, warm = timed(lambda: gen(wave1, spk))
        rounds = (EVAL_FRAMES - 4) // 60
        launches["emage"] = vq_cuda.launches
        if vq_cuda.launches != rounds + 2 or not np.isfinite(out["motion"]).all():
            raise AssertionError(f"emage generate: K1 {vq_cuda.launches} launches, want "
                                 f"{rounds + 2}")
        gen_s["emage"] = {"first": first, "warm": warm}

        # the VQ round trip: the latents are codebook rows, so K1 finds map2index's codes
        rt = test_flow.make_emage_vq_roundtrip_generate(vq)
        _, first = timed(lambda: rt(None, None, meta=test_list[0]))
        vq_cpu = EmageVQModel.from_pretrained(str(data["ckpt"]["emage"]), "cpu")
        motion_path = test_list[1]["motion_path"]
        with np.load(motion_path) as d:
            poses, expr, trans = (torch.from_numpy(d[k])[None]
                                  for k in ("poses", "expressions", "trans"))
        contact = torch.from_numpy(np.load(motion_path.replace("smplxflame_30", "footcontact")
                                           .replace(".npz", ".npy")))[None]
        rot6d = axis_angle_to_rotation_6d(poses.reshape(1, -1, 55, 3)).reshape(1, -1, 330)
        args = [x.cuda() for x in (rot6d, expr, contact, trans)]
        idx, lat = vq.map2index(*args), vq.map2latent(*args)
        idx_cpu = vq_cpu.map2index(*[x.cpu() for x in args])
        near_ties = {}
        for part in PARTS:
            codebook = getattr(vq, part).quantizer.embedding.weight
            k1 = vq_cuda.nearest_code(lat[part].contiguous(), codebook)
            if not torch.equal(k1, idx[part]):
                raise AssertionError(f"round trip {part}: K1 indices differ from map2index's "
                                     f"in {int((k1 != idx[part]).sum())} of {k1.numel()} rows")
            # map2index on the card against on the CPU: the encoders' float32 rounding
            # differs, so rows may differ where two codes are near-tied for the card's
            # encoder output (float64 distances within 1e-5 relative)
            differ = (idx[part].cpu() != idx_cpu[part]).reshape(-1)
            if bool(differ.any()):
                with torch.no_grad(), strict_fp32():
                    z = getattr(vq, part).encoder(vq.spilt_inputs(*args)[part])
                z = z.reshape(-1, codebook.shape[1])[differ.cuda()].double()
                cb = codebook.detach().double()
                d_card = ((z - cb[idx[part].reshape(-1)[differ.cuda()].long()]) ** 2).sum(-1)
                d_cpu = ((z - cb[idx_cpu[part].reshape(-1)[differ].long().cuda()]) ** 2).sum(-1)
                gap = ((d_card - d_cpu).abs() / d_card.abs().clamp_min(1e-30)).cpu()
                near_ties[part] = {"rows": int(differ.sum()),
                                   "frames": torch.nonzero(differ).reshape(-1).tolist()[:8],
                                   "max_rel_gap": float(gap.max())}
                if float(gap.max()) >= 1e-5:
                    raise AssertionError(f"round trip {part}: map2index on the card and on "
                                         f"the CPU differ beyond near-ties: {near_ties[part]}")
        vq_cuda.launches = lstm_cuda.launches = 0
        got, warm = timed(lambda: rt(None, None, meta=test_list[1]))
        launches["vq_roundtrip"] = vq_cuda.launches
        if vq_cuda.launches != 4:
            raise AssertionError(f"round trip: K1 launched {vq_cuda.launches} times, want 4")
        gen_s["vq_roundtrip"] = {"first": first, "warm": warm}
        # the card's latents decoded on the CPU, where K1 is its plain version
        dec = vq_cpu.decode(**{f"{p}_latent": lat[p].cpu() for p in PARTS},
                            get_global_motion=True, ref_trans=trans[:, :1])
        t = rot6d.shape[1]
        want = {"motion": dec["motion_axis_angle"].reshape(t, -1).numpy(),
                "expressions": dec["expression"].reshape(t, -1).numpy(),
                "trans": dec["trans"].reshape(t, -1).numpy()}
        rt_err = {k: float(np.abs(got[k] - want[k]).max()) for k in want}
        if not (rt_err["motion"] <= PARITY_ROT_ATOL and rt_err["expressions"] <= EVAL_EXPR_ATOL
                and rt_err["trans"] <= EVAL_EXPR_ATOL):
            raise AssertionError(f"round trip on the card against the CPU: {rt_err}")
        del model, vq, vq_cpu, gen, rt
        torch.cuda.empty_cache()
        log(f"evaluation generate, s per {EVAL_SECONDS} s take (first, warm): {gen_s}; kernel "
            f"launches per warm take: {launches}; CaMN/DisCo card vs CPU (plain K2) max abs "
            f"err {seq_err}; round trip: K1 indices equal to map2index's "
            f"in all four parts; the card's latents decoded on the CPU (plain K1), max abs err "
            f"{rt_err}; map2index card vs CPU near-ties {near_ties} | {card}")

        # the FK at V = 10475, then evaluate_clips on the card against the CPU over the
        # EMAGE CLI's saved takes
        smplx_gpu = load_smplx(str(data["archive"]), "cuda")
        pred = [{"video_id": m["video_id"],
                 "motion_path": str(root / "out_emage" / f"{m['video_id']}_output.npz")}
                for m in test_list]
        with np.load(pred[0]["motion_path"]) as d:
            motion, pexpr = d["poses"], d["expressions"]
        with np.load(test_list[0]["motion_path"]) as d:
            betas = d["betas"]
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        fk = lambda: (get_motion_rep(smplx_gpu, motion, 30, betas=betas),
                      get_motion_rep(smplx_gpu, motion, 30, betas=betas, expressions=pexpr,
                                     expression_only=True))
        timed(fk)
        fk_out, fk_s = timed(fk)
        fk_peak = (torch.cuda.max_memory_allocated() - base) / 1e9
        kw = dict(pose_fps=30, with_face=True,
                  download_path=str(data["work"] / "emage_evaltools"))
        got, metric_s = timed(lambda: evaluate_clips(test_list, pred, smplx_gpu,
                                                     device="cuda", **kw))
        t0 = time.time()
        want = evaluate_clips(test_list, pred, load_smplx(str(data["archive"]), "cpu"),
                              device="cpu", **kw)
        cpu_s = time.time() - t0
        rel = metrics_agree(got, want)
        log(f"evaluation FK at V = {SMPLX_V}, T = {EVAL_FRAMES}: body joints + face vertices "
            f"{fk_s:.3f} s a take, peak {fk_peak:.2f} GB above the resident; evaluate_clips "
            f"over {EVAL_TAKES} takes {metric_s:.2f} s on the card, {cpu_s:.2f} s on the CPU; "
            f"card vs CPU rel err {rel}, BC equal ({got['bc']}) | {card}")
        if fk_out[1]["vertices"].shape != (EVAL_FRAMES, SMPLX_V * 3):
            raise AssertionError(f"face vertices {fk_out[1]['vertices'].shape}")
    result.update(generate_s=gen_s, launches_per_take=launches, seq_generate_max_abs_err=seq_err,
                  roundtrip_max_abs_err=rt_err,
                  map2index_near_ties=near_ties,
                  fk_s_per_take=fk_s, fk_peak_gb=fk_peak, metrics_card_s=metric_s,
                  metrics_cpu_s=cpu_s, metrics_card=got, metrics_cpu=want, metrics_rel_err=rel)
    return result


# ---------------------------------------------------------------------------
# 18. training
# ---------------------------------------------------------------------------

TRAIN_K2_SHAPE = (64, 64, 512)  # CaMN's shipped clip: 128 frames at 30 fps, read at 15
TRAIN_STEPS = 6
TRAIN_LOSS_RTOL = 1e-5
TRAIN_PARAM_ATOL = 1e-4
TRAIN_BUFFER_ATOL = 1e-5
TRAIN_CELLS = {  # family: (batch, clip frames at 30 fps, shipped learning rate)
    "camn": (64, 128, 3e-4), "disco": (64, 128, 3e-4), "emage": (56, 64, 1.5e-4)}
TRAIN_K2_PER_STEP = {"camn": 8, "disco": 4, "emage": 0}


def train_batch(family: str, bs: int, frames: int, device, seed: int = 0) -> dict:
    """A training batch from a numpy seed, as the BEAT2 loaders give it: CaMN and DisCo
    read the clip at 15 fps with the local_upper mask (43 joints), EMAGE at 30 fps with
    all 55 joints, expressions, translation and foot contact."""
    from pantomatrix_tpu_torch.nn.blocks import wav_encoder_out_len

    rng = np.random.RandomState(seed)
    audio = rng.uniform(-0.5, 0.5, (bs, frames * 533)).astype(np.float32)
    if family == "emage":
        b = {"motion": rng.uniform(-0.5, 0.5, (bs, frames, 165)),
             "expressions": rng.uniform(-1, 1, (bs, frames, 100)),
             "trans": rng.uniform(-1, 1, (bs, frames, 3)),
             "foot_contact": (rng.uniform(size=(bs, frames, 4)) < 0.5)}
    else:
        t = wav_encoder_out_len(audio.shape[1], 128, "camn")
        b = {"motion": rng.uniform(-0.5, 0.5, (bs, t, 129))}
    out = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device) for k, v in b.items()}
    out["audio"] = torch.from_numpy(audio).to(device)
    if family == "disco":
        out["rhythm_label"] = torch.from_numpy(rng.randint(0, 3, (bs, 1))).to(device)
        out["content_label"] = torch.from_numpy(rng.randint(0, 4, (bs, 1))).to(device)
    return out


def train_setup(family: str, device, tiny: bool, lr: float, optimizer: str = "adam",
                seed: int = 3, **step_kw):
    """A model of ``family`` (tiny: the parity configs; else the full width), its
    optimizer and its train step."""
    from pantomatrix_tpu_torch.cli.test_emage import load_models
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, DiscoAudioModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, DiscoAudioConfig
    from pantomatrix_tpu_torch.train import steps
    from pantomatrix_tpu_torch.train.optim import make_optimizer

    small = dict(audio_f=128, speaker_f=8, speaker_dims=4, hidden_size=48, n_layer=2,
                 pose_dims=258, body_dims=78, hands_dims=180, dropout_prob=0.0)
    if family == "emage":
        _, model, vq = tiny_models(device) if tiny else (None, *load_models(None, True, device))
    else:
        model_cls, cfg_cls = {"camn": (CamnAudioModel, CamnAudioConfig),
                              "disco": (DiscoAudioModel, DiscoAudioConfig)}[family]
        model = model_cls(cfg_cls(**small) if tiny else cfg_cls(), seed=seed, device=device)
    opt = make_optimizer(model.parameters(), learning_rate=lr, optimizer=optimizer)
    if family == "emage":
        return model, opt, steps.make_emage_train_step(model, vq, opt, **step_kw)
    make = steps.make_camn_train_step if family == "camn" else steps.make_disco_train_step
    return model, opt, make(model, opt, **step_kw)


def phase_train_k2(card):
    """18a. K2 under autograd (ops/lstm_cuda.LstmLayerFunction) against the plain
    version's autograd, and its times at the CaMN training shape."""
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.ops import lstm_cuda

    fn, plain = lstm_cuda.LstmLayerFunction.apply, lstm_cuda.lstm_bidirectional_plain
    g = torch.Generator().manual_seed(18)
    rows = []
    with strict_fp32():
        for t, b, h in K2_TEST_SHAPES + [TRAIN_K2_SHAPE, K2_BENCH_SHAPE]:
            if (t, b, h) in (TRAIN_K2_SHAPE, K2_BENCH_SHAPE):
                # a CaMN inner layer: torch-default weights, N(0, 1) input of width 2H
                bound = h ** -0.5
                u = lambda *s: ((torch.rand(*s, generator=g) * 2 - 1) * bound).cuda()
                w_ih, w, bias = u(8 * h, 2 * h), u(2, 4 * h, h), u(8 * h) + u(8 * h)
                x = torch.randn(t, b, 2 * h, generator=g).cuda()
                xp = torch.matmul(x, w_ih.T) + bias
            else:  # the kernel test's distributions
                xp = torch.randn(t, b, 8 * h, generator=g).cuda()
                w = (0.2 * torch.randn(2, 4 * h, h, generator=g)).cuda()
            ct = torch.randn(t, b, 2 * h, generator=g).cuda()
            leaf = lambda a, dt=torch.float32: a.detach().to(dt).requires_grad_()
            X, W = leaf(xp), leaf(w)
            out = fn(X, W, h)
            fwd_equal = torch.equal(out.detach(), lstm_cuda.lstm_bidirectional(xp, w, h))
            grads = torch.autograd.grad(out, (X, W), ct)
            Xp, Wp = leaf(xp), leaf(w)
            want = torch.autograd.grad(plain(Xp, Wp, h), (Xp, Wp), ct)
            X64, W64 = leaf(xp, torch.float64), leaf(w, torch.float64)
            exact = torch.autograd.grad(plain(X64, W64, h), (X64, W64), ct.double())
            torch.cuda.synchronize()
            diff = max(float((a - c).abs().max()) for a, c in zip(grads, want))
            err64 = max(float((a.double() - e).abs().max()) for a, e in zip(grads, exact))
            plain64 = max(float((a.double() - e).abs().max()) for a, e in zip(want, exact))
            row = {"shape": [t, b, h], "forward_bitwise": fwd_equal, "grad_max_abs_diff": diff,
                   "grad_bitwise": all(torch.equal(a, c) for a, c in zip(grads, want)),
                   "grad_err_vs_fp64": err64, "plain_grad_err_vs_fp64": plain64}
            if not (fwd_equal and diff <= 1e-6 and err64 <= 2 * plain64 + 1e-6):
                raise AssertionError(f"K2 under autograd {(t, b, h)}: {row}")
            if (t, b, h) == TRAIN_K2_SHAPE:
                with torch.no_grad():
                    row["forward_ms"] = cuda_ms(lambda: fn(X, W, h), reps=10)
                out = fn(X, W, h)
                row["backward_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(out, (X, W), ct, retain_graph=True), reps=5)
                row["plain_forward_backward_ms"] = cuda_ms(
                    lambda: torch.autograd.grad(plain(X, W, h), (X, W), ct), reps=3, warmup=1)
                row["bound_ms"], row["bound_by"] = k2_bound(t, b, h, 2)
                # one layer with its input projection, against cuDNN's bidirectional layer
                xin, wi, bi = leaf(x), leaf(w_ih), leaf(bias)
                with torch.no_grad():
                    row["layer_forward_ms"] = cuda_ms(
                        lambda: fn(torch.matmul(xin, wi.T) + bi, W, h), reps=10)
                row["layer_forward_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    fn(torch.matmul(xin, wi.T) + bi, W, h), (xin, wi, bi, W), ct), reps=5)
                cudnn = torch.nn.LSTM(2 * h, h, bidirectional=True).cuda()
                with torch.no_grad():
                    row["library_forward_ms"] = cuda_ms(lambda: cudnn(xin), reps=10)
                row["library_forward_backward_ms"] = cuda_ms(lambda: torch.autograd.grad(
                    cudnn(xin)[0], (xin, *cudnn.parameters()), ct), reps=5)
                row["card"] = card
            rows.append(row)
            log(f"K2 under autograd {json.dumps(row)}")
    return rows


def _state_err(a: dict, b: dict, keys) -> float:
    return max((float((a[k].cpu().double() - b[k].cpu().double()).abs().max()) for k in keys),
               default=0.0)


def phase_train_parity():
    """18b. One SGD step of tiny CaMN, DisCo and EMAGE at iteration 1, TF32 off, on the CPU
    and on the card."""
    from pantomatrix_tpu_torch.train.steps import BN_BUFFER_KEYS

    result = {}
    for family in ("camn", "disco", "emage"):
        runs = {}
        for device in ("cpu", "cuda"):
            model, _, step = train_setup(family, device, tiny=True, lr=0.1, optimizer="sgd")
            bs, frames = (2, 8) if family == "emage" else (2, 30)
            losses = step(train_batch(family, bs, frames, device, seed=11), 1)
            runs[device] = ({k: float(v) for k, v in losses.items()}, model.state_dict())
        (lc, sc), (lg, sg) = runs["cpu"], runs["cuda"]
        loss_rel = max(abs(lg[k] - lc[k]) / max(abs(lc[k]), 1e-30) for k in lc)
        buffers = [k for k in sc if k.rsplit(".", 1)[-1] in BN_BUFFER_KEYS]
        params = [k for k in sc if k not in buffers and sc[k].is_floating_point()]
        row = {"loss_max_rel_err": loss_rel, "param_max_abs_err": _state_err(sc, sg, params),
               "buffer_max_abs_err": _state_err(sc, sg, buffers)}
        if not (loss_rel <= TRAIN_LOSS_RTOL and row["param_max_abs_err"] <= TRAIN_PARAM_ATOL
                and row["buffer_max_abs_err"] <= TRAIN_BUFFER_ATOL):
            raise AssertionError(f"train parity CPU vs card, {family}: {row}")
        result[family] = row
    log(f"train parity CPU vs card (tiny configs, one SGD step, TF32 off): {json.dumps(result)}")
    return result


def run_train_cell(family: str, card, compute_dtype=None, **step_kw) -> dict:
    """TRAIN_STEPS Adam steps at the shipped learning rate on one fixed full-width batch:
    losses, K2 launches a step, median ms a step, frames per second, peak memory."""
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda

    bs, frames, lr = TRAIN_CELLS[family]
    model, opt, step = train_setup(family, "cuda", tiny=False, lr=lr,
                                   compute_dtype=compute_dtype, **step_kw)
    batch = train_batch(family, bs, frames, "cuda")
    key = "all" if family == "emage" else "all_loss"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lstm_cuda.launches = vq_cuda.launches = 0
    losses, walls = [], []
    for i in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = step(batch, i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append({k: float(v) for k, v in out.items()})
    k2_per_step, k2_rest = divmod(lstm_cuda.launches, TRAIN_STEPS)
    model_frames = batch["motion"].shape[1]
    step_ms = 1e3 * float(np.median(walls[1:]))
    cell = {"family": family, "mode": compute_dtype or "float32", **step_kw, "batch": bs,
            "frames_per_clip": model_frames, "steps": TRAIN_STEPS, "first_step_ms": 1e3 * walls[0],
            "median_step_ms": step_ms, "frames_per_s": bs * model_frames / (step_ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "k2_launches_per_step": k2_per_step, "k1_launches": vq_cuda.launches,
            "first_loss": losses[0][key], "last_loss": losses[-1][key],
            "losses": [x[key] for x in losses], "first_step_losses": losses[0], "card": card}
    finite = all(np.isfinite(v) for x in losses for v in x.values())
    if not (finite and cell["last_loss"] < cell["first_loss"]
            and k2_per_step == TRAIN_K2_PER_STEP[family] and k2_rest == 0
            and vq_cuda.launches == 0):
        raise AssertionError(f"train {family} {cell['mode']} {step_kw}: finite={finite}, "
                             f"{ {k: v for k, v in cell.items() if k != 'losses'} }")
    log(f"train cell {json.dumps({k: v for k, v in cell.items() if k != 'losses'})}")
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return cell


def phase_train_full_width(card):
    """18c. The three families at full width, fp32 and bf16; EMAGE also with gradient
    checkpointing (same first-step losses, less memory)."""
    cells = []
    for family in ("camn", "disco", "emage"):
        for mode in (None, "bfloat16"):
            cells.append(run_train_cell(family, card, mode))
    plain = next(c for c in cells if c["family"] == "emage" and c["mode"] == "float32")
    ckpt = run_train_cell("emage", card, None, gradient_checkpointing=True)
    cells.append(ckpt)
    rel = max(abs(ckpt["first_step_losses"][k] - v) / abs(v)
              for k, v in plain["first_step_losses"].items())
    if not (rel <= TRAIN_LOSS_RTOL and ckpt["peak_mem_gb"] < plain["peak_mem_gb"]):
        raise AssertionError(f"EMAGE gradient checkpointing: first-step losses rel {rel}, "
                             f"peak {ckpt['peak_mem_gb']} GB against {plain['peak_mem_gb']} GB")
    log(f"EMAGE gradient checkpointing: first-step losses within {rel:.2e} relative, peak "
        f"{ckpt['peak_mem_gb']:.2f} GB against {plain['peak_mem_gb']:.2f} GB")
    return cells, rel


def write_train_data(root: Path, takes: int = 2, seconds: int = 12) -> dict:
    """A synthetic BEAT2 training set from a numpy seed: ``takes`` takes of ``seconds``
    (speaker 2), with 128-frame clips for CaMN and DisCo (with labels) and 64-frame clips
    for EMAGE, stride 20, as the shipped configs read them."""
    rng = np.random.RandomState(18)
    for sub in ("smplxflame_30", "footcontact", "wave16k"):
        (root / sub).mkdir(parents=True)
    metas = {"camn": [], "emage": []}
    for i in range(takes):
        vid, n = f"2_scott_0_{i + 1}_{i + 1}", seconds * 30
        np.savez(root / "smplxflame_30" / f"{vid}.npz", betas=np.zeros(300, np.float32),
                 poses=rng.uniform(-0.5, 0.5, (n, 165)).astype(np.float32),
                 expressions=rng.normal(0, 0.5, (n, 100)).astype(np.float32),
                 trans=rng.normal(0, 0.3, (n, 3)).astype(np.float32),
                 model="smplx2020", gender="neutral", mocap_frame_rate=30)
        np.save(root / "footcontact" / f"{vid}.npy",
                (rng.uniform(size=(n, 4)) < 0.5).astype(np.float32))
        wav = np.clip(rng.normal(0, 0.2, n * 16000 // 30), -1, 1)
        with wave.open(str(root / "wave16k" / f"{vid}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((wav * 32767).astype("<i2").tobytes())
        for name, length in (("camn", 128), ("emage", 64)):
            for j, start in enumerate(range(0, n - length + 1, 20)):
                metas[name].append({
                    "video_id": vid, "mode": "train", "start_idx": start,
                    "end_idx": start + length,
                    "motion_path": str(root / "smplxflame_30" / f"{vid}.npz"),
                    "audio_path": str(root / "wave16k" / f"{vid}.wav"),
                    "content_label": j % 4, "rhythm_label": (i + j) % 3})
    paths = {}
    for name, m in metas.items():
        paths[name] = root / f"{name}.json"
        paths[name].write_text(json.dumps(m))
    return paths


def run_train_cli(family: str, meta: Path, out: Path, flags=(), launcher=(), env_extra=None) -> dict:
    """``python -m pantomatrix_tpu_torch.cli.train_<family> --device cuda`` at the shipped
    (full-width) config on the synthetic set, batch 8 unless ``flags`` say otherwise; its
    run directory and stdout. ``launcher`` goes before ``-m`` (torchrun), ``env_extra``
    into its environment."""
    import os

    cmd = [sys.executable, *launcher, "-m", f"pantomatrix_tpu_torch.cli.train_{family}",
           "--device", "cuda", f"data.meta_paths=['{meta}']", f"data.test_meta_paths=['{meta}']",
           "data.train_bs=8", f"output_dir={out}", "log_period=1", *flags]
    env = dict(os.environ, PYTHONPATH=str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""),
               **(env_extra or {}))
    t0 = time.time()
    r = subprocess.run(cmd, cwd=str(HERE), env=env, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"train_{family} {flags} failed ({r.returncode}):\n{r.stdout[-4000:]}\n"
                           f"{r.stderr[-4000:]}")
    (exp,) = [p for p in out.iterdir() if p.is_dir()]
    for f in ("ckpt/last.bin", "ckpt/last/pytorch_model.bin", "metrics.jsonl"):
        if not (exp / f).exists():
            raise AssertionError(f"train_{family} {flags}: no {f} in {exp}")
    steps = [json.loads(x)["step"] for x in (exp / "metrics.jsonl").read_text().splitlines()]
    return {"exp": exp, "stdout": r.stdout, "wall_s": wall, "steps": steps}


def phase_train_cli(card):
    """18d. The three train CLIs with --debug and the device-resident loader, a resume of
    the CaMN run from its last.bin, and the device-resident batches against the host
    loader's on the card."""
    from pantomatrix_tpu_torch.data.beat2 import BEAT2Dataset, DataLoader, to_device
    from pantomatrix_tpu_torch.data.device_data import DeviceResidentLoader

    from concurrent.futures import ThreadPoolExecutor

    result = {}
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        metas = write_train_data(root / "beat2")

        def debug_run(family, meta, flags):
            run = run_train_cli(family, meta, root / family, ("--debug", *flags))
            if "device-resident data: staged" not in run["stdout"] or run["steps"] != [1, 2, 3, 4]:
                raise AssertionError(f"train_{family} --debug: steps {run['steps']}\n"
                                     f"{run['stdout']}")
            result[family] = {"wall_s": run["wall_s"], "steps": run["steps"]}
            log(f"CLI train_{family} --debug: {run['wall_s']:.1f} s, metrics steps {run['steps']}")
            if family == "camn":
                last = run["exp"] / "ckpt" / "last.bin"
                resumed = run_train_cli("camn", meta, root / "camn_resumed", (
                    f"resume_from_checkpoint={last}", "solver.max_train_steps=6",
                    "validation.validation_steps=2", "validation.test_steps=0",
                    "solver.steps_per_dispatch=1"))
                if "at step 4" not in resumed["stdout"] or resumed["steps"] != [5, 6]:
                    raise AssertionError(f"CaMN resume: steps {resumed['steps']}\n"
                                         f"{resumed['stdout']}")
                result["camn_resume"] = {"wall_s": resumed["wall_s"], "steps": resumed["steps"]}
                log(f"CLI train_camn resumed from step 4: metrics steps {resumed['steps']}")

        # the three families' runs share the card at once: their walls are concurrent ones
        with ThreadPoolExecutor(3) as pool:
            for f in [pool.submit(debug_run, family, meta, flags) for family, meta, flags in (
                    ("camn", metas["camn"], ()), ("disco", metas["camn"], ()),
                    ("emage", metas["emage"], ("--random_vq",)))]:
                f.result()
        checked = {}
        for variant, fps, mask, meta in (("base", 15, "local_upper", metas["camn"]),
                                         ("disco", 15, "local_upper", metas["camn"]),
                                         ("emage_footcontact", 30, None, metas["emage"])):
            ds = BEAT2Dataset([str(meta)], "train", fps, 16000, mask, variant=variant)
            host = DataLoader(ds, 8, seed=5)
            dev = DeviceResidentLoader(host, "cuda")
            batches = 0
            for idx, hb in zip(dev, host):
                got, want = dev.place_batch(idx), to_device(hb, "cuda")
                if set(got) != set(want) or not all(torch.equal(got[k], want[k]) for k in got):
                    raise AssertionError(f"device-resident {variant}: batch {batches} differs")
                batches += 1
            checked[variant] = {"batches": batches, "staged_mb": dev.staged_bytes / 2**20,
                                "audio_dtype": str(dev.buffers["audio"].dtype)}
        result["device_resident_equal"] = checked
        log(f"device-resident batches equal the host loader's on the card: {json.dumps(checked)}")
    return result


def phase_train(card):
    """18. Training: K2 under autograd, CPU/card parity, full width, the CLIs."""
    t0 = time.time()
    result = {"card": card, "k2_autograd": phase_train_k2(card),
              "parity": phase_train_parity()}
    result["cells"], result["checkpointing_loss_rel"] = phase_train_full_width(card)
    result["cli"] = phase_train_cli(card)
    result["seconds"] = time.time() - t0
    log(f"training phase: {result['seconds']:.1f} s")
    return result


PREP_TAKES = {"train": 6, "val": 1, "test": 1}  # phase 19's corpus: 8 takes of 20 s
PREP_FRAMES = 20 * 30
FOOT_THRESHOLD = 0.01
FOOT_NEAR_REL = 1e-6  # a float64 velocity this close (relative) to the threshold: a near-tie
VQ_CELL = (64, 64)  # the shipped emage_vq.yaml: train_bs 64, pose_length 64
VQ_STEPS = 10
VQ_LR = 2e-4  # the shipped learning rate
VQ_TINY = dict(vae_length=16, vae_codebook_size=16)
VQ_PARAM_ATOL = 1e-4
BENCH_K, BENCH_REPEATS = 2, 1  # 3, 2 until the smoke grew a visualization phase
BENCH_K2 = {"camn": 8, "disco": 4, "emage": 0}


def load_script(name: str):
    """A script of ``scripts/`` as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, HERE / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def quiet_main(main, argv) -> str:
    """``main(argv)`` with its standard output captured and returned."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


def phase_prep(card, root: Path):
    """19a. A synthetic BEAT2 (scripts/torch_make_synth_beat2.py's takes) and an SMPL-X
    archive at the real shapes; cli.preprocess index, footcontact on the card and disco;
    foot contact on the card against the CPU's."""
    import os

    from pantomatrix_tpu_torch.cli import preprocess as cli
    from pantomatrix_tpu_torch.core.smplx import SmplxModel, load_smplx, read_smplx
    from pantomatrix_tpu_torch.data import preprocess

    t0 = time.time()
    beat2 = root / "beat2"
    load_script("torch_make_synth_beat2").write_layout(
        str(beat2), PREP_TAKES["train"], PREP_TAKES["val"], PREP_TAKES["test"], 8, PREP_FRAMES,
        PREP_FRAMES, 19)
    archive = write_smplx_archive(root / "SMPLX_NEUTRAL_2020.npz", np.random.RandomState(19))
    result = {"takes": sum(PREP_TAKES.values()), "take_seconds": PREP_FRAMES / 30,
              "write_s": time.time() - t0}
    index = lambda n: quiet_main(cli.main, ["index", "--beat2_root", str(beat2), "--output_dir",
                                            str(root / "data_json"), "--length", str(n)]).strip()
    metas = {64: index(64), 128: index(128)}
    motion = str(beat2 / "smplxflame_30")
    before = os.environ.get("SMPLX_MODEL_PATH")
    os.environ["SMPLX_MODEL_PATH"] = str(archive)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        quiet_main(cli.main, ["footcontact", "--motion_dir", motion, "--output_dir",
                              str(beat2 / "footcontact"), "--device", "cuda"])
        torch.cuda.synchronize()
        result["footcontact_card_s"] = time.perf_counter() - t0
    finally:
        if before is None:
            os.environ.pop("SMPLX_MODEL_PATH")
        else:
            os.environ["SMPLX_MODEL_PATH"] = before
    t0 = time.perf_counter()
    cpu = preprocess.extract_foot_contact(motion, str(root / "footcontact_cpu"),
                                          model=load_smplx(str(archive), "cpu"))
    result["footcontact_cpu_s"] = time.perf_counter() - t0
    exact, exempt, values, contact = None, 0, 0, 0.0
    for path in cpu:
        name = Path(path).name
        got, want = np.load(beat2 / "footcontact" / name), np.load(path)
        values += got.size
        contact += float(got.sum())
        differ = got != want
        if differ.any():
            if exact is None:
                exact = SmplxModel.from_numpy(read_smplx(str(archive)), "cpu", torch.float64)
            v64 = preprocess.foot_velocities(exact, *preprocess.read_take(
                os.path.join(motion, name.replace(".npy", ".npz"))))
            near = np.abs(v64 - FOOT_THRESHOLD) <= FOOT_NEAR_REL * FOOT_THRESHOLD
            if (differ & ~near).any():
                raise AssertionError(f"foot contact {name}: card and CPU differ away from the "
                                     f"threshold at {np.argwhere(differ & ~near)[:5].tolist()}")
            exempt += int(differ.sum())
    t0 = time.perf_counter()
    disco = quiet_main(cli.main, ["disco", "--json", metas[128]]).strip()
    result["disco_s"] = time.perf_counter() - t0
    labels = json.loads(Path(disco).read_text())
    if not all(0 <= d["content_label"] < 10 and 0 <= d["rhythm_label"] < 10 for d in labels):
        raise AssertionError("disco labels out of range")
    result.update({
        "footcontact_card_s_per_take": result["footcontact_card_s"] / len(cpu),
        "footcontact_cpu_s_per_take": result["footcontact_cpu_s"] / len(cpu),
        "footcontact_values": values, "contact_share": contact / values,
        "near_threshold_exempt": exempt,
        "clips": {str(n): len(json.loads(Path(m).read_text())) for n, m in metas.items()},
        "disco_clips": len(labels), "smplx_vertices": SMPLX_V})
    log(f"preprocess: {json.dumps(result)} | {card}")
    return result, metas


def tiny_vq_suite(device, seed: int = 19):
    """The tiny tokenizer suite (codebooks of 16, vae_length 16, the global VAE at 24)."""
    from pantomatrix_tpu_torch.models import configs, emage_vq

    g = torch.Generator().manual_seed(seed)
    part = lambda dim: emage_vq.EmageVQVAE(configs.EmageVQVAEConvConfig(
        vae_test_dim=dim, **VQ_TINY), generator=g)
    return emage_vq.EmageVQSuite(
        face=part(106), upper=part(78), hands=part(180), lower=part(61),
        global_motion=emage_vq.EmageVAE(configs.EmageVAEConvConfig(
            vae_length=24, vae_test_dim=61), generator=g)).to(device)


def phase_vq_parity():
    """19b. One SGD step of the tiny suite with restarts, from the same usage state, on
    the CPU and on the card (TF32 off)."""
    from pantomatrix_tpu_torch.train.optim import make_optimizer
    from pantomatrix_tpu_torch.train.steps import RestartingOptimizer, make_vq_train_step

    k = VQ_TINY["vae_codebook_size"]
    rng = np.random.RandomState(19)
    usage = {p: rng.uniform(0, 2.0 / k, k).astype(np.float32)
             for p in ("face", "upper", "hands", "lower")}
    runs = {}
    for device in ("cpu", "cuda"):
        suite = tiny_vq_suite(device)
        opt = RestartingOptimizer(
            make_optimizer(suite.parameters(), learning_rate=0.1, optimizer="sgd"),
            {p: torch.tensor(u, device=device) for p, u in usage.items()})  # copies
        step = make_vq_train_step(suite, opt, restart_dead_codes=True, restart_decay=0.9,
                                  restart_thresh=0.5)
        losses = step(train_batch("emage", 8, 8, device, seed=19), 1)
        runs[device] = ({n: float(v) for n, v in losses.items()}, suite.state_dict(),
                        {p: d.cpu() for p, d in opt.dead.items()},
                        {p: u.cpu() for p, u in opt.usage.items()})
    (lc, sc, dc, uc), (lg, sg, dg, ug) = runs["cpu"], runs["cuda"]
    row = {"loss_max_rel_err": max(abs(lg[n] - lc[n]) / max(abs(lc[n]), 1e-30) for n in lc),
           "param_max_abs_err": _state_err(sc, sg, list(sc)),
           "dead_equal": all(torch.equal(dc[p], dg[p]) for p in dc),
           "restarted": {p: int(d.sum()) for p, d in dc.items()},
           "usage_max_abs_err": max(float((uc[p] - ug[p]).abs().max()) for p in uc),
           "usage_bitwise": all(torch.equal(uc[p], ug[p]) for p in uc)}
    if not (row["loss_max_rel_err"] <= TRAIN_LOSS_RTOL and row["param_max_abs_err"]
            <= VQ_PARAM_ATOL and row["dead_equal"] and row["usage_max_abs_err"] <= 1e-7
            and sum(row["restarted"].values()) > 0):
        raise AssertionError(f"VQ step CPU vs card: {row}")
    log(f"VQ step parity CPU vs card (tiny suite, restarts, one SGD step): {json.dumps(row)}")
    return row


def run_vq_cell(card, compute_dtype=None) -> dict:
    """VQ_STEPS Adam steps with restarts at the shipped learning rate on one fixed batch of
    VQ_CELL at the init_vq_suite widths, the codebooks initialized from the batch's
    encoder outputs as the CLI does (from the reference's U(-1/K, 1/K) codebooks the
    commitment losses climb for ~15 steps in both modes); then one step under
    torch.profiler."""
    from pantomatrix_tpu_torch.cli.train_emage_vq import data_init_codebooks
    from pantomatrix_tpu_torch.models.api import EmageVQModel
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda
    from pantomatrix_tpu_torch.train.optim import make_optimizer
    from pantomatrix_tpu_torch.train.steps import (
        RestartingOptimizer,
        make_vq_train_step,
        vq_usage_init,
    )

    suite = EmageVQModel.random(seed=42, device="cuda")
    opt = RestartingOptimizer(make_optimizer(suite.parameters(), learning_rate=VQ_LR),
                              vq_usage_init(suite))
    step = make_vq_train_step(suite, opt, compute_dtype=compute_dtype, restart_dead_codes=True,
                              seed=42)
    bs, frames = VQ_CELL
    batch = train_batch("emage", bs, frames, "cuda", seed=19)
    data_init_codebooks(suite, [{n: v.cpu().numpy() for n, v in batch.items()}], seed=42)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lstm_cuda.launches = vq_cuda.launches = 0
    losses, walls = [], []
    for i in range(VQ_STEPS):
        t0 = time.perf_counter()
        out = step(batch, i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append({n: float(v) for n, v in out.items()})
    k1, k2 = vq_cuda.launches, lstm_cuda.launches
    step_ms = 1e3 * float(np.median(walls[1:]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        step(batch, VQ_STEPS)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    device_ms = sum(by_name.values())
    cell = {"mode": compute_dtype or "float32", "batch": bs, "frames": frames,
            "steps": VQ_STEPS, "first_step_ms": 1e3 * walls[0], "median_step_ms": step_ms,
            "frames_per_s": bs * frames / (step_ms / 1e3),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kernels_a_step": len(kernels), "device_ms": device_ms,
            "top_kernels_ms": dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:5]),
            "idle_unprofiled": 1 - device_ms / step_ms, "k1_launches": k1, "k2_launches": k2,
            "first_step_losses": losses[0],
            "first_loss": losses[0]["all_loss"], "last_loss": losses[-1]["all_loss"],
            "restarted": {p: sum(x[f"restarted_{p}"] for x in losses)
                          for p in ("face", "upper", "hands", "lower")},
            "last_perplexity": {p: losses[-1][f"ppl_{p}"]
                                for p in ("face", "upper", "hands", "lower")}, "card": card}
    finite = all(np.isfinite(v) for x in losses for v in x.values())
    if not (finite and cell["last_loss"] < cell["first_loss"] and k1 == 0 and k2 == 0):
        raise AssertionError(f"VQ step {cell['mode']}: finite={finite}, {cell}")
    log(f"VQ train cell {json.dumps(cell)}")
    del suite, opt, step, batch
    torch.cuda.empty_cache()
    return cell


def run_cli_in_process(main, argv) -> float:
    """``main()`` with ``sys.argv`` = ``argv`` and its standard output captured; its wall
    seconds, the card synchronized."""
    old = sys.argv
    sys.argv = argv
    try:
        t0 = time.time()
        quiet_main(lambda _: main(), None)
        torch.cuda.synchronize()
        return time.time() - t0
    finally:
        sys.argv = old


def phase_vq_cli(card, root: Path, metas: dict) -> dict:
    """19d. cli.train_emage_vq --debug on the corpus (its validation decodes from indices:
    no K1), the export read back and decoded against the best-val state, and
    cli.train_emage --vq_path on the export (K1 counted in its validation, and held
    against its plain version at that validation's batch shapes)."""
    from pantomatrix_tpu_torch.cli import train_emage, train_emage_vq
    from pantomatrix_tpu_torch.data.beat2 import BEAT2Dataset, DataLoader
    from pantomatrix_tpu_torch.models.api import EmageVQModel
    from pantomatrix_tpu_torch.models.configs import EmageAudioConfig
    from pantomatrix_tpu_torch.models.emage_vq import vq_decode
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda
    from pantomatrix_tpu_torch.train.ckpt import load_train_state
    from pantomatrix_tpu_torch.utils.config import load_config

    val = BEAT2Dataset([metas[64]], "val", 30, 16000, None, variant="emage_footcontact")
    data = [f"data.meta_paths=['{metas[64]}']", f"data.test_meta_paths=['{metas[64]}']",
            "log_period=1"]
    out = root / "vq"
    lstm_cuda.launches = vq_cuda.launches = 0
    wall = run_cli_in_process(train_emage_vq.main, [
        "train_emage_vq", "--debug", "--device", "cuda", f"output_dir={out}", *data])
    k1, k2 = vq_cuda.launches, lstm_cuda.launches
    (exp,) = [p for p in out.iterdir() if p.is_dir()]
    missing = [f"{n}/{f}" for n in ("face", "upper", "hands", "lower", "global")
               for f in ("config.json", "model.safetensors")
               if not (exp / "emage_vq" / n / f).exists()]
    if missing or k1 != 0 or k2 != 0:
        raise AssertionError(f"train_emage_vq --debug: missing {missing}, K1 {k1} (want 0: "
                             f"the round trip decodes from indices), K2 {k2}")
    live = EmageVQModel.random(seed=0, device="cuda")
    best_step, _ = load_train_state(str(exp / "ckpt" / "best.bin"), live)
    loaded = EmageVQModel.from_pretrained(str(exp), device="cuda")
    g = torch.Generator().manual_seed(19)
    idx = {f"{p}_index": torch.randint(0, 256, (2, 64), generator=g).cuda()
           for p in ("upper", "hands", "lower")}
    lat = torch.randn(2, 64, 256, generator=g).cuda()
    ref = torch.zeros(2, 1, 3, device="cuda")
    decode = lambda s: vq_decode(s, face_latent=lat, get_global_motion=True, ref_trans=ref,
                                 **idx)
    a, b = decode(live), decode(loaded)
    if not all(torch.equal(a[n], b[n]) for n in a):
        raise AssertionError("the exported suite decodes unlike the best-val state")

    # cli.train_emage --vq_path at the shipped config, batch 8: its validation decodes
    # the parts with a latent head and no index head through K1, once per val batch each
    emage_out = root / "emage_on_vq"
    cfg = EmageAudioConfig.from_dict(load_config(str(
        HERE / "pantomatrix_tpu_torch" / "configs" / "emage_audio.yaml")).model.to_dict())
    latent_parts = sum(getattr(cfg, "l" + p) > 0 and getattr(cfg, "c" + p) == 0
                       for p in "fuhl")
    val_sizes = [len(x["motion"]) for x in DataLoader(val, min(8, len(val)), shuffle=False)]
    lstm_cuda.launches = vq_cuda.launches = 0
    emage_wall = run_cli_in_process(train_emage.main, [
        "train_emage", "--debug", "--vq_path", str(exp), "--device", "cuda",
        "data.train_bs=8", f"output_dir={emage_out}", *data])
    k1_emage = vq_cuda.launches
    (emage_exp,) = [p for p in emage_out.iterdir() if p.is_dir()]
    lines = [json.loads(x) for x in (emage_exp / "metrics.jsonl").read_text().splitlines()]
    steps = [x["step"] for x in lines if "all" in x]  # train lines; val lines have val/metric
    vals = [x["val/metric"] for x in lines if "val/metric" in x]
    want_k1 = latent_parts * len(val_sizes) * len(vals)
    if (steps != [1, 2, 3, 4] or len(vals) != 2 or not np.all(np.isfinite(vals))
            or k1_emage != want_k1 or k1_emage == 0):
        raise AssertionError(f"train_emage --vq_path: steps {steps}, val {vals}, K1 "
                             f"{k1_emage} (want {want_k1})")
    # K1 at the shapes that validation gave it: (val batch x 64 frames, 256) against
    # the suite's 256-code books
    k1_rows = []
    with strict_fp32():
        for n in sorted({bs * 64 for bs in val_sizes}):
            row = k1_check(torch.randn(n, 256, generator=g).cuda(),
                           torch.randn(256, 256, generator=g).cuda(), "cuda")
            k1_rows.append(row)
            log(f"K1 vq_nearest_code at train_emage's val batch {row}")
    result = {"wall_s": wall, "launches_vq_val": k1, "best_step": best_step,
              "export_decodes_equal": True,
              "train_emage_on_export": {"wall_s": emage_wall, "steps": steps,
                                        "val_metric": vals, "val_batch_sizes": val_sizes,
                                        "launches_train_emage_val": k1_emage,
                                        "k1_by_shape": k1_rows},
              "card": card}
    log(f"CLI train_emage_vq --debug: {json.dumps(result)}")
    return result


def phase_bench_train(card) -> list:
    """19e. cli.bench_train for the three families in fp32 and bf16 at --k BENCH_K,
    --repeats BENCH_REPEATS: each line parses, mfu < 1, K2 8 / 4 / 0 a step, K1 none."""
    import gc

    from pantomatrix_tpu_torch.cli import bench_train

    rows = []
    for family in ("camn", "disco", "emage"):
        for dtype in ("float32", "bfloat16"):
            text = quiet_main(bench_train.main, [
                "--family", family, "--dtype", dtype, "--k", str(BENCH_K), "--repeats",
                str(BENCH_REPEATS)])
            line = json.loads(text.strip().splitlines()[-1])
            log(f"bench_train {text.strip().splitlines()[-1]}")
            if not (line["mfu"] < 1 and line["k2_launches_per_step"] == BENCH_K2[family]
                    and line["k1_launches"] == 0 and line["card"] == card):
                raise AssertionError(f"bench_train {family} {dtype}: {line}")
            rows.append(line)
            gc.collect()
            torch.cuda.empty_cache()
    return rows


def phase_pretrain(card):
    """19. Tokenizer pretraining and data preparation."""
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        result = {"card": card}
        result["preprocess"], metas = phase_prep(card, root)
        result["vq_parity"] = phase_vq_parity()
        result["vq_cells"] = [run_vq_cell(card, mode) for mode in (None, "bfloat16")]
        fp32, bf16 = (c["first_loss"] for c in result["vq_cells"])
        result["vq_bf16_first_loss_rel"] = abs(bf16 - fp32) / abs(fp32)
        if not result["vq_bf16_first_loss_rel"] < 0.02:  # the train tests' bf16 bound
            raise AssertionError(f"VQ step bf16 first loss {bf16} against fp32 {fp32}")
        result["vq_cli"] = phase_vq_cli(card, root, metas)
    result["bench_train"] = phase_bench_train(card)
    result["seconds"] = time.time() - t0
    log(f"pretraining phase: {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# 20. visualization
# ---------------------------------------------------------------------------
VIZ_SECONDS = 20
VIZ_FRAMES = VIZ_SECONDS * 30
VIZ_FK_ATOL = 1e-4
VIZ_PIXEL_SHARE = 1e-3  # frames from the card's FK against the CPU's: differing pixels
VIZ_COEF_SHARE = 1e-4   # JPEG coefficients off by one (rounding near-ties), card vs CPU
VIZ_CHUNK = 64


def sphere_mesh(rings: int, segs: int, radii, centre):
    """A closed UV sphere scaled to ``radii``: (rings * segs + 2, 3) vertices and
    (2 * rings * segs, 3) faces, each between neighbouring vertices."""
    th = np.pi * (np.arange(rings) + 1) / (rings + 1)
    ph = 2 * np.pi * np.arange(segs) / segs
    ring = np.stack([np.sin(th)[:, None] * np.cos(ph), np.cos(th)[:, None] * np.ones(segs),
                     np.sin(th)[:, None] * np.sin(ph)], -1).reshape(-1, 3)
    verts = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]]) * radii + centre
    at = lambda r, c: 1 + r * segs + c % segs
    south = rings * segs + 1
    faces = [f for c in range(segs)
             for f in ((0, at(0, c + 1), at(0, c)), (south, at(rings - 1, c), at(rings - 1, c + 1)))]
    faces += [f for r in range(rings - 1) for c in range(segs)
              for f in ((at(r, c), at(r, c + 1), at(r + 1, c)),
                        (at(r, c + 1), at(r + 1, c + 1), at(r + 1, c)))]
    return verts, np.asarray(faces, np.int64)


def write_surface_archive(archive: Path, rng) -> Path:
    """A synthetic SMPLX_NEUTRAL_2020.npz at the real shapes (V = 10475, F = 20908) whose
    faces join neighbouring vertices of closed surfaces: a body-sized ellipsoid (100 x 104
    grid, 10402 vertices, 20800 faces) and a head sphere (6 x 9, 56 vertices, 108 faces);
    the 17 vertices left over sit on the head and no face uses them. The skinning is
    smooth, as a body's is: each joint sits on a body vertex (spread over the surface) and
    a vertex's weights fall off with its distance to the joints (Gaussian, 0.2 m); the
    blend shapes are drawn from ``rng`` at 0.5 mm, so that they move a vertex by a few mm,
    under the 10-18 mm between neighbours. (write_smplx_archive's random weights and 1 cm
    blend shapes crumple the surface into slivers ~25 px long: a workload no body gives
    the rasterizer.)"""
    from pantomatrix_tpu_torch.eval.fgd_encoder import SMPLX_PARENTS

    body_v, body_f = sphere_mesh(100, 104, np.array([0.22, 0.9, 0.14]), np.array([0, 0.9, 0]))
    head_v, head_f = sphere_mesh(6, 9, np.array([0.1, 0.12, 0.1]), np.array([0, 1.9, 0]))
    spare = np.repeat(head_v[:1], SMPLX_V - len(body_v) - len(head_v), axis=0)
    verts = np.concatenate([body_v, head_v, spare]).astype(np.float32)
    faces = np.concatenate([body_f, head_f + len(body_v)])
    assert verts.shape == (SMPLX_V, 3) and faces.shape == (SMPLX_F, 3)
    v = SMPLX_V
    kintree = np.zeros((2, 55), np.int64)
    kintree[0] = [2**32 - 1] + list(SMPLX_PARENTS[1:])
    kintree[1] = np.arange(55)
    jreg = np.zeros((55, v), np.float32)
    jreg[np.arange(55), np.arange(55) * (len(body_v) // 55)] = 1.0
    d2 = ((verts[:, None] - verts[np.arange(55) * (len(body_v) // 55)][None]) ** 2).sum(-1)
    weights = np.exp(-d2 / (2 * 0.2 ** 2)).astype(np.float32) + 1e-6
    bary = rng.uniform(0.1, 1, (51, 3))
    np.savez(archive, v_template=verts,
             shapedirs=rng.normal(0, 5e-4, (v, 3, 400)).astype(np.float32),
             posedirs=rng.normal(0, 5e-4, (v, 3, 486)).astype(np.float32),
             J_regressor=jreg, kintree_table=kintree,
             weights=weights / weights.sum(1, keepdims=True),
             hands_meanl=rng.normal(0, 0.1, 45).astype(np.float32),
             hands_meanr=rng.normal(0, 0.1, 45).astype(np.float32), f=faces,
             lmk_faces_idx=rng.randint(0, SMPLX_F, 51).astype(np.int64),
             lmk_bary_coords=(bary / bary.sum(1, keepdims=True)).astype(np.float32))
    return archive


class HostPeak:
    """The process's peak resident set (VmRSS, sampled every 5 ms) while it is entered."""

    def __enter__(self):
        import threading

        self.peak = self.start = self._rss()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5)

    @staticmethod
    def _rss() -> int:
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) * 1024 for line in f if line.startswith("VmRSS"))

    def _watch(self):
        while not self._stop.wait(0.005):
            self.peak = max(self.peak, self._rss())


def timed_cuda(fn):
    """(result, wall seconds) of ``fn()``, the card synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def chunked(fn, x, size: int = VIZ_CHUNK):
    """``fn`` over chunks of x's first axis, concatenated."""
    outs = [fn(x[s:s + size]) for s in range(0, x.shape[0], size)]
    return torch.cat(outs) if isinstance(outs[0], torch.Tensor) else np.concatenate(outs)


def pixels_differ(a, b) -> int:
    a, b = (torch.as_tensor(np.asarray(x)) if not isinstance(x, torch.Tensor) else x.cpu()
            for x in (a, b))
    return int((a != b).any(-1).sum())


def phase_viz_clis(root: Path, wav_dir: Path) -> dict:
    """20b. cli.test_emage and cli.test_camn with --visualization on the take, in
    process; K1 / K2 launches counted over each run."""
    from pantomatrix_tpu_torch.cli import test_camn, test_emage
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda
    from pantomatrix_tpu_torch.viz.avi import read_avi

    out = {}
    for name, main, videos in (
            ("emage", test_emage.main, {"_2dface": (512, 512), "_2dbody": (480, 720)}),
            ("camn", test_camn.main, {"_2dbody": (480, 720)})):
        save = root / f"cli_{name}"
        argv = ["--random_init", "--visualization", "--device", "cuda", "--audio_folder",
                str(wav_dir), "--save_folder", str(save)]
        torch.cuda.synchronize()
        vq_cuda.launches = lstm_cuda.launches = 0
        t0 = time.time()
        printed = quiet_main(main, argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        k1, k2 = vq_cuda.launches, lstm_cuda.launches
        render_s = float(printed.split("render in ")[1].split()[0])
        frames = np.load(save / "take_output.npz")["poses"].shape[0]  # CaMN: 2 x 297
        for suffix, (w, h) in videos.items():
            avi = read_avi(str(save / f"take_output{suffix}.avi"))
            if (len(avi["jpegs"]), avi["width"], avi["height"], avi["fps"]) != (frames, w, h, 30):
                raise AssertionError(f"{name}{suffix}: {len(avi['jpegs'])} frames "
                                     f"{avi['width']} x {avi['height']} at {avi['fps']}, "
                                     f"want {frames}")
        want = {"emage": (k1 > 0 and k2 == 0), "camn": (k2 == 8 and k1 == 0)}[name]
        if not want:
            raise AssertionError(f"cli.test_{name} --visualization: K1 {k1}, K2 {k2} launches")
        out[name] = {"k1_launches": k1, "k2_launches": k2, "wall_s": wall, "render_s": render_s,
                     "frames": frames, "printed": printed.strip().splitlines()}
        log(f"20b cli.test_{name} --visualization: {printed.strip()} | K1 {k1}, K2 {k2} "
            f"launches, {wall:.1f} s")
    return out


def phase_viz(card):
    """20. Visualization on the card: the test CLIs with --visualization, then
    render_one_sequence and render_one_sequence_with_face of their take against the CPU."""
    import os

    from pantomatrix_tpu_torch.core.smplx import load_smplx
    from pantomatrix_tpu_torch.native import build, encode_scans, host_threads
    from pantomatrix_tpu_torch.viz import jpeg, mesh_video, render2d
    from pantomatrix_tpu_torch.viz.avi import read_avi, write_avi_jpegs

    t_phase = time.time()
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)
    rng = np.random.RandomState(20)
    archive = write_surface_archive(root / "SMPLX_NEUTRAL_2020.npz", rng)
    os.environ["SMPLX_MODEL_PATH"] = str(archive)
    t0 = time.time()
    libs = [build(n) for n in ("rasterizer", "jpeg")]
    result = {"card": card, "host_cpus": os.cpu_count(), "rasterizer_threads": host_threads(),
              "g++_build_s": time.time() - t0,
              "libraries": [str(p.relative_to(HERE)) for p in libs]}
    log(f"20a surface archive V = {SMPLX_V}, F = {SMPLX_F}; g++ build "
        f"{result['g++_build_s']:.1f} s -> {result['libraries']}")
    wav_dir = root / "audio"
    wav_dir.mkdir()
    write_wav(wav_dir / "take.wav", VIZ_SECONDS)
    result["clis"] = phase_viz_clis(root, wav_dir)

    # 20c. the take's two mesh videos on the card, timed, memory watched
    pred_npz = root / "cli_emage" / "take_output.npz"
    pred = dict(np.load(pred_npz, allow_pickle=True))
    gt_npz = root / "gt.npz"
    np.savez(gt_npz, betas=np.zeros(300, np.float32),
             poses=rng.uniform(-0.4, 0.4, (VIZ_FRAMES, 165)).astype(np.float32),
             expressions=rng.uniform(-1, 1, (VIZ_FRAMES, 100)).astype(np.float32),
             trans=rng.uniform(-0.1, 0.1, (VIZ_FRAMES, 3)).astype(np.float32))
    gt = dict(np.load(gt_npz))
    card_model, cpu_model = load_smplx(str(archive), "cuda"), load_smplx(str(archive), "cpu")
    wav = str(wav_dir / "take.wav")
    renders = {}
    for name, call in (
            ("render_one_sequence", lambda out: mesh_video.render_one_sequence(
                str(pred_npz), str(gt_npz), str(out), wav, model=card_model)),
            ("render_one_sequence_with_face", lambda out: (
                mesh_video.render_one_sequence_with_face(str(pred_npz), str(out), wav,
                                                         model=card_model)))):
        torch.cuda.reset_peak_memory_stats()
        with HostPeak() as mem:
            path, wall = timed_cuda(lambda: call(root / name))
        avi = read_avi(path)  # raises unless idx1 points at the movi chunks
        if (len(avi["jpegs"]), len(avi["audio"])) != (VIZ_FRAMES, VIZ_SECONDS * 16000):
            raise AssertionError(f"{name}: {len(avi['jpegs'])} frames, {len(avi['audio'])} "
                                 f"samples")
        renders[name] = {"wall_s": wall, "frames_per_s": VIZ_FRAMES / wall,
                         "width": avi["width"], "height": avi["height"],
                         "bytes": Path(path).stat().st_size,
                         "host_rss_start_bytes": mem.start, "host_rss_peak_bytes": mem.peak,
                         "device_peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"20c {name}: {VIZ_FRAMES} frames {avi['width']} x {avi['height']}, "
            f"{len(avi['audio'])} samples, idx1 consistent; {wall:.2f} s "
            f"({VIZ_FRAMES / wall:.1f} frames/s); host RSS {mem.start / 2**30:.2f} -> "
            f"{mem.peak / 2**30:.2f} GiB, device peak "
            f"{renders[name]['device_peak_bytes'] / 2**30:.2f} GiB")
    t0 = time.time()
    render2d.render2d(pred, str(root / "render2d.avi"), model=card_model)
    torch.cuda.synchronize()
    render2d_s = time.time() - t0

    # 20c. each stage of those calls on the card against the same stage on the CPU, timed
    streams = {"pred": (pred, {}), "gt": (gt, {}),
               "head": (pred, {"zero_body": True, "scale": 7.0, "y_shift": 10.0})}
    verts, fk_err, fk_s = {}, {}, 0.0
    for name, (data, kw) in streams.items():
        on_card, s = timed_cuda(lambda: mesh_video._fk_vertices(card_model, data, **kw))
        fk_s += s
        on_cpu = mesh_video._fk_vertices(cpu_model, data, **kw)
        fk_err[name] = float(np.abs(on_card - on_cpu).max())
        verts[name] = (on_card, on_cpu)
    if max(fk_err.values()) > VIZ_FK_ATOL:
        raise AssertionError(f"FK vertices card vs CPU: {fk_err}")

    def skeleton(model):
        joints = render2d.joints_from_motion(model, pred, remove_global=True)
        to_frames = lambda j: render2d.draw_frames(
            render2d.project_perspective(j, 1000.0, 720, 480, (0.0, -1.0, 3.0)), 720, 480)
        return joints, to_frames

    joints, to_frames = skeleton(card_model)
    sk_card, draw_s = timed_cuda(lambda: chunked(to_frames, joints))
    cpu_joints, cpu_to_frames = skeleton(cpu_model)
    counts = {"skeleton": pixels_differ(sk_card, chunked(cpu_to_frames, cpu_joints))}
    del sk_card

    raster_s, side = 0.0, []
    for name, (on_card, on_cpu) in verts.items():
        t0 = time.time()
        frames = mesh_video.render_frames(on_card, card_model.faces)
        raster_s += time.time() - t0
        counts[f"mesh_{name}"] = pixels_differ(frames, mesh_video.render_frames(
            on_cpu, cpu_model.faces))
        if name != "head":
            side.append(frames)
    n_px = VIZ_FRAMES * 720 * 480
    if max(counts.values()) > VIZ_PIXEL_SHARE * n_px:
        raise AssertionError(f"pixels that differ, card vs CPU, of {n_px}: {counts}")

    # JPEG: render_one_sequence's side-by-side RGB frames, flipped to BGR and transformed
    # on each device (on the card: copy in, transform, copy out, each timed)
    side = torch.as_tensor(np.concatenate(side, axis=2))
    q_card, jpeg_s = [], {"h2d": 0.0, "device": 0.0, "d2h": 0.0}
    for s in range(0, VIZ_FRAMES, VIZ_CHUNK):
        on_card, t = timed_cuda(lambda: side[s:s + VIZ_CHUNK].cuda())
        jpeg_s["h2d"] += t
        q, t = timed_cuda(lambda: jpeg.quantized_blocks(on_card.flip(-1)))
        jpeg_s["device"] += t
        q, t = timed_cuda(lambda: q.cpu())
        jpeg_s["d2h"] += t
        q_card.append(q)
    q_card = torch.cat(q_card)
    coef = {"total": q_card.numel(), "off_by_one": 0, "off_by_more": 0}
    for s in range(0, VIZ_FRAMES, VIZ_CHUNK):
        delta = (q_card[s:s + VIZ_CHUNK].to(torch.int32) - jpeg.quantized_blocks(
            side[s:s + VIZ_CHUNK].flip(-1)).to(torch.int32)).abs()
        coef["off_by_one"] += int((delta == 1).sum())
        coef["off_by_more"] += int((delta > 1).sum())
    del side, delta
    if coef["off_by_more"] or coef["off_by_one"] > VIZ_COEF_SHARE * coef["total"]:
        raise AssertionError(f"JPEG coefficients card vs CPU: {coef}")
    codes, sizes = jpeg._code_tables()
    t0 = time.time()
    scans = encode_scans(q_card.numpy(), jpeg.MCU_COMPONENT, jpeg.MCU_DC_TABLE,
                         jpeg.MCU_AC_TABLE, codes, sizes)
    jpeg_host_s = time.time() - t0
    del q_card
    head = jpeg.jpeg_header(720, 960)
    payloads = [head + sc + b"\xff\xd9" for sc in scans]
    t0 = time.time()
    write_avi_jpegs(str(root / "write.avi"), payloads, VIZ_FRAMES, 960, 720, 30)
    write_s = time.time() - t0

    per = lambda s, n: 1e3 * s / n
    result.update({
        "fk_max_abs_err": fk_err, "pixels": n_px, "pixels_differ": counts,
        "jpeg_coefficients": coef, "renders": renders,
        "ms_per_frame": {
            "fk": per(fk_s, 3 * VIZ_FRAMES), "draw": per(draw_s, VIZ_FRAMES),
            "rasterize": per(raster_s, 3 * VIZ_FRAMES),
            "jpeg_copy_in_960x720": per(jpeg_s["h2d"], VIZ_FRAMES),
            "jpeg_device_960x720": per(jpeg_s["device"], VIZ_FRAMES),
            "jpeg_copy_out_960x720": per(jpeg_s["d2h"], VIZ_FRAMES),
            "jpeg_host_960x720": per(jpeg_host_s, VIZ_FRAMES),
            "write": per(write_s, VIZ_FRAMES)},
        "render2d_frames_per_s": VIZ_FRAMES / render2d_s,
        "seconds": time.time() - t_phase})
    log(f"20c FK card vs CPU {fk_err}; pixels differing of {n_px}: {counts}; JPEG "
        f"coefficients {coef}")
    log(f"20d ms a frame {json.dumps(result['ms_per_frame'])}; render2d "
        f"{result['render2d_frames_per_s']:.1f} frames/s; {os.cpu_count()} host CPUs; "
        f"{card}")
    tmp.cleanup()
    log(f"visualization phase: {result['seconds']:.1f} s")
    return result

MP_STEPS = 3  # SGD steps of every world-1 run
MP_CELLS = ("camn", "emage")  # at TRAIN_CELLS' batches and widths
MP_TAKES, MP_SECONDS = 4, 40  # 216 CaMN clips of 128 frames, 228 EMAGE clips of 64
MP_CLI_FLAGS = ("solver.optimizer=sgd", "solver.compute_dtype=float32",
                f"solver.max_train_steps={MP_STEPS}", "solver.steps_per_dispatch=1",
                f"validation.validation_steps={MP_STEPS}", "validation.test_steps=0")
# (loss rtol, parameter atol) of the world-1 CLIs: tests/test_torch_multiprocess.py's
# bounds; CaMN shares DisCo's geodesic term whose clamped arccos makes its steps
# ill-conditioned (see there), EMAGE does not
MP_BOUNDS = {"camn": (5e-5, 1e-5), "emage": (1e-5, 1e-6)}


def mp_runs():
    """``tests/_torch_mp_runs.py``: the tiny multi-process runs, their launcher and the
    comparison of two runs, shared with tests/test_torch_multiprocess.py."""
    sys.path.insert(0, str(HERE / "tests"))
    import _torch_mp_runs

    return _torch_mp_runs


def beyond_noise(got: dict, want: dict, again: dict) -> float:
    """How far the tensors ``got`` stray from ``want`` beyond twice the run-to-run spread
    of the same program (the largest ``|again - want|`` over all of them), each allowed
    4 float32 ulps at its largest magnitude besides (0: within). Two single-process runs
    on the card are not bitwise equal (nondeterministic backward kernels), so from step 2
    on every run starts from slightly other weights: one repeat measured losses 0-2 ulps
    apart, which one sample of the spread can miss."""
    err = lambda a, b: float((a.double() - b.double()).abs().max())
    spread = max(err(again[k], v) for k, v in want.items())
    return max(max(err(got[k], v) - 4 * float(np.spacing(np.float32(v.abs().max())))
                   - 2 * spread, 0.0) for k, v in want.items())


def mp_world1_cell(family: str, mesh, card) -> dict:
    """21a, in process: MP_STEPS SGD steps (TF32 off) of the full-width cell without a
    mesh, on the world-1 NCCL mesh, and without again (the run-to-run spread): losses and
    parameters of the mesh run against the first run (the first step's losses bitwise:
    the forward is deterministic and every collective at size 1 a copy; the rest within
    ``beyond_noise``), step ms of each, K2 launches a step on the mesh run, and the
    gradient all-reduce's bytes and CUDA-event ms."""
    from pantomatrix_tpu_torch.ops import lstm_cuda
    from pantomatrix_tpu_torch.train.mesh import reduce_gradients

    bs, frames, lr = TRAIN_CELLS[family]
    batch = train_batch(family, bs, frames, "cuda")
    runs = {}
    for name in ("single", "world1", "single_again"):
        model, opt, step = train_setup(family, "cuda", tiny=False, lr=lr, optimizer="sgd",
                                       mesh=mesh if name == "world1" else None)
        torch.cuda.synchronize()
        lstm_cuda.launches = 0
        losses, walls = [], []
        for i in range(MP_STEPS):
            t0 = time.perf_counter()
            out = step(batch, i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(torch.stack([v.float() for _, v in sorted(out.items())]).cpu())
        row = {"step_ms": [1e3 * w for w in walls], "k2_launches": lstm_cuda.launches}
        if name == "world1":
            trainable = [p for p in model.parameters() if p.requires_grad]
            row["allreduce_bytes"] = reduce_gradients(trainable, mesh)
            row["allreduce_ms"] = cuda_ms(lambda: reduce_gradients(trainable, mesh), reps=10)
        row["losses"] = torch.stack(losses)
        row["state"] = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()
                        if v.is_floating_point()}
        runs[name] = row
        del model, opt, step
        torch.cuda.empty_cache()
    a, w, b = runs["single"], runs["world1"], runs["single_again"]
    cell = {"family": family, "batch": bs, "frames": frames, "steps": MP_STEPS,
            "single_step_ms": float(np.median(a["step_ms"][1:])),
            "world1_step_ms": float(np.median(w["step_ms"][1:])),
            "single_again_step_ms": float(np.median(b["step_ms"][1:])),
            "k2_launches_per_step": w["k2_launches"] / MP_STEPS,
            "allreduce_bytes": w["allreduce_bytes"], "allreduce_ms": w["allreduce_ms"],
            "losses_bitwise": torch.equal(w["losses"], a["losses"]),
            "first_step_losses_bitwise": torch.equal(w["losses"][0], a["losses"][0]),
            "params_bitwise": all(torch.equal(w["state"][k], v) for k, v in a["state"].items()),
            "single_repeat_bitwise": all(torch.equal(b["state"][k], v)
                                         for k, v in a["state"].items()),
            "loss_max_abs_err": float((w["losses"] - a["losses"]).abs().max()),
            "loss_run_to_run": float((b["losses"] - a["losses"]).abs().max()),
            "param_max_abs_err": max(float((w["state"][k] - v).abs().max())
                                     for k, v in a["state"].items()),
            "param_run_to_run": max(float((b["state"][k] - v).abs().max())
                                    for k, v in a["state"].items()),
            "loss_beyond_noise": beyond_noise({"l": w["losses"]}, {"l": a["losses"]},
                                              {"l": b["losses"]}),
            "param_beyond_noise": beyond_noise(w["state"], a["state"], b["state"]),
            "card": card}
    finite = bool(torch.isfinite(w["losses"]).all())
    if not (finite and cell["first_step_losses_bitwise"] and cell["loss_beyond_noise"] == 0
            and cell["param_beyond_noise"] == 0
            and cell["k2_launches_per_step"] == TRAIN_K2_PER_STEP[family]
            and w["k2_launches"] % MP_STEPS == 0 and cell["allreduce_bytes"] > 0):
        raise AssertionError(f"world-1 NCCL {family}: finite={finite} {cell}")
    log(f"multi-process 21a {family} world 1 over NCCL: {json.dumps(cell)}")
    return cell


def mp_world1_clis(root: Path, card) -> dict:
    """21a, the CLIs: train_camn under torchrun (--nproc_per_node 1) and train_emage with
    the PANTO_* variables, both over NCCL at world 1, each against the CLI in one process
    without a process group, at the full-width cells and SGD in float32. The four runs
    share the card at once (the in-process part times the steps)."""
    from concurrent.futures import ThreadPoolExecutor

    metas = write_train_data(root / "beat2", MP_TAKES, MP_SECONDS)
    runs, result = {}, {}
    with ThreadPoolExecutor(4) as pool:
        for family in ("camn", "emage"):
            bs = TRAIN_CELLS[family][0]
            flags = (f"data.train_bs={bs}", *MP_CLI_FLAGS) + (
                ("--random_vq",) if family == "emage" else ())
            port = mp_runs().free_port()
            launch = {"camn": dict(launcher=("-m", "torch.distributed.run", "--nproc_per_node",
                                             "1", "--master_addr", "localhost",
                                             "--master_port", str(port))),
                      "emage": dict(env_extra={"PANTO_COORDINATOR": f"localhost:{port}",
                                               "PANTO_NUM_PROCESSES": "1",
                                               "PANTO_PROCESS_ID": "0"})}[family]
            runs[family] = (
                pool.submit(run_train_cli, family, metas[family], root / f"{family}_single",
                            flags),
                pool.submit(run_train_cli, family, metas[family], root / f"{family}_world1",
                            flags, **launch))
        for family, (single, world1) in runs.items():
            walls = (single.result()["wall_s"], world1.result()["wall_s"])
            row = mp_runs().compare_runs(root / f"{family}_single", [root / f"{family}_world1"],
                                         MP_BOUNDS[family])
            row.update(launch="torchrun" if family == "camn" else "PANTO_* variables",
                       batch=TRAIN_CELLS[family][0], pair_wall_s=max(walls), card=card)
            log(f"multi-process 21a CLI train_{family} world 1 over NCCL: {json.dumps(row)}")
            result[family] = row
    return result


def mp_two_ranks(root: Path, card) -> dict:
    """21b: the tiny runs of tests/test_torch_multiprocess.py (``tests/_torch_mp_runs.py``)
    on the card, two processes against one (gloo on a single card, where both processes
    share it; NCCL with two cards or more), all started together, at the test's bounds."""
    R = mp_runs()
    t0 = time.time()
    train_meta, test_meta = R.write_data(root / "tiny_beat2")
    outs = R.start_runs(R.RUNS, [f"data.meta_paths=['{train_meta}']",
                                 f"data.test_meta_paths=['{test_meta}']"], root, "cuda")
    result = {"wall_s": time.time() - t0, "card": card}
    for name, bounds in R.BOUNDS.items():
        row = R.compare_runs(outs[name.split("_")[0] + "_single"][0], outs[name], bounds)
        backend = re.search(r"backend (\w+)", (root / f"{name}_0.log").read_text())
        row["backend"] = backend.group(1) if backend else None
        result[name] = row
    log(f"multi-process 21b two processes on {torch.cuda.device_count()} card(s): "
        f"{json.dumps(result)}")
    return result


def phase_multiprocess(card):
    """21. Multi-process training: (a) world 1 over NCCL in process and through the CLIs,
    (b) two processes of the tiny runs, (c) dryrun_multichip(2, device="cuda"); (a)'s
    CLIs, (b) and (c) at once."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    import torch.distributed as dist

    from pantomatrix_tpu_torch.entry import dryrun_multichip
    from pantomatrix_tpu_torch.train.mesh import make_train_mesh, maybe_init_distributed

    t0 = time.time()
    result = {"card": card}
    env = {"PANTO_COORDINATOR": f"localhost:{mp_runs().free_port()}",
           "PANTO_NUM_PROCESSES": "1", "PANTO_PROCESS_ID": "0"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        maybe_init_distributed("cuda")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"world 1 on a card: backend {dist.get_backend()}, not nccl")
        result["world1"] = {f: mp_world1_cell(f, make_train_mesh(TRAIN_CELLS[f][0]), card)
                            for f in MP_CELLS}
    finally:
        dist.destroy_process_group()
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(2) as pool:
        t1 = time.time()
        (Path(tmp) / "world1").mkdir()
        (Path(tmp) / "two").mkdir()
        clis = pool.submit(mp_world1_clis, Path(tmp) / "world1", card)
        dryrun = pool.submit(dryrun_multichip, 2, "cuda")
        result["two_processes"] = mp_two_ranks(Path(tmp) / "two", card)
        result["dryrun"] = dryrun.result()
        result["world1_cli"] = clis.result()
        result["clis_two_processes_and_dryrun_s"] = time.time() - t1
    log(f"multi-process 21c dryrun_multichip(2, cuda): {json.dumps(result['dryrun'])}")
    result["seconds"] = time.time() - t0
    log(f"multi-process phase: {result['seconds']:.1f} s")
    return result


# ---------------------------------------------------------------------------
# 22. the last gaps: bench_train over processes, the ladder, the rotation helpers
# ---------------------------------------------------------------------------

GAPS_BENCH_CAMN = ("--family", "camn", "--dtype", "float32", "--k", "2", "--repeats", "1")
GAPS_BENCH_DISCO = ("--family", "disco", "--dtype", "float32", "--batch", "8", "--frames",
                    "32", "--k", "2", "--repeats", "1")
GAPS_LADDER_BATCH = (8, 64)  # clips x frames of 22c's ladder (the script's is 56 x 64)
GAPS_ROT_ATOL = 1e-5
GAPS_L5_RTOL = 1e-6


def run_bench_train_torchrun(nproc: int, flags) -> dict:
    """``python -m torch.distributed.run --nproc_per_node nproc -m
    pantomatrix_tpu_torch.cli.bench_train ...`` (its processes take the card, and pick
    gloo where more processes than cards share it): the one JSON line, and the wall."""
    import os

    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc_per_node", str(nproc),
           "--master_addr", "localhost", "--master_port", str(mp_runs().free_port()),
           "-m", "pantomatrix_tpu_torch.cli.bench_train", *flags]
    env = dict(os.environ, PYTHONPATH=str(HERE) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.time()
    r = subprocess.run(cmd, cwd=str(HERE), env=env, capture_output=True, text=True, timeout=600)
    wall = time.time() - t0
    if r.returncode != 0:
        raise RuntimeError(f"bench_train under torchrun x {nproc} failed ({r.returncode}):\n"
                           f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    lines = []
    for text in r.stdout.splitlines():
        if text.startswith("{"):
            lines.append(json.loads(text))
    if len(lines) != 1:
        raise AssertionError(f"bench_train under torchrun x {nproc}: {len(lines)} JSON lines\n"
                             f"{r.stdout[-4000:]}")
    return dict(lines[0], wall_s=wall)


def gaps_bench_nccl(card, in_process: dict) -> dict:
    """22a. cli.bench_train for CaMN fp32 as one process over NCCL under torchrun, beside
    phase 19e's in-process line: K2 8 a step, its forward FLOPs added to the count."""
    from pantomatrix_tpu_torch.ops.lstm_cuda import layer_flops

    a = run_bench_train_torchrun(1, GAPS_BENCH_CAMN)
    want_k2 = TRAIN_K2_PER_STEP["camn"] * layer_flops(*K2_BENCH_SHAPE)
    if not (a["processes"] == 1 and a["backend"] == "nccl" and a["cards"] == 1
            and a["k2_launches_per_step"] == 8 and a["k2_launches_per_step_by_process"] == [8]
            and a["mfu"] < 1 and a["k2_forward_flops"] == want_k2 and a["k1_launches"] == 0
            and np.isfinite(a["last_loss"]) and a["card"] == card):
        raise AssertionError(f"bench_train CaMN, 1 process over NCCL: {a} (K2 forward "
                             f"FLOPs want {want_k2})")
    log(f"22a bench_train camn fp32, 1 process over NCCL: {a['ms_per_step']:.1f} ms a step "
        f"(in process, phase 19e: {in_process['ms_per_step']:.1f}), mfu {a['mfu']:.4f} "
        f"(19e: {in_process['mfu']:.4f}), K2 forward {a['k2_forward_flops'] / 1e9:.1f} GFLOP "
        f"of {a['flops_per_step'] / 1e9:.1f}; {json.dumps(a)}")
    return a


def gaps_bench_gloo(card) -> dict:
    """22b. cli.bench_train for DisCo fp32 at 8 x 32 as two processes sharing the card
    over gloo under torchrun: K2 4 a step on each."""
    b = run_bench_train_torchrun(2, GAPS_BENCH_DISCO)
    if not (b["processes"] == 2 and b["cards"] == 1 and b["backend"] == "gloo"
            and b["local_batch"] == 4 and b["k2_launches_per_step_by_process"] == [4, 4]
            and np.isfinite(b["last_loss"]) and b["mfu"] < 1 and b["card"] == card):
        raise AssertionError(f"bench_train DisCo, 2 processes sharing the card: {b}")
    log(f"22b bench_train disco fp32 8 x 32, 2 processes sharing the card over gloo: "
        f"{json.dumps(b)}")
    return b


def gaps_ladder(card) -> dict:
    """22c. The EMAGE train-step ladder of scripts/torch_profile_train.py in fp32 at
    GAPS_LADDER_BATCH, --k 1 --repeats 1, every rung once (not profiled: the profile is
    the script's own run): finite, L5's first-step losses equal to the shipped step's
    (GAPS_L5_RTOL), no K1 launch."""
    from pantomatrix_tpu_torch.cli.bench_train import _emage_batch
    from pantomatrix_tpu_torch.models.api import EmageAudioModel, EmageVQModel
    from pantomatrix_tpu_torch.models.configs import EmageAudioConfig
    from pantomatrix_tpu_torch.ops import lstm_cuda, vq_cuda

    ladder = load_script("torch_profile_train")
    model = EmageAudioModel(EmageAudioConfig(), seed=0, device="cuda")
    suite = EmageVQModel.random(seed=1, device="cuda")
    batch = {k: torch.from_numpy(v).cuda()
             for k, v in _emage_batch(np.random.RandomState(0), *GAPS_LADDER_BATCH).items()}
    vq_cuda.launches = lstm_cuda.launches = 0
    rows = ladder.run_ladder(model, suite, batch, range(len(ladder.RUNGS)), k=1, repeats=1,
                             emit=lambda line: log(f"22c ladder {line}"), profile=False)
    k1, k2 = vq_cuda.launches, lstm_cuda.launches
    l5, shipped = (rows[ladder.RUNGS[i]]["first_step_losses"] for i in (5, ladder.SHIPPED))
    rel = max(abs(l5[k] - v) / max(abs(v), 1e-30) for k, v in shipped.items())
    finite = all(np.isfinite(v) for r in rows.values() for v in r["first_step_losses"].values())
    result = {"batch": GAPS_LADDER_BATCH, "rungs": rows, "l5_vs_shipped_rel": rel,
              "k1_launches": k1, "k2_launches": k2, "card": card}
    if not (list(rows) == list(ladder.RUNGS) and set(l5) == set(shipped)
            and rel <= GAPS_L5_RTOL and finite and k1 == 0 and k2 == 0):
        raise AssertionError(f"ladder: L5 vs shipped rel {rel}, finite {finite}, K1 {k1}, "
                             f"K2 {k2}: {rows}")
    log(f"22c ladder fp32 {GAPS_LADDER_BATCH[0]} x {GAPS_LADDER_BATCH[1]}: L5 first-step "
        f"losses within {rel:.1e} of the shipped step's, K1 {k1}")
    del model, suite, batch
    torch.cuda.empty_cache()
    return result


def gaps_rotations() -> dict:
    """22d. The Euler-angle, quaternion-algebra and random-rotation helpers on the card
    against the CPU (GAPS_ROT_ATOL)."""
    from pantomatrix_tpu_torch.core import rotations as rot

    g = torch.Generator().manual_seed(22)
    errs = {}

    def check(name, fn, *args):
        got = fn(*[a.cuda() if torch.is_tensor(a) else a for a in args]).cpu()
        errs[name] = float((got - fn(*args)).abs().max())

    for conv in ("XYZ", "XZY", "YXZ", "YZX", "ZXY", "ZYX", "XYX", "XZX", "YXY", "YZY", "ZXZ",
                 "ZYZ"):
        mid = (-1.2, 1.2) if len(set(conv)) == 3 else (0.2, 2.9)
        euler = torch.stack([torch.rand(256, generator=g) * 6 - 3,
                             torch.rand(256, generator=g) * (mid[1] - mid[0]) + mid[0],
                             torch.rand(256, generator=g) * 6 - 3], -1)
        check(f"euler_angles_to_matrix {conv}", rot.euler_angles_to_matrix, euler, conv)
        check(f"matrix_to_euler_angles {conv}", rot.matrix_to_euler_angles,
              rot.euler_angles_to_matrix(euler, conv), conv)
    qa, qb = rot.random_quaternions(256, g), rot.random_quaternions(256, g)
    pts = torch.randn(256, 3, generator=g)
    for name, fn, args in (("quaternion_raw_multiply", rot.quaternion_raw_multiply, (qa, qb)),
                           ("quaternion_multiply", rot.quaternion_multiply, (qa, qb)),
                           ("quaternion_invert", rot.quaternion_invert, (qa,)),
                           ("standardize_quaternion", rot.standardize_quaternion, (qa,)),
                           ("quaternion_apply", rot.quaternion_apply, (qa, pts))):
        check(name, fn, *args)
    m = rot.random_rotations(1024, torch.Generator("cuda").manual_seed(22), device="cuda")
    errs["random_rotations det - 1"] = float((torch.linalg.det(m) - 1).abs().max())
    errs["random_rotations m m^T - I"] = float(
        (m @ m.transpose(-1, -2) - torch.eye(3, device="cuda")).abs().max())
    bad = {k: v for k, v in errs.items() if not v <= GAPS_ROT_ATOL}
    if bad:
        raise AssertionError(f"rotation helpers on the card against the CPU: {bad}")
    log(f"22d rotation helpers, card against CPU: max abs err {max(errs.values()):.2e} "
        f"over {len(errs)} checks")
    return errs


def phase_gaps(card, bench_in_process: list) -> dict:
    """22. The last gaps: (a, b) cli.bench_train under torchrun, (c) the EMAGE train-step
    ladder, (d) the rotation helpers; (a) alone (its ms sits beside phase 19e's), then (b)
    while (c) and (d) run."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.time()
    camn_19e = next(r for r in bench_in_process
                    if r["family"] == "camn" and r["dtype"] == "float32")
    result = {"card": card,
              "bench_train": {"camn_in_process": camn_19e,
                              "camn_nccl_1": gaps_bench_nccl(card, camn_19e)}}
    with ThreadPoolExecutor(1) as pool:
        gloo = pool.submit(gaps_bench_gloo, card)
        result["ladder"] = gaps_ladder(card)
        result["rotations"] = gaps_rotations()
        result["bench_train"]["disco_gloo_2"] = gloo.result()
    result["seconds"] = time.time() - t0
    log(f"last-gaps phase: {result['seconds']:.1f} s")
    return result


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

    phase_s, t_mark = {}, [time.time()]

    def mark(name):  # seconds of each phase, printed before the kernels line
        t_mark.append(time.time())
        phase_s[name] = round(t_mark[-1] - t_mark[-2], 1)

    # 2. build
    t0 = time.time()
    libs = build.build(["vq_nearest_code", "lstm_sequence"])
    log(f"build: {time.time() - t0:.1f} s -> {[str(p.relative_to(HERE)) for p in libs.values()]}")
    for p in libs.values():
        log(Path(f"{p}.log").read_text().strip() if Path(f"{p}.log").exists() else "")

    # 3. K1 against its plain version
    mark("1-2 device, build")
    k1_rows = phase_k1("cuda")
    mark("3 K1")
    # 4. parity at the tiny config
    phase_parity()
    mark("4 parity")
    # 5. main path at full width (counts K1 launches)
    main_launches = phase_main_path("cuda", card)
    mark("5 main path")
    # 6. CLI
    phase_cli()
    mark("6 CLI")
    # 7. K2 against its plain version
    k2_rows = phase_k2("cuda")
    mark("7 K2")
    # 8. parity at the tiny CaMN/DisCo configs
    phase_lstm_parity()
    mark("8 LSTM parity")
    # 9-10. CaMN and DisCo at full width (each counts K2 launches)
    k2_launches = {name: phase_lstm_path(name, card) for name in ("camn", "disco")}
    # 11. CaMN CLI: 3 s at 15 fps, saved upsampled to 30 fps
    run_cli("pantomatrix_tpu_torch.cli.test_camn", {"poses": (90, 165)})
    mark("9-11 CaMN, DisCo")
    # 12. bf16 serving (counts K1 and K2 launches on its own paths)
    bf16 = phase_bf16(card)
    mark("12 bf16")
    out_dir = HERE / "outputs"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke_bf16.json").write_text(json.dumps(bf16, indent=1))
    # 13-15. the window step as a CUDA graph, streaming, the daemon (one full-width model)
    from pantomatrix_tpu_torch.cli.test_emage import load_models

    model, vq = load_models(None, True, "cuda")
    serving = {"graph": phase_graph(card, model, vq),
               "streaming": phase_streaming(card, model, vq),
               "daemon": phase_daemon(card, model, vq)}
    del model, vq
    torch.cuda.empty_cache()
    # 16. SequenceGenerator, entry()
    mark("13-15 graph, streaming, daemon")
    serving["rest"] = phase_rest(card)
    mark("16 rest")
    (out_dir / "chip_smoke_serving.json").write_text(json.dumps(serving, indent=1))
    # 17. evaluation (counts K1 and K2 launches on its own paths)
    evaluation = phase_eval(card)
    mark("17 evaluation")
    (out_dir / "chip_smoke_eval.json").write_text(json.dumps(evaluation, indent=1))
    # 18. training (counts K2 launches on its own paths)
    training = phase_train(card)
    mark("18 training")
    (out_dir / "chip_smoke_train.json").write_text(json.dumps(training, indent=1))
    # 19. tokenizer pretraining and data preparation (counts K1 and K2 on its own paths)
    pretrain = phase_pretrain(card)
    mark("19 pretraining")
    (out_dir / "chip_smoke_pretrain.json").write_text(json.dumps(pretrain, indent=1))
    # 20. visualization (counts K1 and K2 launches on the test CLIs' --visualization runs)
    viz = phase_viz(card)
    mark("20 visualization")
    (out_dir / "chip_smoke_viz.json").write_text(json.dumps(viz, indent=1))
    # 21. multi-process training (counts K2 launches on the world-1 NCCL CaMN steps)
    multiprocess = phase_multiprocess(card)
    mark("21 multi-process")
    (out_dir / "chip_smoke_multiprocess.json").write_text(json.dumps(multiprocess, indent=1))
    # 22. the last gaps (counts K2 launches in bench_train's processes under torchrun)
    gaps = phase_gaps(card, pretrain["bench_train"])
    mark("22 last gaps")
    (out_dir / "chip_smoke_gaps.json").write_text(json.dumps(gaps, indent=1))

    head = next(r for r in k1_rows if tuple(r["shape"]) == K1_HEADLINE)
    k1_rows = k1_rows + pretrain["vq_cli"]["train_emage_on_export"]["k1_by_shape"]
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
        "launches_bf16": {f"emage {r['mode']} {r['batch']} x {r['seconds']} s": r["k1_launches"]
                          for r in bf16["emage_runs"] if r["mode"] != "fp32"},
        "launches_evaluation": {
            f"{k} per {EVAL_SECONDS} s take": evaluation["launches_per_take"][k]
            for k in ("emage", "vq_roundtrip")},
        "launches_vq_val": pretrain["vq_cli"]["launches_vq_val"],
        "launches_train_emage_val": pretrain["vq_cli"]["train_emage_on_export"][
            "launches_train_emage_val"],
        "launches_vq_train_step": {c["mode"]: c["k1_launches"] for c in pretrain["vq_cells"]},
        "launches_visualization": {
            f"cli.test_emage --visualization, {VIZ_SECONDS} s take": viz["clis"]["emage"][
                "k1_launches"]},
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
        "launches_bf16": {f"{r['model']} {r['batch']} x {LSTM_SECONDS} s": r["k2_launches"]
                          for r in bf16["lstm_runs"]},
        "launches_evaluation": {
            f"{k} per {EVAL_SECONDS} s take": evaluation["launches_per_take"][k]
            for k in ("camn", "disco")},
        "launches_training": {f"{c['family']} train step": c["k2_launches_per_step"]
                              for c in training["cells"] if c["mode"] == "float32"
                              and c["family"] != "emage"},
        "training": next(r for r in training["k2_autograd"]
                         if tuple(r["shape"]) == TRAIN_K2_SHAPE),
        "launches_bench_train": {f"{r['family']} {r['dtype']} step": r["k2_launches_per_step"]
                                 for r in pretrain["bench_train"] if r["family"] != "emage"},
        "launches_visualization": {
            f"cli.test_camn --visualization, {VIZ_SECONDS} s take": viz["clis"]["camn"][
                "k2_launches"]},
        "launches_multiprocess": {
            f"{f} train step, world 1 over NCCL": c["k2_launches_per_step"]
            for f, c in multiprocess["world1"].items()},
        "launches_bench_train_mp": {
            "camn fp32 step, cli.bench_train as 1 process over NCCL (each process)":
                gaps["bench_train"]["camn_nccl_1"]["k2_launches_per_step_by_process"],
            "disco fp32 step, cli.bench_train as 2 processes sharing the card over gloo "
            "(each process)": gaps["bench_train"]["disco_gloo_2"][
                "k2_launches_per_step_by_process"]},
    })
    log(f"phase seconds: {json.dumps(phase_s)}")
    log(f"total {time.time() - t_all:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
