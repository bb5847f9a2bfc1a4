"""Where a step of K2, the persistent LSTM layer kernel, spends its time, on one NVIDIA
GPU.

    python3 scripts/torch_profile_k2_phases.py [--reps 10] [--out <json path>]

For CaMN/DisCo's layer shapes (T = 421, H = 512) at B = 1, 8 and 64, one direction and
both, it times the kernel as the port launches it (CUDA events, median of ``--reps``),
then runs a second build of the same source with ``-DLSTM_PHASE_CLOCKS``, in which
thread 0 of the first CTA sums the clock cycles of each phase of its steps:
  wait     the per-step barrier (until every CTA of its batch group has written h_{t-1});
  h_load   until h_{t-1}'s first half and the step's x_proj are in shared memory;
  product  the gate product and its reduction over the k split;
  gates    the gate nonlinearities and the write of h_t.
Cycles become microseconds per step through the same launch's globaltimer. The B = 1
row is the floor under any batch: the hand-off between steps plus a step's own latency.
Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path

import torch

from torch_profile_emage import REPO

SHAPES = [(421, b, 512) for b in (1, 8, 64)]
PHASES = ("wait", "h_load", "product", "gates")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=str,
                    default=str(REPO / "outputs" / "torch_profile_k2_phases.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuda_ms, nvidia_smi_line
    from pantomatrix_tpu_torch.ops import build, lstm_cuda

    card = nvidia_smi_line()
    path = build.build(["lstm_sequence"], build.NVCC_FLAGS + ["-DLSTM_PHASE_CLOCKS"])
    lib = ctypes.CDLL(str(path["lstm_sequence"]))
    lib.lstm_layer.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    lib.lstm_layer.restype = ctypes.c_int
    lib.lstm_phase_clocks.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    lib.lstm_phase_clocks.restype = ctypes.c_int
    limits = lstm_cuda.device_limits(torch.cuda.current_device())
    g = torch.Generator().manual_seed(5)
    results = {"card": card, "torch": torch.__version__, "rows": []}
    for t, b, h in SHAPES:
        for d in (1, 2):
            bound = h ** -0.5
            xp = torch.randn(t, b, d * 4 * h, generator=g).cuda()
            w = ((torch.rand(d, 4 * h, h, generator=g) * 2 - 1) * bound).cuda()
            kernel = lstm_cuda.lstm_bidirectional if d == 2 else lstm_cuda.lstm_direction
            w_arg = w if d == 2 else w[0]
            ms = cuda_ms(lambda: kernel(xp, w_arg, h), reps=args.reps)
            plan = lstm_cuda.plan_layer(t, b, h, d, *limits)
            out = torch.empty((t, b, d * h), device="cuda")
            clocks = (ctypes.c_longlong * 6)()
            for _ in range(2):  # the second launch is the one read
                counters = torch.zeros(d * plan.batch_groups, dtype=torch.int32, device="cuda")
                err = lib.lstm_layer(xp.data_ptr(), w.data_ptr(), out.data_ptr(),
                                     counters.data_ptr(), t, b, h, d, plan.units,
                                     plan.tile_rows, plan.rows, int(plan.resident),
                                     torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"clocked lstm_layer launch failed: CUDA error {err}")
                torch.cuda.synchronize()
            if lib.lstm_phase_clocks(clocks) != 0:
                raise RuntimeError("lstm_phase_clocks failed")
            cycles_per_ns = clocks[4] / clocks[5]
            row = {"shape": [t, b, h], "directions": d, "plan": plan._asdict(),
                   "clocked_output_equals_kernel": torch.equal(out, kernel(xp, w_arg, h)),
                   "kernel_ms": ms, "us_per_step": 1e3 * ms / t,
                   "clocked_launch_ms": clocks[5] / 1e6, "clock_ghz": cycles_per_ns,
                   "phase_us_per_step": {name: clocks[k] / cycles_per_ns / 1e3 / t
                                         for k, name in enumerate(PHASES)}}
            results["rows"].append(row)
            print(json.dumps(row), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(results, indent=1))
    print(card)


if __name__ == "__main__":
    main()
