"""Where a step of K2, the persistent LSTM layer kernel, spends its time, on one NVIDIA
GPU, with each of its two gate products.

    python3 scripts/torch_profile_k2_phases.py [--reps 10] [--batches 1,8,16,32,64]
                                               [--clock_flags=-DLSTM_ONE_TF32_PASS]
                                               [--out <json path>]

For CaMN/DisCo's layer shapes (T = 421, H = 512) at each batch, one direction and both,
it runs the layer's plan with the FFMA product and, where the kernel has a tensor-core
variant for the plan's cut, with the split-TF32 one (``ops/lstm_cuda.mma_fits``; a tile
of 4 rows is padded to the mma's 8). ``chosen`` marks the product ``plan_layer`` takes.
For each it times the launch (CUDA events, median of ``--reps``), then runs a second
build of the same source with ``-DLSTM_PHASE_CLOCKS``, in which thread 0 of the first
CTA sums the clock cycles of each phase of its steps:
  wait     the per-step barrier (until every CTA of its batch group has written h_{t-1});
  h_load   until h_{t-1}'s first half and the step's x_proj are in shared memory;
  product  the gate product and its reduction (over the k split, or the warps' partials);
  gates    the gate nonlinearities and the write of h_t.
Cycles become microseconds per step through the same launch's globaltimer. The B = 1
row is the floor under any batch: the hand-off between steps plus a step's own latency.
Each row also gives the largest difference of its output from the FFMA product's.
``--clock_flags`` adds compiler flags to the clocked build only: with
``-DLSTM_ONE_TF32_PASS`` its tensor-core product issues the hi . hi products alone (a third
of the tensor-core work, the same split), which tells the tensor pipe's share of the
product phase (that build's output is wrong in its last bits and is not compared).
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

PHASES = ("wait", "h_load", "product", "gates")


def load_lib(path):
    lib = ctypes.CDLL(str(path))
    # xp, w, out, counters; T, B, H, D, U, BT, BR, resident, mma; stream
    lib.lstm_layer.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    lib.lstm_layer.restype = ctypes.c_int
    return lib


def variants(plan, h, smem_per_block):
    """The plan with each product the kernel can run it with: {product: plan}."""
    from pantomatrix_tpu_torch.ops import lstm_cuda

    def with_product(tile, product):
        return plan._replace(tile_rows=tile, product=product, smem_bytes=lstm_cuda.smem_bytes(
            h, plan.units, tile, plan.rows, plan.resident, product))

    out = {"ffma": with_product(plan.tile_rows, "ffma")}
    tile = max(8, plan.tile_rows)
    if lstm_cuda.mma_fits(h, plan.units, tile, plan.rows, plan.resident, smem_per_block):
        out["mma"] = with_product(tile, "mma")
    return out


def launch(lib, plan, xp, w, out, t, b, h, d):
    counters = torch.zeros(d * plan.batch_groups, dtype=torch.int32, device="cuda")
    err = lib.lstm_layer(xp.data_ptr(), w.data_ptr(), out.data_ptr(), counters.data_ptr(),
                         t, b, h, d, plan.units, plan.tile_rows, plan.rows,
                         int(plan.resident), int(plan.product == "mma"),
                         torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"lstm_layer launch failed: CUDA error {err} ({plan})")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--batches", type=str, default="1,8,16,32,64")
    ap.add_argument("--clock_flags", type=str, default="")
    ap.add_argument("--out", type=str,
                    default=str(REPO / "outputs" / "torch_profile_k2_phases.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    sys.path.insert(0, str(REPO))
    from chip_smoke import cuda_ms, nvidia_smi_line
    from pantomatrix_tpu_torch.ops import build, lstm_cuda

    card = nvidia_smi_line()
    lib = load_lib(build.build(["lstm_sequence"])["lstm_sequence"])
    clock_flags = ["-DLSTM_PHASE_CLOCKS"] + args.clock_flags.split()
    clocked = load_lib(build.build(["lstm_sequence"], build.NVCC_FLAGS +
                                   clock_flags)["lstm_sequence"])
    clocked.lstm_phase_clocks.argtypes = [ctypes.POINTER(ctypes.c_longlong)]
    clocked.lstm_phase_clocks.restype = ctypes.c_int
    limits = lstm_cuda.device_limits(torch.cuda.current_device())
    g = torch.Generator().manual_seed(5)
    results = {"card": card, "torch": torch.__version__, "clock_flags": clock_flags,
               "rows": []}
    for b in (int(x) for x in args.batches.split(",")):
        t, h = 421, 512
        for d in (1, 2):
            bound = h ** -0.5
            xp = torch.randn(t, b, d * 4 * h, generator=g).cuda()
            w = ((torch.rand(d, 4 * h, h, generator=g) * 2 - 1) * bound).cuda()
            plan = lstm_cuda.plan_layer(t, b, h, d, *limits)
            outs = {}
            for product, p in variants(plan, h, limits[1]).items():
                out = torch.empty((t, b, d * h), device="cuda")
                ms = cuda_ms(lambda: launch(lib, p, xp, w, out, t, b, h, d), reps=args.reps)
                outs[product] = out.clone()
                clocks = (ctypes.c_longlong * 6)()
                again = torch.empty_like(out)
                for _ in range(2):  # the second launch is the one read
                    launch(clocked, p, xp, w, again, t, b, h, d)
                    torch.cuda.synchronize()
                if clocked.lstm_phase_clocks(clocks) != 0:
                    raise RuntimeError("lstm_phase_clocks failed")
                cycles_per_ns = clocks[4] / clocks[5]
                row = {"shape": [t, b, h], "directions": d, "product": product,
                       "chosen": product == plan.product, "plan": p._asdict(),
                       "clocked_output_equals_kernel": torch.equal(out, again),
                       "max_abs_diff_from_ffma": float((out - outs["ffma"]).abs().max()),
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
