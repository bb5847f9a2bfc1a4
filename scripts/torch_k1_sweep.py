"""Device time of K1, the VQ nearest-code search, at the EMAGE main path's shapes on one
NVIDIA GPU, and what its launch plan and its phases cost.

    python3 scripts/torch_k1_sweep.py [--root DIR] [--wrapper-only] [--out <json path>]

1. wrapper: at each main-path N (D = K = 256, random normal inputs from a seed) the
   device time per launch (chip_smoke.graph_ms: CUDA events around 20 back-to-back
   launches replayed from a CUDA graph, so the host is out of it), the same 20 launches
   issued eagerly from Python (eager_ms: where the wrapper's host cost exceeds the
   kernel's time, this is the host's rate) and one call between two events (call_ms). With
   ``--root`` this part runs against the port of another checkout (a parent commit
   unpacked with ``git archive``, say), so that two versions compare in one call.
2. plan: the device time per launch with the cluster size S forced to 1, 2, 4 and 8, to
   which ``CTA_FIXED_CODES`` in ops/vq_cuda.py is fitted.
3. ablation: the kernel rebuilt with -DVQ_SKIP_SPLIT (no split of the codes into hi/lo),
   -DVQ_SKIP_MMA (no tensor-core products) or both (the staging skeleton alone); their
   indices are wrong, their times say what each phase adds.
Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
from chip_smoke import cuda_ms, eager_ms, graph_ms  # noqa: E402  (timing helpers)

MAIN_PATH_N = [8 * 64, 8 * 60, 8 * 600, 128 * 64, 128 * 60, 128 * 1800]
ABLATIONS = {"skip_split": ["-DVQ_SKIP_SPLIT"], "skip_mma": ["-DVQ_SKIP_MMA"],
             "skip_both": ["-DVQ_SKIP_SPLIT", "-DVQ_SKIP_MMA"]}


def inputs(n: int):
    g = torch.Generator().manual_seed(n)
    return torch.randn(n, 256, generator=g).cuda(), torch.randn(256, 256, generator=g).cuda()


def wrapper_rows(vq_cuda):
    rows = []
    for n in MAIN_PATH_N:
        z, cb = inputs(n)
        fn = lambda: vq_cuda.nearest_code(z, cb)
        rows.append({"n": n, "kernel_ms": graph_ms(fn), "eager_ms": eager_ms(fn),
                     "call_ms": cuda_ms(fn)})
        rows[-1]["host_ms"] = rows[-1]["call_ms"] - rows[-1]["kernel_ms"]
        print(json.dumps(rows[-1]), flush=True)
    return rows


def launcher(lib_path: Path):
    """The C entry point of a build of csrc/vq_nearest_code.cu, called with a given plan."""
    fn = ctypes.CDLL(str(lib_path)).vq_nearest_code
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(z, cb, out, plan):
        err = fn(z.data_ptr(), cb.data_ptr(), out.data_ptr(), z.shape[0], z.shape[1],
                 cb.shape[0], plan.rows_per_cta, plan.cluster, plan.codes_per_tile,
                 plan.tiles_per_cta, plan.stages, plan.smem_bytes,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"vq_nearest_code launch ({plan}) failed: CUDA error {err}")
    return launch


def forced_plan(vq_cuda, n: int, cluster: int):
    tile = 256 // cluster
    return vq_cuda.plan_search(n, 256, 256, 132)._replace(
        cluster=cluster, codes_per_tile=tile, tiles_per_cta=1, stages=vq_cuda.stages(tile),
        smem_bytes=vq_cuda.smem_bytes(tile))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=str(REPO),
                    help="checkout whose pantomatrix_tpu_torch is timed")
    ap.add_argument("--wrapper-only", action="store_true")
    ap.add_argument("--out", type=str, default=str(REPO / "outputs" / "torch_k1_sweep.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this script times K1 on an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pantomatrix_tpu_torch.ops import build, vq_cuda

    result = {"card": card, "root": args.root, "wrapper": wrapper_rows(vq_cuda)}
    if not args.wrapper_only:
        base = launcher(build.build(["vq_nearest_code"])["vq_nearest_code"])
        result["plan"] = []
        for n in MAIN_PATH_N:
            z, cb = inputs(n)
            out = torch.empty(n, dtype=torch.int32, device="cuda")
            for s in (1, 2, 4, 8):
                plan = forced_plan(vq_cuda, n, s)
                row = {"n": n, "cluster": s, "ctas": plan.ctas, "chosen": plan.cluster ==
                       vq_cuda.plan_search(n, 256, 256, 132).cluster,
                       "kernel_ms": graph_ms(lambda: base(z, cb, out, plan))}
                result["plan"].append(row)
                print(json.dumps(row), flush=True)
        libs = {name: build.build(["vq_nearest_code"], build.NVCC_FLAGS + flags)["vq_nearest_code"]
                for name, flags in ABLATIONS.items()}
        result["ablation"] = []
        for n in MAIN_PATH_N:
            z, cb = inputs(n)
            out = torch.empty(n, dtype=torch.int32, device="cuda")
            plan = vq_cuda.plan_search(n, 256, 256, 132)
            row = {"n": n, "full": graph_ms(lambda: base(z, cb, out, plan))}
            for name, path in libs.items():
                launch = launcher(path)
                row[name] = graph_ms(lambda: launch(z, cb, out, plan))
            result["ablation"].append(row)
            print(json.dumps(row), flush=True)
    print(card)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))


if __name__ == "__main__":
    main()
