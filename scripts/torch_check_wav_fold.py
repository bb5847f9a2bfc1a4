"""The low-precision copy's WavEncoder with BatchNorm statistics drawn at random, judged
as the benchmark judges its cells, on one NVIDIA GPU.

    python3 scripts/torch_check_wav_fold.py [--root <checkout>] [--seeds 2700000001,...]
        [--cells emage-offline-bf16,camn-offline-bf16] [--out outputs/torch_check_wav_fold.json]

The benchmark draws every BatchNorm as mean 0, variance 1, weight 1 and bias 0, where
folding a BatchNorm into its conv changes almost nothing, so its ``correct`` cannot see a
wrong fold. For each seed and cell this builds the cell's adapter
(``benchmark/models/<family>.py``: the weights and inputs the seed gives, the port and
the plain float32 reference of ``benchmark/reference/`` on the same weights), then draws
each BatchNorm's running mean N(0, 0.5), running variance U(0.25, 4), weight U(0.5, 1.5)
and bias N(0, 0.5) into both, and
- compares each WavEncoder of the port's low-precision copy (``utils/precision.cast_once``)
  with the reference's, on the first window's audio (EMAGE) or the whole clip (CaMN):
  ``<encoder>_rel_err``, the relative L2 error;
- runs one call of the port and judges it with the adapter's own check, under the
  cell's limits (``traffic/<mix>.json``).

``--root`` imports ``pantomatrix_tpu_torch`` from another checkout (a parent commit
unpacked with ``git archive``), for its readings on the same draws. ``--batch`` and
``--clip_seconds`` shrink the cells for a rehearsal with ``--device cpu``. Imports nothing
of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
BENCH = REPO / "benchmark"
ENCODERS = {"emage": ("audio_encoder_face", "audio_encoder_body"), "camn": ("audio_encoder",)}


def draw_batch_norms(ref: torch.nn.Module, port: torch.nn.Module, seed: int) -> int:
    """Random statistics and affines for every BatchNorm of ``ref``, copied into the
    tensors of ``port`` under the same keys (in place, as a load would write them).
    Returns the number of BatchNorms drawn."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    port_state = port.state_dict()
    n = 0
    with torch.no_grad():
        for name, m in ref.named_modules():
            if not hasattr(m, "running_var"):
                continue
            c = m.running_var.numel()
            values = {"running_mean": torch.randn(c, generator=g) * 0.5,
                      "running_var": 0.25 + 3.75 * torch.rand(c, generator=g),
                      "weight": 0.5 + torch.rand(c, generator=g),
                      "bias": torch.randn(c, generator=g) * 0.5}
            for key, v in values.items():
                getattr(m, key).copy_(v)
                port_state[f"{name}.{key}"].copy_(v)
            n += 1
    return n


def check_cell(cell: dict, seed: int, device: str) -> dict:
    from harness import common
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.utils.precision import cast_once, compute_dtype_of

    family = cell["config_file"]["family"]
    adapter = common.load_module(BENCH / "models" / f"{family}.py",
                                 f"bench_model_{family}").Adapter(
        cell["config_file"], cell["mix"], seed, device, "port")
    adapter.setup()
    n_bn = draw_batch_norms(adapter.ref, adapter.model, seed)
    dtype = compute_dtype_of(cell["mix"].get("compute_dtype"))
    audio = adapter.audio[0]
    if family == "emage":
        audio = audio[:, :adapter.model.config.pose_length * 533]
    readings = {"batch_norms_drawn": n_bn}
    with torch.no_grad(), strict_fp32():
        copy = cast_once(adapter.model, dtype)
        readings["encoder_class"] = type(getattr(copy, ENCODERS[family][0])).__name__
        for name in ENCODERS[family]:
            want = getattr(adapter.ref, name)(audio)
            got = getattr(copy, name)(audio.to(dtype))
            readings[f"{name}_rel_err"] = common.relative_error(got, want)
    out = adapter.call(0)
    adapter.complete(out)
    adapter.free_program()
    checks, _ = adapter.check(0, out)
    judged = common.judge(checks, cell["mix"].get("limits", {}))
    readings.update(checks=judged, correct=all(c.get("ok", True) for c in judged.values()))
    return readings


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=str(REPO))
    ap.add_argument("--seeds", type=str, default="2700000001,3100000003")
    ap.add_argument("--cells", type=str, default="emage-offline-bf16,camn-offline-bf16")
    ap.add_argument("--device", type=str, default="cuda")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--clip_seconds", type=float, default=None)
    ap.add_argument("--out", type=str, default=str(REPO / "outputs" /
                                                   "torch_check_wav_fold.json"))
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script checks the port on an NVIDIA GPU")
    for p in (str(Path(args.root).resolve()), str(BENCH)):
        sys.path.insert(0, p)
    from harness import common

    res = {"root": str(Path(args.root).resolve()), "device": args.device, "runs": []}
    if args.device == "cuda":
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    spec = common.load_spec(REPO)
    for seed in (int(s) for s in args.seeds.split(",")):
        for name in args.cells.split(","):
            cell = common.find_cell(spec, name, BENCH)
            for key, value in (("batch", args.batch), ("clip_seconds", args.clip_seconds)):
                if value is not None:
                    cell["mix"][key] = value
            run = {"cell": name, "seed": seed, **check_cell(cell, seed, args.device)}
            res["runs"].append(run)
            print(json.dumps(run), flush=True)
            if args.device == "cuda":
                torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
