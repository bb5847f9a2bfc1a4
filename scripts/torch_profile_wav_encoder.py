"""Which op launches each kernel around the WavEncoder, in the bfloat16 serving mode, on
one NVIDIA GPU.

    python3 scripts/torch_profile_wav_encoder.py [--root <checkout>] [--reps 20]
        [--out outputs/torch_profile_wav_encoder.json]

At the benchmark cells' shapes, on the low-precision copy that ``utils/precision.cast_once``
makes (random full-width weights from a seed), it runs
- one EMAGE window step (``models/emage._window_step``: both WavEncoders, the network, the
  float32 VQ decode of the window's tail) at 128 rows of 64 frames (34,112 samples a row),
- one CaMN call (``models/camn.camn_forward``) at 64 rows of 28.4 s,
each eagerly (no CUDA graph, which would hide the op behind a kernel) once under
``torch.profiler`` after two warm-up calls. Forward hooks open a record function around
every module, so each kernel is put down to the innermost module around it (its class and
its attribute name, e.g. ``BatchNorm1d bn1``) and to the aten op that launched it, as
called inside that module (``aten::batch_norm`` or ``aten::mul``, say) and as the innermost
op (``aten::copy_``, ``aten::cudnn_convolution``). Rows under a WavEncoder are marked.
It records each encoder module's input strides on its first call, then times each
WavEncoder alone (CUDA events over ``--reps`` calls, after a warm-up).

``--root`` imports ``pantomatrix_tpu_torch`` from another checkout (a parent commit
unpacked with ``git archive``, say), so that two versions are compared in one call on one
card. Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
EMAGE_ROWS, WINDOW_FRAMES, SAMPLES_PER_FRAME = 128, 64, 533
CAMN_ROWS, CAMN_SAMPLES = 64, 454400
MOTION_DIMS = 337  # rot6d of 55 joints, 4 foot contacts, 3 translation


def scope_hooks(model: torch.nn.Module, strides: dict):
    """A record function ``mod|<qualified name>|<class>`` around every module's forward,
    and each module's first input strides (by qualified name) in ``strides``."""
    stack, handles = [], []

    def pre(name):
        def hook(mod, args):
            if name not in strides and args and isinstance(args[0], torch.Tensor):
                strides[name] = {"class": type(mod).__name__, "shape": list(args[0].shape),
                                 "stride": list(args[0].stride())}
            rf = torch.autograd.profiler.record_function(f"mod|{name}|{type(mod).__name__}")
            rf.__enter__()
            stack.append(rf)
        return hook

    def post(mod, args, out):
        stack.pop().__exit__(None, None, None)

    for name, mod in model.named_modules():
        handles.append(mod.register_forward_pre_hook(pre(name or "<root>")))
        handles.append(mod.register_forward_hook(post))
    return handles


def attribute(prof) -> list:
    """Rows (in_encoder, module class, attribute, outer op, inner op, kernel) with their
    device ms and kernel count, largest first."""
    rows = {}
    for e in prof.events():
        if not e.kernels or e.name.startswith("mod|"):
            continue
        outer, node = e.name, e.cpu_parent
        scope = None
        while node is not None:
            if node.name.startswith("mod|"):
                scope = node.name.split("|")
                break
            outer, node = node.name, node.cpu_parent
        name, cls = (scope[1], scope[2]) if scope else ("", "")
        key = ("audio_encoder" in name, cls, name.rsplit(".", 1)[-1], outer, e.name)
        for k in e.kernels:
            r = rows.setdefault(key + (k.name[:90],), [0.0, 0])
            r[0] += k.duration / 1e3
            r[1] += 1
    out = [dict(zip(("wav_encoder", "module", "attribute", "op", "inner_op", "kernel"), key),
                ms=ms, count=n) for key, (ms, n) in rows.items()]
    return sorted(out, key=lambda r: -r["ms"])


def summarize(rows: list) -> dict:
    """Device ms by (wav_encoder, module class, outer op)."""
    total = {}
    for r in rows:
        key = f"{'enc' if r['wav_encoder'] else 'rest'} {r['module']} {r['op']}"
        total[key] = total.get(key, 0.0) + r["ms"]
    return dict(sorted(total.items(), key=lambda kv: -kv[1]))


def profile(fn, model, warmup: int = 2) -> dict:
    strides = {}
    handles = scope_hooks(model, strides)
    try:
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    rows = attribute(prof)
    enc = [r for r in rows if r["wav_encoder"]]
    return {"device_ms": sum(r["ms"] for r in rows),
            "wav_encoder_device_ms": sum(r["ms"] for r in enc),
            "by_module_op": summarize(rows), "rows": rows,
            "encoder_input_strides": {k: v for k, v in strides.items()
                                      if "audio_encoder" in k}}


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=str, default=str(REPO / "outputs" /
                                                   "torch_profile_wav_encoder.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script measures the port on an NVIDIA GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]
    sys.path.insert(0, str(Path(args.root).resolve()))
    from pantomatrix_tpu_torch.models import camn, emage
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, EmageAudioModel, EmageVQModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, EmageAudioConfig
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.utils.precision import cast_once

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(3)
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version(), "root": str(Path(args.root).resolve())}

    model = cast_once(EmageAudioModel(EmageAudioConfig(), seed=5, device="cuda"), bf16)
    suite = EmageVQModel.random(seed=0, device="cuda")
    cfg = model.config
    n = WINDOW_FRAMES * SAMPLES_PER_FRAME
    audio = ((torch.rand(EMAGE_ROWS, n, generator=g) - 0.5) * 0.5).cuda().to(bf16)
    spk = torch.zeros((EMAGE_ROWS, 1), dtype=torch.long, device="cuda")
    motion = torch.zeros(EMAGE_ROWS, WINDOW_FRAMES, MOTION_DIMS, device="cuda", dtype=bf16)
    mask = torch.ones_like(motion)
    mask[:, :cfg.seed_frames] = 0

    @torch.no_grad()
    @strict_fp32()
    def window():
        return emage._window_step(model, suite, audio, spk, motion, mask)

    res["emage_window"] = profile(window, model)
    with torch.no_grad(), strict_fp32():
        res["emage_wav_encoder_ms"] = time_ms(lambda: model.audio_encoder_face(audio), args.reps)
    print(json.dumps({k: res["emage_window"][k] for k in
                      ("device_ms", "wav_encoder_device_ms", "by_module_op")}), flush=True)
    del model, suite, audio

    cmodel = CamnAudioModel(CamnAudioConfig(), seed=5, device="cuda")
    caudio = ((torch.rand(CAMN_ROWS, CAMN_SAMPLES, generator=g) - 0.5) * 0.5).cuda()
    cspk = torch.zeros((CAMN_ROWS, 1), dtype=torch.long, device="cuda")
    ccast = cast_once(cmodel, bf16)
    res["camn_call"] = profile(lambda: camn.camn_forward(cmodel, caudio, cspk,
                                                         compute_dtype="bfloat16"), ccast)
    caudio16 = caudio.to(bf16)
    with torch.no_grad(), strict_fp32():
        res["camn_wav_encoder_ms"] = time_ms(lambda: ccast.audio_encoder(caudio16), args.reps)
    print(json.dumps({k: res["camn_call"][k] for k in
                      ("device_ms", "wav_encoder_device_ms", "by_module_op")}), flush=True)
    print(json.dumps({"card": card, "emage_wav_encoder_ms": res["emage_wav_encoder_ms"],
                      "camn_wav_encoder_ms": res["camn_wav_encoder_ms"]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
