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
from pathlib import Path

import torch

import torch_profile_common as common

REPO = Path(__file__).resolve().parent.parent
EMAGE_ROWS, WINDOW_FRAMES, SAMPLES_PER_FRAME = 128, 64, 533
CAMN_ROWS, CAMN_SAMPLES = 64, 454400
MOTION_DIMS = 337  # rot6d of 55 joints, 4 foot contacts, 3 translation


def attribute_row(scopes, outer, op, kernel) -> tuple:
    """(in_encoder, module class, attribute, outer op, inner op, kernel) of a kernel."""
    name, cls = scopes[0].split("|")[1:3] if scopes else ("", "")
    return ("audio_encoder" in name, cls, name.rsplit(".", 1)[-1], outer, op, kernel)


def profile(fn, model, warmup: int = 2) -> dict:
    strides = {}
    undo = common.scope_modules(model, strides=strides)
    try:
        prof = common.profiled(fn, warmup)
    finally:
        for u in undo:
            u()
    rows = common.attribute(prof, attribute_row, ("wav_encoder", "module", "attribute", "op",
                                                  "inner_op", "kernel"))
    enc = [r for r in rows if r["wav_encoder"]]
    by_module_op = common.summarize(
        rows, lambda r: f"{'enc' if r['wav_encoder'] else 'rest'} {r['module']} {r['op']}")
    return {"device_ms": sum(r["ms"] for r in rows),
            "wav_encoder_device_ms": sum(r["ms"] for r in enc),
            "by_module_op": by_module_op, "rows": rows,
            "encoder_input_strides": {k: v for k, v in strides.items()
                                      if "audio_encoder" in k}}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=str(REPO))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", type=str, default=str(REPO / "outputs" /
                                                   "torch_profile_wav_encoder.json"))
    args = ap.parse_args()
    root = common.import_root(args.root)
    card = common.card_line()
    from pantomatrix_tpu_torch.models import camn, emage
    from pantomatrix_tpu_torch.models.api import CamnAudioModel, EmageAudioModel, EmageVQModel
    from pantomatrix_tpu_torch.models.configs import CamnAudioConfig, EmageAudioConfig
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.utils.precision import cast_once

    bf16 = torch.bfloat16
    g = torch.Generator().manual_seed(3)
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version(), "root": root}

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
        res["emage_wav_encoder_ms"] = common.time_ms(lambda: model.audio_encoder_face(audio),
                                                     args.reps)
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
        res["camn_wav_encoder_ms"] = common.time_ms(lambda: ccast.audio_encoder(caudio16),
                                                    args.reps)
    print(json.dumps({k: res["camn_call"][k] for k in
                      ("device_ms", "wav_encoder_device_ms", "by_module_op")}), flush=True)
    print(json.dumps({"card": card, "emage_wav_encoder_ms": res["emage_wav_encoder_ms"],
                      "camn_wav_encoder_ms": res["camn_wav_encoder_ms"]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
