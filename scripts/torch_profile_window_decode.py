"""Where an EMAGE window step's device time goes inside its VQ decode, and how the VQ
decoders' float32 convolution divides over a whole call, in the bfloat16 serving mode, on
one NVIDIA GPU.

    python3 scripts/torch_profile_window_decode.py [--root <checkout>] [--rows 128]
        [--clip_seconds 60] [--reps 10] [--out outputs/torch_profile_window_decode.json]

On the low-precision copy that ``utils/precision.cast_once`` makes (random full-width
weights from a seed) and a random tokenizer suite at the published widths:

1. ``step``: one eager window step (``models/emage._window_step``) at ``--rows`` rows of
   64 frames, under ``torch.profiler`` after two warm-up calls. Each kernel is put down to
   the part of the step that launched it: the network (``emage_forward``), the head routing
   (``_select_decode_inputs``), and inside ``vq_decode`` each part's decoder (by module
   class), K1 (``nearest_code``), the codebook lookups, the rotation conversions, the mask
   recovery (``recover_from_mask_ts``) and the rest of ``vq_decode``. The step is also
   timed alone (CUDA events over ``--reps`` calls).
2. ``call``: one call as the benchmark's ``emage-offline-bf16`` cell makes it
   (``inference`` with ``batched_wav``, then ``decode`` with the global motion) at
   ``--rows`` takes of ``--clip_seconds``, after two warm-up calls (which capture the
   window graph), under the profiler. Each kernel is put down to the innermost span open
   where it was launched (``emage.window``, ``emage.remainder``, ``emage.decode``, else
   ``emage.inference``): the exported trace links a kernel to its launch by correlation id,
   a replayed graph's kernels to the graph's launch. Device seconds by span and kernel name.
3. ``seed``: the window's float32 seed decoded from the heads' last ``seed_frames`` +
   ``_decoder_halo`` frames against the whole window's decode (the same heads, 128 rows),
   and from one frame fewer: the largest absolute difference and the bfloat16 seed values
   that differ after the cast.

``--root`` imports ``pantomatrix_tpu_torch`` from another checkout (a parent commit
unpacked with ``git archive``, say), so that two versions are compared in one call on one
card. Imports nothing of JAX or pantomatrix_tpu.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import torch

import torch_profile_common as common

REPO = Path(__file__).resolve().parent.parent
WINDOW_FRAMES, SAMPLES_PER_FRAME, MOTION_DIMS = 64, 533, 337
CALL_SPANS = ("emage.window", "emage.remainder", "emage.decode", "emage.inference")
# functions of models/emage.py and models/emage_vq.py given a record function of their own
SCOPED = {"emage": ("emage_forward", "_select_decode_inputs", "vq_decode"),
          "emage_vq": ("nearest_code", "get_codebook_entry", "rotation_6d_to_axis_angle",
                       "axis_angle_to_rotation_6d", "recover_from_mask_ts")}
COMPONENT = {"nearest_code": "K1 nearest_code", "get_codebook_entry": "codebook lookup",
             "rotation_6d_to_axis_angle": "rotations", "axis_angle_to_rotation_6d": "rotations",
             "recover_from_mask_ts": "masks"}


def scope(modules: dict) -> list:
    """Wrap the functions of ``SCOPED`` in a record function ``fn|<name>`` and every
    module of the model and the suite in ``mod|<prefix>.<name>|<class>``; returns the undo
    callables."""
    undo = []
    for mod_name, names in SCOPED.items():
        mod = modules[mod_name]
        for name in names:
            fn = getattr(mod, name)

            def wrapper(*a, _fn=fn, _name=name, **k):
                with torch.autograd.profiler.record_function(f"fn|{_name}"):
                    return _fn(*a, **k)
            setattr(mod, name, wrapper)
            undo.append(lambda mod=mod, name=name, fn=fn: setattr(mod, name, fn))
    for prefix in ("model", "suite"):
        undo += common.scope_modules(modules[prefix], f"{prefix}.")
    return undo


def component(scopes, outer, op, kernel) -> tuple:
    """(region, component, op, kernel) of a kernel launched by ``op`` inside ``scopes``,
    innermost first."""
    # K1 is launched through its own library, not an aten op: known by its name
    if "vq_nearest_code" in kernel:
        return "vq_decode", COMPONENT["nearest_code"], op, kernel
    fns = [c.split("|")[1] for c in scopes if c.startswith("fn|")]
    if "vq_decode" in fns:
        for c in scopes:
            kind, name = c.split("|")[:2]
            if kind == "fn" and name in COMPONENT:
                return "vq_decode", COMPONENT[name], op, kernel
            if kind == "mod" and name.startswith("suite."):
                part = name.split(".")[1]
                return "vq_decode", f"{part} decoder {c.split('|')[2]}", op, kernel
        return "vq_decode", "vq_decode other", op, kernel
    if "_select_decode_inputs" in fns:
        return "head routing", "", op, kernel
    if "emage_forward" in fns:
        return "network", "", op, kernel
    return "step other", "", op, kernel


def joined(*fields):
    """A summary key: the row's non-empty ``fields`` joined by " / "."""
    return lambda r: " / ".join(r[f] for f in fields if r[f])


def kernels_by_span(trace_path: str) -> dict:
    """Device seconds of each kernel name by the innermost of ``CALL_SPANS`` open where
    the kernel was launched, from an exported chrome trace."""
    events = json.loads(Path(trace_path).read_text())["traceEvents"]
    spans = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
             if e.get("ph") == "X" and e.get("name") in CALL_SPANS]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        if e.get("cat") != "kernel":
            continue
        ts = launched.get(e.get("args", {}).get("correlation"))
        inside = [s for s in spans if ts is not None and s[0] <= ts <= s[1]]
        where = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "(no span)"
        by_name = out.setdefault(where, {})
        by_name[e["name"][:90]] = by_name.get(e["name"][:90], 0.0) + e["dur"] / 1e6
    return {where: dict(sorted(v.items(), key=lambda kv: -kv[1])) for where, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=str, default=str(REPO))
    ap.add_argument("--rows", type=int, default=128)
    ap.add_argument("--clip_seconds", type=float, default=60.0)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", type=str, default=str(REPO / "outputs" /
                                                   "torch_profile_window_decode.json"))
    args = ap.parse_args()
    root = common.import_root(args.root)
    card = common.card_line()
    from pantomatrix_tpu_torch.models import emage, emage_vq
    from pantomatrix_tpu_torch.models.api import EmageAudioModel, EmageVQModel
    from pantomatrix_tpu_torch.models.configs import EmageAudioConfig
    from pantomatrix_tpu_torch.nn.layers import strict_fp32
    from pantomatrix_tpu_torch.utils.precision import cast_once

    bf16, rows = torch.bfloat16, args.rows
    g = torch.Generator().manual_seed(3)
    res = {"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn": torch.backends.cudnn.version(), "root": root, "rows": rows}
    full = EmageAudioModel(EmageAudioConfig(), seed=5, device="cuda")
    model = cast_once(full, bf16)
    suite = EmageVQModel.random(seed=0, device="cuda")
    cfg = model.config
    audio = ((torch.rand(rows, WINDOW_FRAMES * SAMPLES_PER_FRAME, generator=g) - 0.5)
             * 0.5).cuda().to(bf16)
    spk = torch.zeros((rows, 1), dtype=torch.long, device="cuda")
    motion = torch.zeros(rows, WINDOW_FRAMES, MOTION_DIMS, device="cuda", dtype=bf16)
    mask = torch.ones_like(motion)
    mask[:, :cfg.seed_frames] = 0

    @torch.no_grad()
    @strict_fp32()
    def step():
        return emage._window_step(model, suite, audio, spk, motion, mask)

    # 1. one eager window step, by the part of the step that launched each kernel
    undo = scope({"emage": emage, "emage_vq": emage_vq, "model": model, "suite": suite})
    try:
        step_rows = common.attribute(common.profiled(step, warmup=2), component,
                                     ("region", "component", "op", "kernel"))
    finally:
        for u in undo:
            u()
    decode_rows = [r for r in step_rows if r["region"] == "vq_decode"]
    res["step"] = {
        "device_ms": sum(r["ms"] for r in step_rows),
        "vq_decode_device_ms": sum(r["ms"] for r in decode_rows),
        "eager_ms": common.time_ms(step, args.reps),
        "by_region": common.summarize(step_rows, joined("region")),
        "vq_decode_by_component": common.summarize(decode_rows, joined("component")),
        "vq_decode_by_component_op": common.summarize(decode_rows, joined("component", "op")),
        "rows": step_rows,
    }
    print(json.dumps({"card": card, "step": {k: v for k, v in res["step"].items()
                                             if k != "rows"}}), flush=True)

    # 3. the seed from the heads' tail against the whole window's decode
    with torch.no_grad(), strict_fp32():
        net = emage.emage_forward(model, audio, spk, motion, mask)
        pre, halo = cfg.seed_frames, emage._decoder_halo(suite)

        def seed_of(n):
            heads = {k: v[:, -n:] for k, v in net.items()}
            return emage.vq_decode(suite, **emage._select_decode_inputs(cfg, heads))[
                "all_motion4inference"][:, -pre:]
        want = seed_of(WINDOW_FRAMES)
        res["seed"] = {"halo": halo}
        for n in (pre + halo, pre + halo - 1):
            got = seed_of(n)
            res["seed"][f"frames_{n}"] = {
                "max_abs_err": float((got - want).abs().max()),
                "max_abs_seed": float(want.abs().max()),
                "bf16_values_differing": int((got.to(bf16) != want.to(bf16)).sum()),
                "values": want.numel()}
    print(json.dumps({"seed": res["seed"]}), flush=True)
    del net, want, got

    # 2. one call as the benchmark cell makes it, kernels by the span that launched them
    n = int(round(args.clip_seconds * 16000))
    caudio = ((torch.rand(rows, n, generator=g) - 0.5) * 0.5).cuda()
    ref_trans = torch.zeros(rows, 1, 3, device="cuda")

    def call():
        net = full.inference(caudio, spk, suite, compute_dtype="bfloat16", batched_wav=True)
        suite.decode(**emage._select_decode_inputs(cfg, net), get_global_motion=True,
                     ref_trans=ref_trans)

    prof = common.profiled(call, warmup=2)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        by_span = kernels_by_span(path)
    finally:
        os.unlink(path)
    ffma = {where: sum(s for k, s in v.items() if "f32f32" in k) for where, v in by_span.items()}
    res["call"] = {"clip_seconds": args.clip_seconds,
                   "device_s_by_span": {w: sum(v.values()) for w, v in by_span.items()},
                   "f32f32_conv_s_by_span": ffma,
                   "top_kernels_by_span": {w: dict(list(v.items())[:12])
                                           for w, v in by_span.items()}}
    print(json.dumps({"call": {k: v for k, v in res["call"].items()
                               if k != "top_kernels_by_span"}}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
