"""EMAGE: the program's ``EmageAudioModel.inference`` and ``EmageVQModel.decode
(get_global_motion=True)``, against the frozen reference of ``reference/emage.py``.

What is judged of a call (the batch, the clip length and the serving mode of the window):
- ``first_window_err``: the first window's network outputs (every head's latents and
  logits, the frames the call keeps) against the reference's; the first window's inputs
  depend on nothing the program generated, so both sides see the same inputs.
- ``window_err_median_max``: every later window, the remainder window too, against the
  reference's window seeded as the program seeds it, by the decode of the heads the
  program chose in the window before (``reference.emage.follow``: the program's seed is
  internal, and of the window before's last ``seed_frames`` frames, which the call does
  not keep, the reference's own choices stand in, with each near tie also tried
  flipped). A row's error in a window is the worst of its outputs' relative errors over
  the kept frames. A row whose error is over 0.05 has parted from the reference's (a
  rounding flip that no candidate covers, or a fault), and its later seeds come from a
  window unlike the program's, so it is followed no further. Each window in which at
  least a sixteenth of the batch is still followed reads the median of those rows' errors;
  the number is the worst window's. ``windows_judged`` and ``rows_followed_to_end`` (the
  share of rows never parted) are shown, not compared.
- ``decode_err``: the decoded poses (as rotation matrices), expressions and translation
  against the reference's decode of the program's own routed heads (its code indices and
  its face latent), over the whole clip.
"""
from __future__ import annotations

import sys
import time

import torch

from harness import flops, weights
from harness.adapter import Adapter as Base
from harness.adapter import derive, port_module, speech_like
from harness.common import relative_error
from reference.emage import Emage, Suite, decode, follow, generate, route, windows
from reference.layers import axis_angle_to_matrix, exact_fp32, set_numerics

OUTPUT_KEYS = ("motion_axis_angle", "expression", "trans")


class Adapter(Base):
    def setup(self):
        cfg, mix, dev = self.model_cfg, self.mix, self.device
        self.batch = int(mix["batch"])
        self.samples = int(round(float(mix["clip_seconds"]) * 16000))
        self.frames = self.samples * 30 // 16000
        self.ref = weights.build(lambda: Emage(cfg), derive(self.seed, "emage"), dev)
        self.suite = weights.build(lambda: Suite(cfg["vae_length"], cfg["vae_codebook_size"]),
                                   derive(self.seed, "suite"), dev)
        self.mark("weights")
        g = self.generator("inputs")
        n = int(mix.get("distinct_inputs", 1))
        self.audio = speech_like(g, n, self.batch, self.samples, dev)
        self.speaker = torch.zeros(self.batch, 1, dtype=torch.long, device=dev)
        self.ref_trans = torch.zeros(self.batch, 1, 3, device=dev)
        self.mark("inputs")
        if self.program == "port":
            from pantomatrix_tpu_torch.models.api import EmageAudioModel, EmageVQModel
            from pantomatrix_tpu_torch.models.configs import EmageAudioConfig
            from pantomatrix_tpu_torch.models.emage import _select_decode_inputs

            self.model = port_module(
                lambda d: EmageAudioModel(EmageAudioConfig(**cfg), device=d), self.ref)
            self.vq = port_module(lambda d: EmageVQModel.random(device=d), self.suite)
            self.select = _select_decode_inputs
            self.mark("program")

    @property
    def motion_seconds_per_call(self) -> float:
        return self.batch * self.frames / float(self.model_cfg["pose_fps"])

    def _inference(self, audio):
        if self.program == "port":
            return self.model.inference(audio, self.speaker, self.vq,
                                        compute_dtype=self.mix.get("compute_dtype"),
                                        batched_wav=bool(self.mix.get("batched_wav", False)))
        with torch.no_grad(), exact_fp32():
            set_numerics(self.ref, "float8_e4m3")
            set_numerics(self.suite, "bfloat16")
            try:
                return generate(self.ref, self.suite, audio, self.speaker)
            finally:
                set_numerics(self.ref, "float32")
                set_numerics(self.suite, "float32")

    def _decode(self, net):
        if self.program == "port":
            dec = self.vq.decode(**self.select(self.model.config, net), get_global_motion=True,
                                 ref_trans=self.ref_trans)
        else:
            with torch.no_grad(), exact_fp32():
                set_numerics(self.suite, "bfloat16")
                try:
                    dec = decode(self.suite, route(self.model_cfg, net), self.ref_trans)
                finally:
                    set_numerics(self.suite, "float32")
        return {k: dec[k] for k in OUTPUT_KEYS}

    def call(self, i: int):
        net = self._inference(self.audio[i % len(self.audio)])
        return {"net": net, "dec": self._decode(net)}

    def timed_call(self, i: int, spans: dict):
        self.sync()
        t0 = time.perf_counter()
        net = self._inference(self.audio[i % len(self.audio)])
        self.complete(net)
        t1 = time.perf_counter()
        dec = self._decode(net)
        self.complete(dec)
        t2 = time.perf_counter()
        for name, v in (("inference", t1 - t0), ("decode", t2 - t1), ("call", t2 - t0)):
            spans.setdefault(name, []).append(v)
        return {"net": net, "dec": dec}

    def free_program(self):
        for name in ("model", "vq"):
            if hasattr(self, name):
                delattr(self, name)
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, i: int, out: dict, count_flops: bool = False):
        """The numbers compared for call ``i``'s outputs, and (when asked) the FLOPs of
        one call, counted over the reference's generation and decode once a shape."""
        cfg = self.model_cfg
        audio = self.audio[i % len(self.audio)]
        net, dec = out["net"], out["dec"]
        with torch.no_grad(), exact_fp32():
            ref_first, later = follow(self.ref, self.suite, audio, self.speaker, net)
            ref_dec = decode(self.suite, route(cfg, net), self.ref_trans)
            first = windows(cfg, self.frames)[0][2]
            first_err = max(relative_error(net[k][:, :first], ref_first[k][:, :first])
                            for k in ref_first)
            least = -(-len(audio) // 16)
            medians = [float(err.median()) for _, _, rows, err in later if len(rows) >= least]
            followed = float((later[-1][3] <= 0.05).sum()) / len(audio) if later else 1.0
            print("benchmark: window medians " + " ".join(f"{m:.4g}" for m in medians)
                  + "; rows followed " + " ".join(str(len(r)) for _, _, r, _ in later),
                  file=sys.stderr, flush=True)
            rot = lambda aa: axis_angle_to_matrix(aa.reshape(aa.shape[:2] + (55, 3)))
            pairs = [(rot(dec["motion_axis_angle"]), rot(ref_dec["motion_axis_angle"])),
                     (dec["expression"], ref_dec["expression"]),
                     (dec["trans"], ref_dec["trans"])]
            checks = {
                "first_window_err": first_err,
                "window_err_median_max": max(medians, default=0.0),
                "windows_judged": float(len(medians)),
                "rows_followed_to_end": followed,
                "decode_err": max(relative_error(p, q) for p, q in pairs),
            }
            count = None
            if count_flops:
                key = {"family": "emage", "model": cfg, "batch": self.batch,
                       "samples": self.samples}
                count = flops.cached(key, lambda: decode(
                    self.suite, route(cfg, generate(self.ref, self.suite, audio, self.speaker)),
                    self.ref_trans))
        return checks, count
