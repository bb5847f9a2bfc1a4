"""CaMN: the program's ``CamnAudioModel`` forward, against the frozen reference of
``reference/camn.py``.

What is judged of a call (the whole batch at the window's clip length and serving mode):
- ``motion_err``: the rot6d motion against the reference's, over the whole batch;
- ``motion_row_err_max``: the same, row by row, the worst row;
- ``rotation_err``: the axis-angle output, as rotation matrices (the axis-angle of a
  rotation near pi flips with rounding; its matrix does not).
"""
from __future__ import annotations

import torch

from harness import flops, weights
from harness.adapter import Adapter as Base
from harness.adapter import derive, port_module, speech_like
from harness.common import relative_error
from reference.camn import Camn
from reference.layers import axis_angle_to_matrix, exact_fp32, set_numerics


class Adapter(Base):
    def setup(self):
        cfg, mix, dev = self.model_cfg, self.mix, self.device
        self.batch = int(mix["batch"])
        self.samples = int(round(float(mix["clip_seconds"]) * 16000))
        self.ref = weights.build(lambda: Camn(cfg), derive(self.seed, "camn"), dev)
        self.mark("weights")
        g = self.generator("inputs")
        n = int(mix.get("distinct_inputs", 1))
        self.audio = speech_like(g, n, self.batch, self.samples, dev)
        self.speaker = torch.zeros(self.batch, 1, dtype=torch.long, device=dev)
        self.frames = None
        self.mark("inputs")
        if self.program == "port":
            from pantomatrix_tpu_torch.models.api import CamnAudioModel
            from pantomatrix_tpu_torch.models.configs import CamnAudioConfig

            self.model = port_module(
                lambda d: CamnAudioModel(CamnAudioConfig(**cfg), device=d), self.ref)
            self.mark("program")

    @property
    def motion_seconds_per_call(self) -> float:
        return self.batch * self.frames / float(self.model_cfg["pose_fps"])

    def call(self, i: int):
        audio = self.audio[i % len(self.audio)]
        if self.program == "port":
            out = self.model(audio, self.speaker, compute_dtype=self.mix.get("compute_dtype"))
        else:
            with torch.no_grad(), exact_fp32():
                set_numerics(self.ref, "float8_e4m3")
                try:
                    out = self.ref(audio, self.speaker)
                finally:
                    set_numerics(self.ref, "float32")
        self.frames = out["motion"].shape[1]
        return out

    def free_program(self):
        if hasattr(self, "model"):
            del self.model
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def k2_shape(self):
        """(T, B, H) of each bidirectional LSTM layer's recurrence (K2's launch)."""
        return {"t": self.frames, "b": self.batch, "h": self.model_cfg["hidden_size"]}

    def check(self, i: int, out: dict, count_flops: bool = False):
        """The numbers compared for call ``i``'s outputs, and (when asked) the FLOPs of
        one call, counted over the reference once a shape."""
        audio = self.audio[i % len(self.audio)]
        with torch.no_grad(), exact_fp32():
            ref = self.ref(audio, self.speaker)
            rot = lambda aa: axis_angle_to_matrix(aa.reshape(aa.shape[:2] + (55, 3)))
            p, q = out["motion"], ref["motion"]
            checks = {
                "motion_err": relative_error(p, q),
                "motion_row_err_max": max(relative_error(p[r], q[r])
                                          for r in range(p.shape[0])),
                "rotation_err": relative_error(rot(out["motion_axis_angle"]),
                                               rot(ref["motion_axis_angle"])),
            }
            count = None
            if count_flops:
                key = {"family": "camn", "model": self.model_cfg, "batch": self.batch,
                       "samples": self.samples}
                count = flops.cached(key, lambda: self.ref(audio, self.speaker))
        return checks, count
