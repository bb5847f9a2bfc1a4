"""Faults planted under the timed path, one for each way a cell can be broken: the state
handed on unchanged, half of the batch left out, an answer altered where it is produced.
The correctness check has to fail each (``tests/test_bench_faults.py`` on the CPU;
``tools/readings.py --fault`` reads one on the card at the cell's own size).

Each fault takes ``patch(owner, name, value)``, which replaces an attribute of the program
and can undo it (pytest's ``monkeypatch.setattr``, or :class:`Patcher`).
"""
import torch


class Patcher:
    """``patch(owner, name, value)`` that remembers what it replaced."""

    def __init__(self):
        self.undo = []

    def __call__(self, owner, name, value):
        self.undo.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def restore(self):
        for owner, name, value in reversed(self.undo):
            setattr(owner, name, value)
        self.undo.clear()


def _emage_state_unchanged(patch):
    from pantomatrix_tpu_torch.models import emage

    step = emage._window_step

    def stuck(model, suite, audio, spk, motion, mask, feats=None):
        net, _ = step(model, suite, audio, spk, motion, mask, feats)
        return net, motion[:, :model.config.seed_frames]  # the seed handed on unchanged

    patch(emage, "_window_step", stuck)


def _emage_state_stops_after_second(patch):
    """The seed handed on unchanged from the second window on, so that the third and
    later windows are seeded wrong (eager windows: a CUDA graph replays the step it
    captured, so on the card this needs the graphs' capture patched too)."""
    from pantomatrix_tpu_torch.models import emage
    from pantomatrix_tpu_torch.models.api import EmageAudioModel

    step, infer = emage._window_step, EmageAudioModel.inference
    calls = [0]

    def stuck(model, suite, audio, spk, motion, mask, feats=None):
        calls[0] += 1
        net, last = step(model, suite, audio, spk, motion, mask, feats)
        return net, (motion[:, :model.config.seed_frames] if calls[0] >= 2 else last)

    def counted(self, *a, **k):
        calls[0] = 0
        return infer(self, *a, **k)

    patch(emage, "_window_step", stuck)
    patch(EmageAudioModel, "inference", counted)


def _emage_remainder_shifted(patch):
    """The remainder window (the eager one, shorter than a full window) given audio from
    the wrong offset."""
    from pantomatrix_tpu_torch.models import emage

    step = emage._window_step

    def shifted(model, suite, audio, spk, motion, mask, feats=None):
        if motion.shape[1] != model.config.pose_length:
            audio = torch.roll(audio, audio.shape[1] // 2, dims=1)
        return step(model, suite, audio, spk, motion, mask, feats)

    patch(emage, "_window_step", shifted)


def _emage_half_batch(patch):
    from pantomatrix_tpu_torch.models.api import EmageAudioModel

    infer = EmageAudioModel.inference

    def half(self, audio, spk, vq, *a, **k):
        h = audio.shape[0] // 2
        out = infer(self, audio[:h], spk[:h], vq, *a, **k)
        return {key: torch.cat([v, v]) for key, v in out.items()}  # the rest stands in

    patch(EmageAudioModel, "inference", half)


def _emage_answer_altered(patch):
    from pantomatrix_tpu_torch.models.api import EmageVQModel

    dec = EmageVQModel.decode

    def altered(self, **k):
        out = dec(self, **k)
        out["motion_axis_angle"][0] += 0.1  # one row's take, where it is produced
        return out

    patch(EmageVQModel, "decode", altered)


def _camn_state_unchanged(patch):
    from pantomatrix_tpu_torch.nn import lstm

    def stuck(x_proj, w_hh, hidden):
        return x_proj.new_zeros(x_proj.shape[:2] + (2 * hidden,))  # h stays at h0 = 0

    patch(lstm, "lstm_bidirectional", stuck)


def _camn_half_batch(patch):
    from pantomatrix_tpu_torch.models.camn import CamnAudio

    fwd = CamnAudio.forward

    def half(self, audio, spk, *a, **k):
        h = audio.shape[0] // 2
        out = fwd(self, audio[:h], spk[:h], *a, **k)
        return {key: torch.cat([v, v]) for key, v in out.items()}

    patch(CamnAudio, "forward", half)


def _camn_answer_altered(patch):
    from pantomatrix_tpu_torch.models.camn import CamnAudio

    fwd = CamnAudio.forward

    def altered(self, *a, **k):
        out = fwd(self, *a, **k)
        out["motion"][0] += 0.1  # one row's take, where it is produced
        return out

    patch(CamnAudio, "forward", altered)


FAULTS = {
    "emage-offline-bf16": {"state_unchanged": _emage_state_unchanged,
                           "state_stops_after_second": _emage_state_stops_after_second,
                           "remainder_shifted": _emage_remainder_shifted,
                           "half_batch": _emage_half_batch,
                           "answer_altered": _emage_answer_altered},
    "camn-offline-bf16": {"state_unchanged": _camn_state_unchanged,
                          "half_batch": _camn_half_batch,
                          "answer_altered": _camn_answer_altered}
}
