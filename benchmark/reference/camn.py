"""Frozen plain reference of CaMN (PantoMatrix ``camn_audio``): WavEncoder /1080 ->
[audio | speaker | seed motion + flag] -> 4-layer bidirectional LSTM -> forward +
backward sum -> MLP -> upper-body rot6d; the hands LSTM reads the same input with the body
output appended -> MLP -> hands rot6d; axis-angle through the ``local_upper`` mask.

Parameter names are those of the published checkpoint (``H-Liu1997/camn_audio``).
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import LSTM, MLP, Embedding, WavEncoder, recover_from_mask, rot6d_to_axis_angle

LOCAL_UPPER = [
    False, False, False, True, False, False, True, False, False, True,
    False, False, True, True, True, True, True, True, True, True,
    True, True, False, False, False, True, True, True, True, True,
] + [True] * 25


class Camn(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        h = cfg["hidden_size"]
        in_body = cfg["pose_dims"] + 1 + cfg["speaker_f"] + cfg["audio_f"]
        self.audio_encoder = WavEncoder(cfg["audio_f"], "camn")
        self.speaker_embedding = Embedding(cfg["speaker_dims"], cfg["speaker_f"])
        self.body_motion_decoder = LSTM(in_body, h, cfg["n_layer"])
        self.body_out = MLP(h, h, cfg["body_dims"])
        self.hands_motion_decoder = LSTM(in_body + cfg["body_dims"], h, cfg["n_layer"])
        self.hands_out = MLP(h, h, cfg["hands_dims"])

    def forward(self, audio, speaker_id):
        """audio (B, samples) at 16 kHz -> ``motion`` rot6d (B, T, 258) and
        ``motion_axis_angle`` (B, T, 165); the seed-motion slots are zero but for the
        first ``seed_frames`` frames' flag."""
        cfg, h = self.cfg, self.cfg["hidden_size"]
        feat = self.audio_encoder(audio)
        bs, t, _ = feat.shape
        spk = self.speaker_embedding(speaker_id).expand(bs, t, cfg["speaker_f"])
        n = cfg["seed_frames"]
        seed = feat.new_zeros(bs, t, cfg["pose_dims"] + 1)
        seed[:, :n, -1] = 1.0
        x = torch.cat((feat, spk, seed), 2)
        body = self.body_motion_decoder(x)
        body = self.body_out(body[..., :h] + body[..., h:])
        hands = self.hands_motion_decoder(torch.cat((x, body), 2))
        hands = self.hands_out(hands[..., :h] + hands[..., h:])
        motion = torch.cat((body.reshape(bs, t, -1, 6), hands.reshape(bs, t, -1, 6)), 2)
        aa = rot6d_to_axis_angle(motion).reshape(bs, t, -1)
        return {"motion": motion.reshape(bs, t, -1),
                "motion_axis_angle": recover_from_mask(aa, LOCAL_UPPER)}

