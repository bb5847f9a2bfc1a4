"""DisCo (counterpart of ``pantomatrix_tpu/models/disco.py``): audio -> upper-body
gesture with content/rhythm disentanglement, at 15 fps.

The WavEncoder features feed three MLP heads (content 1, content 2, rhythm); a softmax
selector over the last axis blends the two content streams; the decoder bi-LSTM reads
[content | rhythm | speaker | seed motion + flag], and one MLP emits the 258-d rot6d
pose (no hands cascade). Every LSTM direction goes through kernel K2 on the card.

As for CaMN, ``model(...)`` is ``disco_forward`` (inference) in eval mode, the mode the
model is built in, and ``disco_apply`` (gradients, train-mode layers) after
``model.train()``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.masking import MASK_DICT
from ..nn.blocks import MLP, WavEncoder
from ..nn.layers import Embedding, strict_fp32
from ..nn.lstm import LSTM
from ..utils.precision import cast_once, compute_dtype_of
from .common import build_seed_motion, rot6d_seq_to_axis_angle_masked, speaker_features
from .configs import DiscoAudioConfig


class DiscoAudio(nn.Module):
    """The DisCo parameters, named as the JAX ``init_disco`` tree."""

    def __init__(self, cfg: DiscoAudioConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        g = generator
        a, h = cfg.audio_f, cfg.hidden_size
        self.audio_encoder = WavEncoder(a, "camn", generator=g)
        self.audio_encoder_c1 = MLP(a, h, a, generator=g)
        self.audio_encoder_c2 = MLP(a, h, a, generator=g)
        self.audio_encoder_r = MLP(a, h, a, generator=g)
        self.selector = MLP(a, h, 2, generator=g)
        self.body_motion_decoder = LSTM(cfg.pose_dims + 1 + cfg.speaker_f + 2 * a, h,
                                        cfg.n_layer, generator=g, dropout=cfg.dropout_prob)
        self.body_out = MLP(h, h, cfg.pose_dims, generator=g)
        if cfg.speaker_f > 0:
            self.speaker_embedding = Embedding(cfg.speaker_dims, cfg.speaker_f, generator=g)
        self.eval()

    def forward(self, audio, speaker_id, seed_frames: int = 4, seed_motion=None,
                return_axis_angle: bool = True, compute_dtype=None):
        if self.training:
            return disco_apply(self, audio, speaker_id, seed_frames, seed_motion,
                               return_axis_angle)
        return disco_forward(self, audio, speaker_id, seed_frames, seed_motion,
                             return_axis_angle, compute_dtype)


@torch.no_grad()
@strict_fp32()
def disco_forward(model: DiscoAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                  seed_frames: int = 4, seed_motion: Optional[torch.Tensor] = None,
                  return_axis_angle: bool = True, compute_dtype=None,
                  ) -> Dict[str, torch.Tensor]:
    """audio (bs, samples) at 16 kHz, speaker_id (bs, 1) int -> ``motion`` rot6d
    (bs, t, 258), the blended content ``audio_fea_c`` and rhythm ``audio_fea_r``
    features, and ``motion_axis_angle`` (bs, t, 165), in float32.

    ``compute_dtype="bfloat16"``: the serving mode, as in ``camn_forward``; the audio
    features come back in bfloat16, ``motion`` and its axis angles in float32."""
    dtype = compute_dtype_of(compute_dtype)
    if dtype is not None:
        model, audio = cast_once(model, dtype), audio.to(dtype)
    return disco_apply(model, audio, speaker_id, seed_frames, seed_motion, return_axis_angle)


def disco_apply(model: DiscoAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                seed_frames: int = 4, seed_motion: Optional[torch.Tensor] = None,
                return_axis_angle: bool = True) -> Dict[str, torch.Tensor]:
    """The DisCo computation in the weights' dtype, in whatever mode ``model`` is, with
    gradients where autograd is on; ``motion`` comes back in float32, the audio features
    in the weights' dtype."""
    cfg = model.config
    h = cfg.hidden_size
    audio_feat = model.audio_encoder(audio)
    bs, t, _ = audio_feat.shape
    seed = build_seed_motion(seed_motion, bs, t, cfg.pose_dims, seed_frames,
                             audio_feat.dtype, audio_feat.device)

    c1 = model.audio_encoder_c1(audio_feat)
    c2 = model.audio_encoder_c2(audio_feat)
    rhythm = model.audio_encoder_r(audio_feat)
    weight_c = torch.softmax(model.selector(audio_feat), dim=2)
    content = weight_c[:, :, 0:1] * c1 + weight_c[:, :, 1:2] * c2

    in_fea = torch.cat([content, rhythm, speaker_features(model, speaker_id, audio_feat), seed],
                       dim=2)
    body = model.body_motion_decoder(in_fea)
    motion = model.body_out(body[:, :, :h] + body[:, :, h:]).float()
    out = {"motion": motion, "audio_fea_c": content, "audio_fea_r": rhythm}
    if return_axis_angle:
        out["motion_axis_angle"] = rot6d_seq_to_axis_angle_masked(
            motion, MASK_DICT[cfg.joint_mask])
    return out


__all__ = ["DiscoAudio", "disco_apply", "disco_forward"]
