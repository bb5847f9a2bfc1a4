"""CaMN (counterpart of ``pantomatrix_tpu/models/camn.py``): audio -> upper body,
cascaded -> hands, at 15 fps.

WavEncoder (/1080) -> [audio | speaker | seed motion + flag] -> 4-layer bi-LSTM ->
forward + backward sum -> MLP -> body rot6d (78); the hands bi-LSTM reads the same input
with the body output appended (the cascade) -> MLP -> hands rot6d (180); the two are
recombined into (bs, t, 258) and, optionally, turned into 165-d axis-angle through the
``local_upper`` joint mask. Every LSTM direction goes through kernel K2 on the card.

The model is built in eval mode, and ``model(...)`` is ``camn_forward``: inference,
without gradients. In train mode (``model.train()``) ``model(...)`` is ``camn_apply``,
the same computation with gradients, batch-statistics BatchNorm and dropout (the JAX
``camn_forward`` with a train ``Ctx``), which ``train/steps.py`` calls.

Spans (``utils/trace.py``, recorded only under a profiler): ``camn.forward`` around the
inference, ``camn.audio_encoder`` around the WavEncoder, and ``lstm.layer`` (``nn/lstm.py``).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.masking import MASK_DICT
from ..nn.blocks import MLP, WavEncoder
from ..nn.layers import Embedding, strict_fp32
from ..nn.lstm import LSTM
from ..utils import trace
from ..utils.precision import cast_once, compute_dtype_of
from .common import (
    build_seed_motion,
    recombine_body_hands,
    rot6d_seq_to_axis_angle_masked,
    speaker_features,
)
from .configs import CamnAudioConfig


class CamnAudio(nn.Module):
    """The CaMN parameters, named as the JAX ``init_camn`` tree."""

    def __init__(self, cfg: CamnAudioConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        g = generator
        in_body = cfg.pose_dims + 1 + cfg.speaker_f + cfg.audio_f
        self.audio_encoder = WavEncoder(cfg.audio_f, "camn", generator=g)
        self.body_motion_decoder = LSTM(in_body, cfg.hidden_size, cfg.n_layer, generator=g,
                                        dropout=cfg.dropout_prob)
        self.body_out = MLP(cfg.hidden_size, cfg.hidden_size, cfg.body_dims, generator=g)
        self.hands_motion_decoder = LSTM(in_body + cfg.body_dims, cfg.hidden_size,
                                         cfg.n_layer, generator=g, dropout=cfg.dropout_prob)
        self.hands_out = MLP(cfg.hidden_size, cfg.hidden_size, cfg.hands_dims, generator=g)
        if cfg.speaker_f > 0:
            self.speaker_embedding = Embedding(cfg.speaker_dims, cfg.speaker_f, generator=g)
        self.eval()

    def forward(self, audio, speaker_id, seed_frames: int = 4, seed_motion=None,
                return_axis_angle: bool = True, compute_dtype=None):
        if self.training:
            return camn_apply(self, audio, speaker_id, seed_frames, seed_motion,
                              return_axis_angle)
        return camn_forward(self, audio, speaker_id, seed_frames, seed_motion,
                            return_axis_angle, compute_dtype)


@torch.no_grad()
@strict_fp32()
def camn_forward(model: CamnAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                 seed_frames: int = 4, seed_motion: Optional[torch.Tensor] = None,
                 return_axis_angle: bool = True, compute_dtype=None) -> Dict[str, torch.Tensor]:
    """audio (bs, samples) at 16 kHz, speaker_id (bs, 1) int -> ``motion`` rot6d
    (bs, t, 258) and ``motion_axis_angle`` (bs, t, 165), in float32.

    ``compute_dtype="bfloat16"``: the serving mode of the JAX package. The weights
    (``utils/precision.cast_once``) and the audio are cast once; the conv, LSTM and MLP
    work runs in bfloat16 (float32 reductions inside the primitives, the LSTM recurrence
    in float32, see ``nn/lstm.py``); ``motion`` is cast back to float32 before the
    axis-angle step. None, the default, is the float32 parity path."""
    with trace.span("camn.forward", audio, batch=audio.shape[0]):
        dtype = compute_dtype_of(compute_dtype)
        if dtype is not None:
            model, audio = cast_once(model, dtype), audio.to(dtype)
        out = camn_apply(model, audio, speaker_id, seed_frames, seed_motion,
                         return_axis_angle)
        trace.annotate("camn.forward", frames=out["motion"].shape[1])
        return out


def camn_apply(model: CamnAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
               seed_frames: int = 4, seed_motion: Optional[torch.Tensor] = None,
               return_axis_angle: bool = True) -> Dict[str, torch.Tensor]:
    """The CaMN computation in the weights' dtype, in whatever mode ``model`` is, with
    gradients where autograd is on; ``motion`` comes back in float32."""
    cfg = model.config
    h = cfg.hidden_size
    with trace.span("camn.audio_encoder", audio):
        audio_feat = model.audio_encoder(audio)
    bs, t, _ = audio_feat.shape
    seed = build_seed_motion(seed_motion, bs, t, cfg.pose_dims, seed_frames,
                             audio_feat.dtype, audio_feat.device)
    in_fea = torch.cat([audio_feat, speaker_features(model, speaker_id, audio_feat), seed],
                       dim=2)

    body = model.body_motion_decoder(in_fea)
    body_out = model.body_out(body[:, :, :h] + body[:, :, h:])
    hands = model.hands_motion_decoder(torch.cat([in_fea, body_out], dim=2))
    hands_out = model.hands_out(hands[:, :, :h] + hands[:, :, h:])

    motion = recombine_body_hands(body_out, hands_out).float()
    out = {"motion": motion}
    if return_axis_angle:
        out["motion_axis_angle"] = rot6d_seq_to_axis_angle_masked(
            motion, MASK_DICT[cfg.joint_mask])
    return out


__all__ = ["CamnAudio", "camn_apply", "camn_forward"]
