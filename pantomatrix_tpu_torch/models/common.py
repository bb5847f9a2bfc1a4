"""Helpers shared by the CaMN and DisCo models (counterpart of
``pantomatrix_tpu/models/common.py``)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core.masking import recover_from_mask
from ..core.rotations import rotation_6d_to_axis_angle


def build_seed_motion(seed_motion: Optional[torch.Tensor], bs: int, t: int, pose_dims: int,
                      seed_frames: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Seed-motion channels with a trailing 0/1 "is-seed" flag: (bs, t, pose_dims + 1).

    Zeros everywhere but the first ``seed_frames`` frames, whose flag is 1 and whose
    pose channels come from ``seed_motion`` when given. A seed longer than
    ``seed_frames`` is truncated."""
    out = torch.zeros((bs, t, pose_dims + 1), dtype=dtype, device=device)
    out[:, :seed_frames, -1] = 1.0
    if seed_motion is not None:
        seed = seed_motion[:, :seed_frames, :].to(dtype)
        out[:, :seed_frames, :-1] = seed
    return out


def rot6d_seq_to_axis_angle_masked(motion6d: torch.Tensor,
                                   joint_mask: Sequence[bool]) -> torch.Tensor:
    """(bs, t, j*6) rot6d -> (bs, t, 165) axis-angle, scattered to the 55-joint layout."""
    bs, t, d = motion6d.shape
    aa = rotation_6d_to_axis_angle(motion6d.reshape(bs, t, d // 6, 6))
    return recover_from_mask(aa.reshape(bs, t, (d // 6) * 3), joint_mask)


def recombine_body_hands(body_out: torch.Tensor, hands_out: torch.Tensor) -> torch.Tensor:
    """Per-joint rot6d streams concatenated: body joints, then hand joints."""
    bs, t, bd = body_out.shape
    hd = hands_out.shape[-1]
    body = body_out.reshape(bs, t, bd // 6, 6)
    hands = hands_out.reshape(bs, t, hd // 6, 6)
    return torch.cat([body, hands], dim=2).reshape(bs, t, bd + hd)


def speaker_features(model: nn.Module, speaker_id: torch.Tensor,
                     like: torch.Tensor) -> torch.Tensor:
    """The speaker embedding broadcast over the frames of ``like`` (bs, t, c); width 0
    when the config has no speaker features."""
    bs, t, _ = like.shape
    f = model.config.speaker_f
    if f == 0:
        return like.new_zeros(bs, t, 0)
    return model.speaker_embedding(speaker_id).expand(bs, t, f)


__all__ = [
    "build_seed_motion",
    "recombine_body_hands",
    "rot6d_seq_to_axis_angle_masked",
    "speaker_features",
]
