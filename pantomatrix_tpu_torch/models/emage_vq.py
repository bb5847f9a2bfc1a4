"""EMAGE motion tokenizers (counterpart of ``pantomatrix_tpu/models/emage_vq.py``):
the per-part conv VQ-VAEs, the global-translation VAE, and the composite decode.

Part widths: face 6+100 = 106, upper 13x6 = 78, hands 30x6 = 180, lower 9x6+3+4 = 61.
Face is decoded from its continuous latent by default, which re-quantizes it through
the VQ nearest-code kernel (``ops/vq_cuda.py``); the other parts decode from indices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.integrate import velocity2position
from ..core.masking import (
    JOINT_MASK_HANDS,
    JOINT_MASK_LOWER,
    JOINT_MASK_UPPER,
    recover_from_mask_ts,
)
from ..core.rotations import axis_angle_to_rotation_6d, rotation_6d_to_axis_angle
from ..nn.blocks import VQDecoder, VQEncoder
from ..nn.layers import strict_fp32
from ..nn.vq import Quantizer, get_codebook_entry
from ..ops.vq_cuda import nearest_code
from .configs import EmageVAEConvConfig, EmageVQVAEConvConfig


class EmageVAE(nn.Module):
    """Plain conv encoder-decoder (the global-translation model); keys encoder, decoder."""

    def __init__(self, cfg: EmageVAEConvConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.encoder = VQEncoder(cfg.vae_test_dim, cfg.vae_length, cfg.vae_layer,
                                 generator=generator)
        self.decoder = VQDecoder(cfg.vae_test_dim, cfg.vae_length, cfg.vae_layer,
                                 generator=generator)


class EmageVQVAE(nn.Module):
    """Encoder -> quantizer -> decoder; keys encoder, quantizer, decoder."""

    def __init__(self, cfg: EmageVQVAEConvConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        self.encoder = VQEncoder(cfg.vae_test_dim, cfg.vae_length, cfg.vae_layer,
                                 generator=generator)
        self.quantizer = Quantizer(cfg.vae_codebook_size, cfg.vae_length, generator=generator)
        self.decoder = VQDecoder(cfg.vae_test_dim, cfg.vae_length, cfg.vae_layer,
                                 generator=generator)


def vae_forward(m: EmageVAE, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"rec_pose": m.decoder(m.encoder(x))}


def vqvae_decode_index(m: EmageVQVAE, indices: torch.Tensor) -> torch.Tensor:
    return m.decoder(get_codebook_entry(m.quantizer, indices))


def vqvae_decode_latent(m: EmageVQVAE, latent: torch.Tensor) -> torch.Tensor:
    """Re-quantize a continuous latent to its nearest codes (the CUDA kernel on the
    card, its plain version on the CPU), then decode."""
    idx = nearest_code(latent.contiguous(), m.quantizer.embedding.weight)
    return vqvae_decode_index(m, idx)


class EmageVQSuite(nn.Module):
    """The five frozen tokenizer models EMAGE composes; each carries its config."""

    def __init__(self, face: EmageVQVAE, upper: EmageVQVAE, hands: EmageVQVAE,
                 lower: EmageVQVAE, global_motion: EmageVAE):
        super().__init__()
        self.face = face
        self.upper = upper
        self.hands = hands
        self.lower = lower
        self.global_motion = global_motion


def init_vq_suite(generator: torch.Generator) -> EmageVQSuite:
    """Random-init suite with the reference part widths, on the CPU."""
    part = lambda dim: EmageVQVAE(EmageVQVAEConvConfig(vae_test_dim=dim), generator=generator)
    return EmageVQSuite(
        face=part(106),
        upper=part(78),
        hands=part(180),
        lower=part(61),
        global_motion=EmageVAE(EmageVAEConvConfig(), generator=generator),
    )


def vq_get_global_motion(suite: EmageVQSuite, lower_body: torch.Tensor,
                         ref_trans: torch.Tensor) -> torch.Tensor:
    """Global VAE -> velocity channels [54:57] -> integrate x and z, y taken directly."""
    vel = vae_forward(suite.global_motion, lower_body)["rec_pose"][:, :, 54:57]
    if ref_trans.dim() == 2:
        ref_trans = ref_trans[None].expand((vel.shape[0],) + tuple(ref_trans.shape))
    x = velocity2position(vel[:, :, 0:1], 1.0 / 30, ref_trans[:, 0, 0:1])
    z = velocity2position(vel[:, :, 2:3], 1.0 / 30, ref_trans[:, 0, 2:3])
    return torch.cat([x, vel[:, :, 1:2], z], dim=-1)


@torch.no_grad()
@strict_fp32()
def vq_decode(
    suite: EmageVQSuite,
    face_index: Optional[torch.Tensor] = None,
    upper_index: Optional[torch.Tensor] = None,
    hands_index: Optional[torch.Tensor] = None,
    lower_index: Optional[torch.Tensor] = None,
    face_latent: Optional[torch.Tensor] = None,
    upper_latent: Optional[torch.Tensor] = None,
    hands_latent: Optional[torch.Tensor] = None,
    lower_latent: Optional[torch.Tensor] = None,
    get_global_motion: bool = False,
    ref_trans: Optional[torch.Tensor] = None,
) -> Dict[str, Optional[torch.Tensor]]:
    """Decode any mix of code indices / continuous latents to the full-body 165-d
    axis-angle stream, the expression, the 337-d rot6d+foot stream that seeds the next
    window, and, with ``get_global_motion``, the global translation."""
    for t_in in (face_index, upper_index, hands_index, lower_index,
                 face_latent, upper_latent, hands_latent, lower_latent):
        if t_in is not None:
            bs, t = t_in.shape[:2]
            device = t_in.device
            break
    else:
        raise ValueError("vq_decode needs at least one index/latent input")
    if get_global_motion and ref_trans is None:
        raise ValueError("get_global_motion needs ref_trans")
    zeros = lambda c: torch.zeros(bs, t, c, device=device)

    def decode(index, latent, model):
        if index is not None:
            return vqvae_decode_index(model, index)
        if latent is not None:
            return vqvae_decode_latent(model, latent)
        return None

    face_mix = decode(face_index, face_latent, suite.face)
    if face_mix is not None:
        face_jaw = rotation_6d_to_axis_angle(face_mix[:, :, :6])
        expression = face_mix[:, :, 6:]
    else:
        face_jaw, expression = zeros(3), zeros(100)

    to_aa = lambda six_d: rotation_6d_to_axis_angle(six_d.reshape(bs, t, -1, 6)).reshape(bs, t, -1)
    upper_6d = decode(upper_index, upper_latent, suite.upper)
    hands_6d = decode(hands_index, hands_latent, suite.hands)
    lower_mix = decode(lower_index, lower_latent, suite.lower)
    upper = to_aa(upper_6d) if upper_6d is not None else zeros(39)
    hands = to_aa(hands_6d) if hands_6d is not None else zeros(90)
    if lower_mix is not None:
        lower, transfoot = to_aa(lower_mix[:, :, :-7]), lower_mix[:, :, -7:]
    else:
        lower, transfoot = zeros(27), zeros(7)
        ident6 = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=device).repeat(bs, t, 9)
        lower_mix = torch.cat([ident6, transfoot], dim=-1)

    all_aa = (recover_from_mask_ts(upper, JOINT_MASK_UPPER)
              + recover_from_mask_ts(hands, JOINT_MASK_HANDS)
              + recover_from_mask_ts(lower, JOINT_MASK_LOWER))
    all_aa[:, :, 66:69] = face_jaw
    all_rot6d = axis_angle_to_rotation_6d(all_aa.reshape(bs, t, 55, 3)).reshape(bs, t, 330)
    return {
        "expression": expression,
        "all_motion4inference": torch.cat([all_rot6d, transfoot], dim=2),  # 337
        "motion_axis_angle": all_aa,
        "trans": (vq_get_global_motion(suite, lower_mix, ref_trans)
                  if get_global_motion else None),
    }


__all__ = [
    "EmageVAE",
    "EmageVQSuite",
    "EmageVQVAE",
    "init_vq_suite",
    "vae_forward",
    "vq_decode",
    "vq_get_global_motion",
    "vqvae_decode_index",
    "vqvae_decode_latent",
]
