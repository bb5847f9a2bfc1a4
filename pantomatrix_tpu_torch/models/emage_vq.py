"""EMAGE motion tokenizers (counterpart of ``pantomatrix_tpu/models/emage_vq.py``):
the per-part conv VQ-VAEs, the global-translation VAE, and the composite decode.

Part widths: face 6+100 = 106, upper 13x6 = 78, hands 30x6 = 180, lower 9x6+3+4 = 61.
Face is decoded from its continuous latent by default, which re-quantizes it through
the VQ nearest-code kernel (``ops/vq_cuda.py``); the other parts decode from indices.

The encode side (``vqvae_forward``, the ``map2index`` / ``map2latent`` functions, which
evaluation's VQ round trip and training call) searches with the expanded distance of
``nn/vq.py``, as the JAX package's XLA search does, not with the kernel.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
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
from ..nn.vq import Quantizer, get_codebook_entry, map2index, quantize
from ..ops.vq_cuda import nearest_code
from ..utils import trace
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

    def forward(self, inputs):
        return vae_forward(self, inputs)


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

    def forward(self, inputs):
        return vqvae_forward(self, inputs)


@strict_fp32()
def vae_forward(m: EmageVAE, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    return {"rec_pose": m.decoder(m.encoder(x))}


@strict_fp32()
def vqvae_forward(m: EmageVQVAE, x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Encoder -> quantizer (straight-through) -> decoder, with the reference's keys
    and two more for codebook health: the ``indices`` and the encoder's ``pre_latent``."""
    pre_latent = m.encoder(x)
    loss, z_q, idx, perplexity = quantize(m.quantizer, pre_latent,
                                          m.config.vae_quantizer_lambda)
    return {
        "poses_feat": z_q,
        "embedding_loss": loss,
        "perplexity": perplexity,
        "rec_pose": m.decoder(z_q),
        "indices": idx,
        "pre_latent": pre_latent,
    }


@torch.no_grad()
@strict_fp32()
def vqvae_map2index(m: EmageVQVAE, x: torch.Tensor) -> torch.Tensor:
    """(B, T, vae_test_dim) -> (B, T) int32 code indices."""
    return map2index(m.quantizer, m.encoder(x))


@torch.no_grad()
def vqvae_map2latent(m: EmageVQVAE, x: torch.Tensor) -> torch.Tensor:
    """(B, T, vae_test_dim) -> (B, T, vae_length): the codebook rows of the indices."""
    return get_codebook_entry(m.quantizer, vqvae_map2index(m, x))


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


PARTS = ("face", "upper", "hands", "lower")
UPPER_JOINTS = np.flatnonzero(JOINT_MASK_UPPER).tolist()
LOWER_JOINTS = np.flatnonzero(JOINT_MASK_LOWER).tolist()


def vq_split_inputs(smplx_body_rot6d: torch.Tensor, expression: torch.Tensor,
                    tar_contact: Optional[torch.Tensor] = None,
                    tar_trans: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """(bs, t, 330) rot6d and (bs, t, 100) expression, with foot contact (bs, t, 4) and
    translation (bs, t, 3) (zeros when absent) -> the four part streams: face = jaw
    rot6d + expression (106), upper (78), hands (180), lower = rot6d + trans + contact
    (61)."""
    bs, t, j6 = smplx_body_rot6d.shape
    r = smplx_body_rot6d.reshape(bs, t, j6 // 6, 6)
    zeros = lambda c: smplx_body_rot6d.new_zeros(bs, t, c)
    tar_contact = zeros(4) if tar_contact is None else tar_contact
    tar_trans = zeros(3) if tar_trans is None else tar_trans
    return {
        "face": torch.cat([r[:, :, 22], expression], dim=2),
        "upper": r[:, :, UPPER_JOINTS].reshape(bs, t, 78),
        "hands": r[:, :, 25:55].reshape(bs, t, 180),
        "lower": torch.cat([r[:, :, LOWER_JOINTS].reshape(bs, t, 54), tar_trans, tar_contact],
                           dim=2),
    }


def vq_map2index(suite: EmageVQSuite, rot6d, expression, tar_contact=None, tar_trans=None):
    """Per part, (bs, t) int32 code indices of the split inputs."""
    x = vq_split_inputs(rot6d, expression, tar_contact, tar_trans)
    return {part: vqvae_map2index(getattr(suite, part), x[part]) for part in PARTS}


def vq_map2latent(suite: EmageVQSuite, rot6d, expression, tar_contact=None, tar_trans=None):
    """Per part, (bs, t, vae_length) codebook rows of the split inputs."""
    x = vq_split_inputs(rot6d, expression, tar_contact, tar_trans)
    return {part: vqvae_map2latent(getattr(suite, part), x[part]) for part in PARTS}


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
    window, and, with ``get_global_motion``, the global translation.

    The tokenizer suite runs in float32 whatever the serving mode: latents in a lower
    precision are promoted here, as JAX type promotion does against the float32
    suite, so the nearest-code kernel always takes float32."""
    promote = lambda x: None if x is None else x.float()
    face_latent, upper_latent = promote(face_latent), promote(upper_latent)
    hands_latent, lower_latent = promote(hands_latent), promote(lower_latent)
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

    def decode(part, index, latent):
        if index is None and latent is None:
            return None
        # a span of the part's decode, which records nothing while a graph is captured
        with trace.span("vq.part", latent if index is None else index, part=part):
            if index is not None:
                return vqvae_decode_index(getattr(suite, part), index)
            return vqvae_decode_latent(getattr(suite, part), latent)

    face_mix = decode("face", face_index, face_latent)
    if face_mix is not None:
        face_jaw = rotation_6d_to_axis_angle(face_mix[:, :, :6])
        expression = face_mix[:, :, 6:]
    else:
        face_jaw, expression = zeros(3), zeros(100)

    to_aa = lambda six_d: rotation_6d_to_axis_angle(six_d.reshape(bs, t, -1, 6)).reshape(bs, t, -1)
    upper_6d = decode("upper", upper_index, upper_latent)
    hands_6d = decode("hands", hands_index, hands_latent)
    lower_mix = decode("lower", lower_index, lower_latent)
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
    "vq_map2index",
    "vq_map2latent",
    "vq_split_inputs",
    "vqvae_decode_index",
    "vqvae_decode_latent",
    "vqvae_forward",
    "vqvae_map2index",
    "vqvae_map2latent",
]
