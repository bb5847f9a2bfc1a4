"""EMAGE masked audio-gesture transformer at inference (counterpart of
``pantomatrix_tpu/models/emage.py``), with the reference's quirks:

- the duplicated audio-truncation branch assigns ``audio2face_fea`` twice; the body
  stream is deliberately not truncated;
- ``t`` is taken from the audio feature length;
- frame -> sample mapping ``16000 // 30 == 533``.

The JAX package runs the sliding-window generation as one ``lax.scan`` program; here it
is a Python loop over 64-frame windows with a 4-frame decoded seed, plus a remainder
window. The three per-part branches, which JAX ``vmap``s over stacked params, are
named submodules called in turn.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..core.rotations import axis_angle_to_rotation_6d
from ..nn.attention import TransformerDecoder, TransformerEncoder
from ..nn.blocks import MLP, VQEncoder, WavEncoder, make_periodic_pe, periodic_positional_encoding
from ..nn.layers import Embedding, Linear, log_softmax, normal, strict_fp32
from .configs import EmageAudioConfig
from .emage_vq import EmageVQSuite, vq_decode

SAMPLES_PER_FRAME = 16000 // 30  # == 533, the reference's exact mapping

PARTS = ("upper", "hands", "lower")


class PositionEmbeddings(nn.Module):
    """Holds the periodic PE table as buffer ``pe`` (it is part of the param tree)."""

    def __init__(self, d_model: int, period: int):
        super().__init__()
        self.register_buffer("pe", make_periodic_pe(d_model, period, period))


class EmageAudio(nn.Module):
    """The EMAGE audio model's parameters, named as the JAX ``init_emage`` tree
    (including the reference's ``moton_proj`` spelling)."""

    def __init__(self, cfg: EmageAudioConfig, *, generator: torch.Generator):
        super().__init__()
        self.config = cfg
        g = generator
        h = cfg.hidden_size
        cb = cfg.vae_codebook_size
        self.audio_encoder_face = WavEncoder(cfg.audio_f, generator=g)
        self.audio_encoder_body = WavEncoder(cfg.audio_f, generator=g)
        self.speaker_embedding_body = Embedding(cfg.speaker_dims, h, generator=g)
        self.speaker_embedding_face = Embedding(cfg.speaker_dims, h, generator=g)
        self.mask_embedding = normal((1, 1, cfg.pose_dims + 7), h ** -0.5, g)
        self.motion_encoder = VQEncoder(cfg.pose_dims + 7, cfg.motion_f, 3, generator=g)
        self.bodyhints_face = MLP(cfg.motion_f, h, cfg.motion_f, generator=g)
        self.bodyhints_body = MLP(cfg.motion_f, h, cfg.motion_f, generator=g)
        self.audio_body_motion_proj = Linear(cfg.audio_f, h, generator=g)
        self.moton_proj = Linear(cfg.motion_f, h, generator=g)
        self.position_embeddings = PositionEmbeddings(h, cfg.pose_length)
        self.motion_self_encoder = TransformerEncoder(1, h, h * 2, 4, generator=g)
        self.audio_motion_cross_attn = TransformerDecoder(8, h, h * 2, 4, generator=g)
        for part in PARTS:
            setattr(self, f"motion2latent_{part}", MLP(h, h, h, generator=g))
        for part in PARTS:
            setattr(self, f"body_motion_decoder_{part}",
                    TransformerDecoder(1, h, h * 2, 4, generator=g))
        for part in PARTS:
            setattr(self, f"motion_out_proj_{part}", Linear(h, cb, generator=g))
        for part in PARTS:
            setattr(self, f"motion_cls_{part}", MLP(cb, h, cb, generator=g))
        self.audio_face_motion_proj = Linear(cfg.audio_f + cfg.motion_f, h, generator=g)
        self.face_motion_decoder = TransformerDecoder(4, h, h * 2, 4, generator=g)
        self.face_out_proj = Linear(h, cb, generator=g)
        self.face_cls = MLP(cb, h, cb, generator=g)

    def forward(self, audio, speaker_id, masked_motion, mask):
        return emage_forward(self, audio, speaker_id, masked_motion, mask)


@torch.no_grad()
@strict_fp32()
def emage_forward(model: EmageAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                  masked_motion: torch.Tensor, mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """One masked-transformer pass over a (bs, t, 337) window with its audio
    (bs, t * 533). Returns per-part latents ``rec_*`` and codebook logits ``cls_*``."""
    h = model.config.hidden_size
    pe = model.position_embeddings.pe

    # mask == 1 slots are replaced by the learned mask embedding
    masked_motion = torch.where(mask == 1, model.mask_embedding, masked_motion)
    body_hint = model.motion_encoder(masked_motion)
    body_hint_body = model.bodyhints_body(body_hint)
    body_hint_face = model.bodyhints_face(body_hint)
    audio2face_fea = model.audio_encoder_face(audio)
    audio2body_fea = model.audio_encoder_body(audio)

    t_hint = body_hint_face.shape[1]
    # Reference quirk: BOTH branches truncate audio2face_fea; the body stream keeps
    # its full length (it is only attention memory).
    if audio2face_fea.shape[1] > t_hint:
        audio2face_fea = audio2face_fea[:, :t_hint]
    if audio2body_fea.shape[1] > t_hint:
        audio2face_fea = audio2face_fea[:, :t_hint]
    bs, t, _ = audio2face_fea.shape
    spk_body = model.speaker_embedding_body(speaker_id).expand(bs, t, h)
    spk_face = model.speaker_embedding_face(speaker_id).expand(bs, t, h)

    # face: speaker PE query cross-attends over [audio | hint] memory
    face_memory = model.audio_face_motion_proj(
        torch.cat([audio2face_fea, body_hint_face[:, :t]], dim=2))
    decode_face = model.face_motion_decoder(
        periodic_positional_encoding(pe, spk_face), face_memory)
    face_latent = model.face_out_proj(decode_face)

    # body: self-attention, then the 8-layer cross-attention into the audio
    motion_proj = spk_body + periodic_positional_encoding(pe, model.moton_proj(body_hint_body))
    motion_fea = model.motion_self_encoder(motion_proj)
    audio2body_proj = model.audio_body_motion_proj(audio2body_fea)
    motion_fea = periodic_positional_encoding(pe, motion_fea + spk_body)
    motion_fea = motion_fea + model.audio_motion_cross_attn(motion_fea, audio2body_proj)

    # per-part branches; each refiner attends over the sum of the other two parts,
    # summed pairwise in the reference's order
    latent = [getattr(model, f"motion2latent_{p}")(motion_fea) for p in PARTS]
    mems = [latent[1] + latent[2], latent[0] + latent[2], latent[0] + latent[1]]
    rec = {}
    for p, lat, mem in zip(PARTS, latent, mems):
        refined = getattr(model, f"body_motion_decoder_{p}")(lat + spk_body, mem)
        rec[p] = getattr(model, f"motion_out_proj_{p}")(lat + refined)
    return {
        "rec_face": face_latent,
        "rec_upper": rec["upper"],
        "rec_hands": rec["hands"],
        "rec_lower": rec["lower"],
        "cls_face": model.face_cls(face_latent),
        "cls_upper": model.motion_cls_upper(rec["upper"]),
        "cls_hands": model.motion_cls_hands(rec["hands"]),
        "cls_lower": model.motion_cls_lower(rec["lower"]),
    }


def _select_decode_inputs(cfg: EmageAudioConfig, net_out) -> Dict[str, Optional[torch.Tensor]]:
    """Latent-vs-index head routing by the c*/l* flags."""
    argmax = lambda x: torch.argmax(log_softmax(x, dim=2), dim=2)
    return {
        "face_latent": net_out["rec_face"] if (cfg.lf > 0 and cfg.cf == 0) else None,
        "upper_latent": net_out["rec_upper"] if (cfg.lu > 0 and cfg.cu == 0) else None,
        "hands_latent": net_out["rec_hands"] if (cfg.lh > 0 and cfg.ch == 0) else None,
        "lower_latent": net_out["rec_lower"] if (cfg.ll > 0 and cfg.cl == 0) else None,
        "face_index": argmax(net_out["cls_face"]) if cfg.cf > 0 else None,
        "upper_index": argmax(net_out["cls_upper"]) if cfg.cu > 0 else None,
        "hands_index": argmax(net_out["cls_hands"]) if cfg.ch > 0 else None,
        "lower_index": argmax(net_out["cls_lower"]) if cfg.cl > 0 else None,
    }


def _window_step(model: EmageAudio, suite: EmageVQSuite, audio_slice, speaker_id,
                 window_motion, window_mask):
    """Forward, head routing and the VQ decode whose tail seeds the next window."""
    net_out = emage_forward(model, audio_slice, speaker_id, window_motion, window_mask)
    decode = vq_decode(suite, **_select_decode_inputs(model.config, net_out))
    return net_out, decode["all_motion4inference"][:, -model.config.seed_frames:, :]


def prepare_ar_inputs(cfg: EmageAudioConfig, audio: torch.Tensor,
                      masked_motion: Optional[torch.Tensor] = None,
                      mask: Optional[torch.Tensor] = None):
    """Seed motion and mask for the AR loop, and its window counts (rounds, remain).
    Unset motion is the identity pose (rot6d) with zero foot/trans channels; unset
    mask is all ones (every frame generated)."""
    length = audio.shape[1] * 30 // 16000
    bs = audio.shape[0]
    device = audio.device
    fake_motion = axis_angle_to_rotation_6d(
        torch.zeros(bs, length, 55, 3, device=device)).reshape(bs, length, -1)
    fake_motion = torch.cat([fake_motion, torch.zeros(bs, length, 7, device=device)], dim=-1)
    if masked_motion is not None:
        fake_motion[:, : masked_motion.shape[1]] = masked_motion
    fake_mask = torch.ones_like(fake_motion)
    if mask is not None:
        fake_mask[:, : mask.shape[1]] = mask

    window, pre = cfg.pose_length, cfg.seed_frames
    rounds = (length - pre) // (window - pre)
    remain = (length - pre) % (window - pre)
    if rounds <= 0 and remain <= pre:
        min_samples = (2 * pre + 1) * SAMPLES_PER_FRAME
        raise ValueError(
            f"audio too short for windowed inference: {length} frames; need more than "
            f"{2 * pre} frames (~{min_samples} samples at 16 kHz)"
        )
    return fake_motion, fake_mask, max(rounds, 0), remain


@torch.no_grad()
@strict_fp32()
def emage_inference(model: EmageAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                    suite: EmageVQSuite, masked_motion: Optional[torch.Tensor] = None,
                    mask: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Sliding-window autoregressive generation over (bs, samples) audio.

    64-frame windows overlap by ``seed_frames``; the previous window's decoded tail
    seeds the next window's unmasked slots; outputs are concatenated minus the overlap,
    plus a remainder window when ``remain > seed_frames``."""
    cfg = model.config
    masked_motion, mask, rounds, remain = prepare_ar_inputs(cfg, audio, masked_motion, mask)
    window, pre = cfg.pose_length, cfg.seed_frames
    stride = window - pre

    def one_window(last_motion, start, size):
        wmask = mask[:, start:start + size]
        seed = torch.where(wmask[:, :pre] == 0, masked_motion[:, start:start + pre], last_motion)
        wmotion = torch.cat([seed, masked_motion[:, start + pre:start + size]], dim=1)
        wmask = torch.cat([torch.zeros_like(wmask[:, :pre]), wmask[:, pre:]], dim=1)
        audio_slice = audio[:, start * SAMPLES_PER_FRAME:(start + size) * SAMPLES_PER_FRAME]
        return _window_step(model, suite, audio_slice, speaker_id, wmotion, wmask)

    pieces = []
    last_motion = masked_motion[:, :pre]
    for i in range(rounds):
        net_out, last_motion = one_window(last_motion, i * stride, window)
        pieces.append({k: v[:, :-pre] for k, v in net_out.items()})
    if remain > pre:
        # the remainder-only case (rounds == 0) seeds from the prepared motion
        net_out, _ = one_window(last_motion, rounds * stride, pre + remain)
        pieces.append(net_out)
    return {k: torch.cat([p[k] for p in pieces], dim=1) for k in pieces[0]}


__all__ = [
    "EmageAudio",
    "SAMPLES_PER_FRAME",
    "emage_forward",
    "emage_inference",
    "prepare_ar_inputs",
]
