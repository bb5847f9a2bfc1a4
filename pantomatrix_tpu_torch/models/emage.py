"""EMAGE masked audio-gesture transformer (counterpart of
``pantomatrix_tpu/models/emage.py``), with the reference's quirks:

- the duplicated audio-truncation branch assigns ``audio2face_fea`` twice; the body
  stream is deliberately not truncated;
- ``t`` is taken from the audio feature length;
- frame -> sample mapping ``16000 // 30 == 533``.

The JAX package runs the sliding-window generation as one ``lax.scan`` program; here it
is a Python loop over 64-frame windows with a 4-frame decoded seed, plus a remainder
window. The three per-part branches, which JAX ``vmap``s over stacked params, are
named submodules called in turn.

Two opt-in serving modes follow the JAX package's: ``compute_dtype="bfloat16"`` runs
the audio model in bfloat16 (weights cast once, reductions and the VQ suite in float32,
see ``utils/precision.py``), and ``batched_wav`` encodes the audio of every full window
in one WavEncoder call before the loop.

The model is built in eval mode. In train mode (``model.train()``) ``model(...)`` is
``emage_apply``: one masked pass with gradients, batch-statistics BatchNorm and dropout,
which the training objective (``train/steps.py``) runs three times a step. Inference
(``emage_inference``, whose CUDA graphs are captured in eval mode only) raises on a
model in train mode.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..core.rotations import axis_angle_to_rotation_6d
from ..nn.attention import TransformerDecoder, TransformerEncoder
from ..nn.blocks import MLP, VQEncoder, WavEncoder, make_periodic_pe, periodic_positional_encoding
from ..nn.layers import Embedding, Linear, log_softmax, normal, strict_fp32
from ..utils import trace
from ..utils.precision import cast_once, compute_dtype_of
from .configs import EmageAudioConfig
from .emage_graph import WindowStepGraphs, graphs_of, step_key
from .emage_vq import EmageVQSuite, vq_decode

SAMPLES_PER_FRAME = 16000 // 30  # == 533, the reference's exact mapping

# most rounds * batch window-rows that batched_wav encodes in one call; above it the
# per-window encoder runs (the stage-1 conv activations are ~5.3 MB per window-row)
BATCHED_WAV_MAX = 512

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
        h, p = cfg.hidden_size, cfg.dropout_prob
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
        self.motion_self_encoder = TransformerEncoder(1, h, h * 2, 4, generator=g, dropout=p)
        self.audio_motion_cross_attn = TransformerDecoder(8, h, h * 2, 4, generator=g, dropout=p)
        for part in PARTS:
            setattr(self, f"motion2latent_{part}", MLP(h, h, h, generator=g))
        for part in PARTS:
            setattr(self, f"body_motion_decoder_{part}",
                    TransformerDecoder(1, h, h * 2, 4, generator=g, dropout=p))
        for part in PARTS:
            setattr(self, f"motion_out_proj_{part}", Linear(h, cb, generator=g))
        for part in PARTS:
            setattr(self, f"motion_cls_{part}", MLP(cb, h, cb, generator=g))
        self.audio_face_motion_proj = Linear(cfg.audio_f + cfg.motion_f, h, generator=g)
        self.face_motion_decoder = TransformerDecoder(4, h, h * 2, 4, generator=g, dropout=p)
        self.face_out_proj = Linear(h, cb, generator=g)
        self.face_cls = MLP(cb, h, cb, generator=g)
        self.eval()

    def forward(self, audio, speaker_id, masked_motion, mask, use_audio: bool = True,
                audio_features=None):
        fn = emage_apply if self.training else emage_forward
        return fn(self, audio, speaker_id, masked_motion, mask, audio_features=audio_features,
                  use_audio=use_audio)


@torch.no_grad()
@strict_fp32()
def emage_forward(model: EmageAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                  masked_motion: torch.Tensor, mask: torch.Tensor,
                  audio_features: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                  use_audio: bool = True) -> Dict[str, torch.Tensor]:
    """``emage_apply`` without gradients: the inference pass."""
    return emage_apply(model, audio, speaker_id, masked_motion, mask, audio_features,
                       use_audio)


def emage_apply(model: EmageAudio, audio: torch.Tensor, speaker_id: torch.Tensor,
                masked_motion: torch.Tensor, mask: torch.Tensor,
                audio_features: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                use_audio: bool = True) -> Dict[str, torch.Tensor]:
    """One masked-transformer pass over a (bs, t, 337) window with its audio
    (bs, t * 533). Returns per-part latents ``rec_*`` and codebook logits ``cls_*``,
    in the dtype of the model's weights.

    ``audio_features``: the window's precomputed (face, body) WavEncoder outputs, in
    place of running the encoders on ``audio``. ``use_audio=False`` is the reference's
    no-audio pass: it multiplies the 8-layer cross-attention stack's output by zero, so
    the stack is skipped here, as in the JAX package. In train mode the periodic
    positional encodings and the transformer layers apply dropout."""
    h = model.config.hidden_size
    pe = model.position_embeddings.pe
    pos = lambda x: periodic_positional_encoding(pe, x, model.config.dropout_prob,
                                                 model.training)

    # mask == 1 slots are replaced by the learned mask embedding
    masked_motion = torch.where(mask == 1, model.mask_embedding, masked_motion)
    body_hint = model.motion_encoder(masked_motion)
    body_hint_body = model.bodyhints_body(body_hint)
    body_hint_face = model.bodyhints_face(body_hint)
    if audio_features is None:
        audio2face_fea = model.audio_encoder_face(audio)
        audio2body_fea = model.audio_encoder_body(audio)
    else:
        audio2face_fea, audio2body_fea = audio_features

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
    decode_face = model.face_motion_decoder(pos(spk_face), face_memory)
    face_latent = model.face_out_proj(decode_face)

    # body: self-attention, then the 8-layer cross-attention into the audio
    motion_proj = spk_body + pos(model.moton_proj(body_hint_body))
    motion_fea = model.motion_self_encoder(motion_proj)
    motion_fea = pos(motion_fea + spk_body)
    if use_audio:
        audio2body_proj = model.audio_body_motion_proj(audio2body_fea)
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


def _decoder_halo(suite: EmageVQSuite) -> int:
    """One-sided temporal receptive field of the VQ part decoders: 2 ResBlocks (two k=3
    convs each, +-2 frames), ``vae_layer`` up convs (+-1 each) and the final conv (+-1),
    so 5 + vae_layer. Everything else in ``vq_decode`` is frame-local, so frame f of a
    chunk [start, end) decoded alone equals the whole sequence's decode when
    f - start >= halo and end - 1 - f >= halo (``serve.StreamingEmageGenerator``)."""
    return 5 + max(getattr(suite, p).config.vae_layer
                   for p in ("face", "upper", "hands", "lower"))


def seed_decode_frames(seed_frames: int, suite: EmageVQSuite, size: int) -> int:
    """Frames of a ``size``-frame window's heads that its seed decode runs over: the last
    ``seed_frames + _decoder_halo(suite)`` (11 for the published tokenizers), or the whole
    window where it is shorter. The seed frames are then at least the halo away from the
    tail's first frame, so their decode equals the whole window's up to float32 rounding of
    convolutions over other lengths (on the card, bit for bit at 1, 8 and 128 rows)."""
    return min(size, seed_frames + _decoder_halo(suite))


def _window_step(model: EmageAudio, suite: EmageVQSuite, audio_slice, speaker_id,
                 window_motion, window_mask, audio_features=None):
    """Forward, head routing and the VQ decode whose tail seeds the next window: the heads'
    last ``seed_decode_frames`` frames. The suite decodes in float32; the seed comes back
    in the window's dtype."""
    cfg = model.config
    net_out = emage_forward(model, audio_slice, speaker_id, window_motion, window_mask,
                            audio_features)
    n = seed_decode_frames(cfg.seed_frames, suite, window_motion.shape[1])
    heads = {k: v[:, -n:] for k, v in net_out.items()}
    decode = vq_decode(suite, **_select_decode_inputs(cfg, heads))
    last_motion = decode["all_motion4inference"][:, -cfg.seed_frames:, :]
    return net_out, last_motion.to(window_motion.dtype)


def use_batched_wav(rounds: int, bs: int) -> bool:
    """Whether ``batched_wav`` encodes the full windows in one call: at most
    ``BATCHED_WAV_MAX`` window-rows."""
    return 0 < rounds * bs <= BATCHED_WAV_MAX


@torch.no_grad()
def batched_audio_features(model: EmageAudio, audio: torch.Tensor, rounds: int):
    """Both WavEncoders over the audio of the ``rounds`` full windows at once, flattened
    to (rounds * bs, window samples): per window, its (face, body) features."""
    cfg = model.config
    window, stride = cfg.pose_length, cfg.pose_length - cfg.seed_frames
    bs = audio.shape[0]
    wins = audio.unfold(1, window * SAMPLES_PER_FRAME, stride * SAMPLES_PER_FRAME)
    flat = wins[:, :rounds].transpose(0, 1).reshape(rounds * bs, -1)
    face = model.audio_encoder_face(flat)
    body = model.audio_encoder_body(flat)
    return list(zip(face.reshape(rounds, bs, *face.shape[1:]).unbind(0),
                    body.reshape(rounds, bs, *body.shape[1:]).unbind(0)))


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
                    mask: Optional[torch.Tensor] = None, compute_dtype=None,
                    batched_wav: bool = False) -> Dict[str, torch.Tensor]:
    """Sliding-window autoregressive generation over (bs, samples) audio.

    64-frame windows overlap by ``seed_frames``; the previous window's decoded tail seeds
    the next window's unmasked slots (only the heads' last ``seed_decode_frames`` frames
    are decoded for it); outputs are concatenated minus the overlap, plus a remainder
    window when ``remain > seed_frames``.

    On CUDA tensors every full window replays a CUDA graph of ``_window_step``
    (``models/emage_graph.py``), captured on the model's first call at each batch and
    mode; the remainder window, whose length differs per clip, runs eagerly. On CPU
    tensors every window runs eagerly.

    ``compute_dtype="bfloat16"``: the model's weights (``utils/precision.cast_once``),
    the audio, the motion and the mask are cast once, before the loop, and the network
    outputs come back in bfloat16; the suite decodes in float32. ``batched_wav``: both
    WavEncoders run once over every full window's audio before the loop, when
    ``use_batched_wav(rounds, bs)``; the remainder window encodes its own. Each mode is
    the JAX package's, and neither is the float32 parity path (``None``, ``False``)."""
    if model.training:
        raise RuntimeError("emage_inference runs an eval-mode model: call model.eval() first")
    step = graph_window_step(graphs_of(model)) if audio.is_cuda else _window_step
    with trace.span("emage.inference", audio, batch=audio.shape[0]):
        return _inference_loop(model, audio, speaker_id, suite, masked_motion, mask,
                               compute_dtype, batched_wav, step)


def graph_window_step(cache: WindowStepGraphs):
    """``_window_step`` with its signature, by a replay of its graph in ``cache``. The
    outputs are the graph's static tensors: consume them before its next replay."""

    def step(model, suite, audio_slice, speaker_id, window_motion, window_mask,
             audio_features=None):
        has_features = audio_features is not None
        face, body = audio_features if has_features else (None, None)

        def fn(a, s, m, k, f, b):
            return _window_step(model, suite, a, s, m, k, (f, b) if has_features else None)

        return cache.run(step_key(model, suite, window_motion, has_features),
                         fn, (audio_slice, speaker_id, window_motion, window_mask, face, body),
                         (model, suite))

    return step


def _inference_loop(model, audio, speaker_id, suite, masked_motion, mask, compute_dtype,
                    batched_wav, full_window_step):
    """``emage_inference`` with ``full_window_step`` (``_window_step``'s signature) for
    the full windows. Each window's kept frames are copied into outputs allocated at the
    full length before the next window runs, so the step may reuse its outputs. Spans
    (``utils/trace.py``): ``emage.window`` around each full window but not the copy of
    its kept frames, its ``graph`` replayed, captured or eager; ``emage.remainder``."""
    cfg = model.config
    masked_motion, mask, rounds, remain = prepare_ar_inputs(cfg, audio, masked_motion, mask)
    trace.annotate("emage.inference", rounds=rounds, remain=remain)
    dtype = compute_dtype_of(compute_dtype)
    if dtype is not None:
        model = cast_once(model, dtype)
        audio, masked_motion, mask = audio.to(dtype), masked_motion.to(dtype), mask.to(dtype)
    window, pre = cfg.pose_length, cfg.seed_frames
    stride = window - pre
    bs = audio.shape[0]
    feats = (batched_audio_features(model, audio, rounds)
             if batched_wav and use_batched_wav(rounds, bs) else None)

    def one_window(step, last_motion, start, size, audio_features=None):
        wmask = mask[:, start:start + size]
        seed = torch.where(wmask[:, :pre] == 0, masked_motion[:, start:start + pre], last_motion)
        wmotion = torch.cat([seed, masked_motion[:, start + pre:start + size]], dim=1)
        wmask = torch.cat([torch.zeros_like(wmask[:, :pre]), wmask[:, pre:]], dim=1)
        audio_slice = audio[:, start * SAMPLES_PER_FRAME:(start + size) * SAMPLES_PER_FRAME]
        return step(model, suite, audio_slice, speaker_id, wmotion, wmask, audio_features)

    total = rounds * stride + (pre + remain if remain > pre else 0)
    out = None
    last_motion = masked_motion[:, :pre]
    for i in range(rounds):
        with trace.span("emage.window", audio, index=i, graph="eager"):
            net_out, last_motion = one_window(full_window_step, last_motion, i * stride,
                                              window, None if feats is None else feats[i])
        if out is None:
            out = {k: v.new_empty((bs, total) + v.shape[2:]) for k, v in net_out.items()}
        for k, v in net_out.items():
            out[k][:, i * stride:(i + 1) * stride] = v[:, :stride]
    if remain > pre:
        # the remainder-only case (rounds == 0) seeds from the prepared motion
        with trace.span("emage.remainder", audio, frames=pre + remain):
            net_out, _ = one_window(_window_step, last_motion, rounds * stride, pre + remain)
        if out is None:
            return net_out
        for k, v in net_out.items():
            out[k][:, rounds * stride:] = v
    return out


__all__ = [
    "BATCHED_WAV_MAX",
    "EmageAudio",
    "SAMPLES_PER_FRAME",
    "batched_audio_features",
    "emage_apply",
    "emage_forward",
    "emage_inference",
    "graph_window_step",
    "prepare_ar_inputs",
    "seed_decode_frames",
    "use_batched_wav",
]
