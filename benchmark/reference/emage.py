"""Frozen plain reference of EMAGE (PantoMatrix ``emage_audio``) and its tokenizers:
the masked audio-gesture transformer, the sliding-window autoregressive generation with
a 4-frame decoded seed, the latent / index head routing, the VQ-VAE decode and the global
translation VAE with its velocity integration.

Parameter names are those of the published checkpoints (``H-Liu1997/emage_audio`` and
its ``emage_vq/{face,upper,hands,lower,global}`` tokenizers), including the
reference's ``moton_proj`` spelling and its audio-truncation quirk.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .layers import (
    MLP,
    DecoderLayer,
    Embedding,
    EncoderLayer,
    Linear,
    Quantized,
    Stack,
    VQDecoder,
    VQEncoder,
    WavEncoder,
    axis_angle_to_matrix,
    recover_from_mask,
    rot6d_to_axis_angle,
)

SAMPLES_PER_FRAME = 16000 // 30  # 533, the reference's mapping
JOINT_MASK_UPPER = ([False] * 3 + [True] + [False] * 2 + [True] + [False] * 2 + [True]
                    + [False] * 2 + [True] * 10 + [False] * 33)
JOINT_MASK_LOWER = ([True] * 3 + [False] + [True] * 2 + [False] + [True] * 2 + [False]
                    + [True] * 2 + [False] * 43)
JOINT_MASK_HANDS = [False] * 25 + [True] * 30
PARTS = ("upper", "hands", "lower")


class PositionEmbeddings(nn.Module):
    """The periodic sinusoidal table (period = pose_length), tiled once: buffer ``pe``."""

    def __init__(self, d: int, period: int):
        super().__init__()
        self.d, self.period = d, period
        self.register_buffer("pe", torch.empty(1, 2 * period, d))
        self.init = {"pe": ("fixed", self.table)}

    def table(self, device):
        pos = torch.arange(self.period, dtype=torch.float64, device=device)[:, None]
        div = torch.exp(torch.arange(0, self.d, 2, dtype=torch.float64, device=device)
                        * (-math.log(10000.0) / self.d))
        pe = torch.zeros(self.period, self.d, dtype=torch.float64, device=device)
        pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
        return pe.repeat(2, 1)[None].float()

    def forward(self, x):
        return x + self.pe[:, : x.shape[1]]


class Emage(nn.Module):
    def __init__(self, cfg: dict):
        super().__init__()
        self.cfg = cfg
        h, cb, mf, af = cfg["hidden_size"], cfg["vae_codebook_size"], cfg["motion_f"], cfg["audio_f"]
        self.audio_encoder_face = WavEncoder(af, "emage")
        self.audio_encoder_body = WavEncoder(af, "emage")
        self.speaker_embedding_body = Embedding(cfg["speaker_dims"], h)
        self.speaker_embedding_face = Embedding(cfg["speaker_dims"], h)
        self.mask_embedding = nn.Parameter(torch.empty(1, 1, cfg["pose_dims"] + 7),
                                           requires_grad=False)
        self.init = {"mask_embedding": ("normal", h ** -0.5)}
        self.motion_encoder = VQEncoder(cfg["pose_dims"] + 7, mf, 3)
        self.bodyhints_face = MLP(mf, h, mf)
        self.bodyhints_body = MLP(mf, h, mf)
        self.audio_body_motion_proj = Linear(af, h)
        self.moton_proj = Linear(mf, h)
        self.position_embeddings = PositionEmbeddings(h, cfg["pose_length"])
        self.motion_self_encoder = Stack(EncoderLayer, 1, h)
        self.audio_motion_cross_attn = Stack(DecoderLayer, 8, h)
        for p in PARTS:
            setattr(self, f"motion2latent_{p}", MLP(h, h, h))
        for p in PARTS:
            setattr(self, f"body_motion_decoder_{p}", Stack(DecoderLayer, 1, h))
        for p in PARTS:
            setattr(self, f"motion_out_proj_{p}", Linear(h, cb))
        for p in PARTS:
            setattr(self, f"motion_cls_{p}", MLP(cb, h, cb))
        self.audio_face_motion_proj = Linear(af + mf, h)
        self.face_motion_decoder = Stack(DecoderLayer, 4, h)
        self.face_out_proj = Linear(h, cb)
        self.face_cls = MLP(cb, h, cb)

    def forward(self, audio, speaker_id, masked_motion, mask):
        """One window: (B, t*533) audio, (B, t, 337) motion and mask -> the per-part
        latents ``rec_*`` and codebook logits ``cls_*``."""
        pos = self.position_embeddings
        masked_motion = torch.where(mask == 1, self.mask_embedding, masked_motion)
        hint = self.motion_encoder(masked_motion)
        hint_body, hint_face = self.bodyhints_body(hint), self.bodyhints_face(hint)
        a_face, a_body = self.audio_encoder_face(audio), self.audio_encoder_body(audio)
        t_hint = hint_face.shape[1]
        if a_face.shape[1] > t_hint:
            a_face = a_face[:, :t_hint]
        if a_body.shape[1] > t_hint:  # the reference truncates the face stream here too
            a_face = a_face[:, :t_hint]
        bs, t, _ = a_face.shape
        h = self.cfg["hidden_size"]
        spk_body = self.speaker_embedding_body(speaker_id).expand(bs, t, h)
        spk_face = self.speaker_embedding_face(speaker_id).expand(bs, t, h)
        face_mem = self.audio_face_motion_proj(torch.cat([a_face, hint_face[:, :t]], 2))
        face_latent = self.face_out_proj(self.face_motion_decoder(pos(spk_face), face_mem))
        mfea = self.motion_self_encoder(spk_body + pos(self.moton_proj(hint_body)))
        mfea = pos(mfea + spk_body)
        mfea = mfea + self.audio_motion_cross_attn(mfea, self.audio_body_motion_proj(a_body))
        lat = [getattr(self, f"motion2latent_{p}")(mfea) for p in PARTS]
        mems = [lat[1] + lat[2], lat[0] + lat[2], lat[0] + lat[1]]
        out = {"rec_face": face_latent, "cls_face": self.face_cls(face_latent)}
        for p, x, mem in zip(PARTS, lat, mems):
            rec = getattr(self, f"motion_out_proj_{p}")(
                x + getattr(self, f"body_motion_decoder_{p}")(x + spk_body, mem))
            out[f"rec_{p}"] = rec
            out[f"cls_{p}"] = getattr(self, f"motion_cls_{p}")(rec)
        return out


class Quantizer(Quantized, nn.Module):
    def __init__(self, n: int, d: int):
        super().__init__()
        self.embedding = nn.Module()
        self.embedding.weight = nn.Parameter(torch.empty(n, d), requires_grad=False)
        # codes of unit scale, as trained codebooks have (the published init, U(+-1/n),
        # would leave the decoders' outputs to their biases)
        self.embedding.init = {"weight": ("uniform", 1.0)}

    def nearest(self, z):
        """Index of the nearest code (squared Euclidean distance) of each row of z."""
        e = self.q(self.embedding.weight)
        zq = self.q(z)
        d = (zq ** 2).sum(-1, keepdim=True) + (e ** 2).sum(-1) - 2 * zq @ e.t()
        return d.argmin(-1)


class VQVAE(nn.Module):
    def __init__(self, dim: int, length: int = 256, layers: int = 2, codebook: int = 256):
        super().__init__()
        self.encoder = VQEncoder(dim, length, layers)
        self.quantizer = Quantizer(codebook, length)
        self.decoder = VQDecoder(dim, length, layers)

    def decode_index(self, idx):
        return self.decoder(self.quantizer.embedding.weight[idx])

    def decode_latent(self, latent):
        return self.decode_index(self.quantizer.nearest(latent))


class VAE(nn.Module):
    def __init__(self, dim: int = 61, length: int = 240, layers: int = 4):
        super().__init__()
        self.encoder = VQEncoder(dim, length, layers)
        self.decoder = VQDecoder(dim, length, layers)

    def forward(self, x):
        return self.decoder(self.encoder(x))


class Suite(nn.Module):
    """The five tokenizers: parts 106 / 78 / 180 / 61 wide, and the global VAE."""

    def __init__(self, length: int = 256, codebook: int = 256):
        super().__init__()
        self.face = VQVAE(106, length, 2, codebook)
        self.upper = VQVAE(78, length, 2, codebook)
        self.hands = VQVAE(180, length, 2, codebook)
        self.lower = VQVAE(61, length, 2, codebook)
        self.global_motion = VAE()


def choose(logits: torch.Tensor) -> torch.Tensor:
    """A head's code index as the published model picks it: the argmax of the
    log-softmax, in the logits' own precision."""
    return torch.log_softmax(logits, dim=-1).argmax(-1)


def route(cfg: dict, net: dict) -> dict:
    """Latent-vs-index head routing by the l* / c* weights: face from its latent, the
    body parts from their code indices (the published defaults)."""
    sel = {}
    for part, key in ROUTES:
        if cfg["c" + key] > 0:
            sel[f"{part}_index"] = choose(net[f"cls_{part}"])
        elif cfg["l" + key] > 0:
            sel[f"{part}_latent"] = net[f"rec_{part}"].float()
    return sel


def decode(suite: Suite, sel: dict, ref_trans: torch.Tensor, global_motion: bool = True):
    """Routed indices / latents -> ``motion_axis_angle`` (B, T, 165), ``expression``
    (B, T, 100), ``all_motion4inference`` (B, T, 337: rot6d + translation and foot
    channels, the next window's seed) and, with ``global_motion``, ``trans`` (B, T, 3)."""
    def part(name):
        if f"{name}_index" in sel:
            return getattr(suite, name).decode_index(sel[f"{name}_index"])
        return getattr(suite, name).decode_latent(sel[f"{name}_latent"])

    face, upper, hands, lower = (part(p) for p in ("face", "upper", "hands", "lower"))
    bs, t = face.shape[:2]
    aa = lambda x: rot6d_to_axis_angle(x.reshape(bs, t, -1, 6)).reshape(bs, t, -1)
    transfoot = lower[..., -7:]
    all_aa = (recover_from_mask(aa(upper), JOINT_MASK_UPPER)
              + recover_from_mask(aa(hands), JOINT_MASK_HANDS)
              + recover_from_mask(aa(lower[..., :-7]), JOINT_MASK_LOWER))
    all_aa[..., 66:69] = rot6d_to_axis_angle(face[..., :6])
    rot6d = axis_angle_to_matrix(all_aa.reshape(bs, t, 55, 3))[..., :2, :].reshape(bs, t, 330)
    out = {"motion_axis_angle": all_aa, "expression": face[..., 6:],
           "all_motion4inference": torch.cat([rot6d, transfoot], 2)}
    if global_motion:
        vel = suite.global_motion(lower)[..., 54:57]
        # positions from velocities at 30 fps: p[0] = ref, p[i] = p[i-1] + v[i-1] / 30
        steps = (1.0 / 30) * torch.cumsum(vel, dim=1)
        integ = lambda c: torch.cat([ref_trans[:, :1, c:c + 1],
                                     ref_trans[:, :1, c:c + 1] + steps[:, :-1, c:c + 1]], 1)
        out["trans"] = torch.cat([integ(0), vel[..., 1:2], integ(2)], -1)
    return out


def windows(cfg: dict, frames: int):
    """The AR plan: (start, size, kept frames) of each window over ``frames`` frames."""
    window, pre = cfg["pose_length"], cfg["seed_frames"]
    stride = window - pre
    rounds, remain = (frames - pre) // stride, (frames - pre) % stride
    plan = [(i * stride, window, stride) for i in range(rounds)]
    if remain > pre:
        plan.append((rounds * stride, pre + remain, pre + remain))
    return plan


def _identity_motion(audio, bs: int, frames: int):
    ident = audio.new_zeros(1, 1, 337)
    ident[..., 0:330:6] = 1.0
    ident[..., 4:330:6] = 1.0
    return ident.expand(bs, frames, 337)


def _window(model: Emage, audio, speaker_id, last, start: int, size: int) -> dict:
    """The network outputs of the window [start, start + size) seeded by ``last``."""
    pre = model.cfg["seed_frames"]
    motion = torch.cat([last, _identity_motion(audio, audio.shape[0], size - pre)], 1)
    mask = torch.ones_like(motion)
    mask[:, :pre] = 0
    a = audio[:, start * SAMPLES_PER_FRAME:(start + size) * SAMPLES_PER_FRAME]
    return model(a, speaker_id, motion, mask)


def _seed(model: Emage, suite: Suite, sel: dict) -> torch.Tensor:
    """The next window's seed: the last ``seed_frames`` decoded frames of a window's
    routed heads."""
    out = decode(suite, sel, None, global_motion=False)
    return out["all_motion4inference"][:, -model.cfg["seed_frames"]:]


def _codes(suite: Suite, sel: dict) -> dict:
    """Routed heads as code indices: a latent-routed part's latent mapped to its nearest
    code, as its decode does."""
    out = {}
    for part in ("face", "upper", "hands", "lower"):
        idx = sel.get(f"{part}_index")
        out[part] = (idx if idx is not None
                     else getattr(suite, part).quantizer.nearest(sel[f"{part}_latent"]))
    return out


ROUTES = (("face", "f"), ("upper", "u"), ("hands", "h"), ("lower", "l"))


def _scores(cfg: dict, suite: Suite, net: dict, part: str) -> torch.Tensor:
    """(B, T, K) scores whose largest is the part's choice: the logits of an index head,
    minus the squared distance to each code for a latent head."""
    if cfg["c" + dict(ROUTES)[part]] > 0:
        return net[f"cls_{part}"].float()
    z = net[f"rec_{part}"].float()
    e = getattr(suite, part).quantizer.embedding.weight
    return -((z ** 2).sum(-1, keepdim=True) + (e ** 2).sum(-1) - 2 * z @ e.t())


def row_errors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each row's ||a - b|| / ||b||, in float64."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp_min(1e-300)


def _blocks(model: Emage, audio, speaker_id, seed, start: int, size: int, block: int):
    """``_window`` over the rows in blocks of ``block``, so that many rows fit."""
    parts = [_window(model, audio[i:i + block], speaker_id[i:i + block], seed[i:i + block],
                     start, size) for i in range(0, audio.shape[0], block)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _flips(cfg: dict, suite: Suite, net: dict, codes: dict, keep: int, size: int,
           margin: float):
    """Near-tie choices of a window that rounding may have made the other way: (gap, row,
    part, frame, the other code) wherever the top two scores lie closer than ``margin`` of
    the scores' spread, over the frames whose choices reach the next window's seed: every
    head's in the overlap, and the face's nearest codes over its decoder's reach into the
    kept frames (two ResBlocks, two up convs and the output conv: 5 + 2 frames)."""
    flips = []
    for part in codes:
        lo = max(0, keep - 7) if part == "face" else keep
        sc = _scores(cfg, suite, net, part)[:, lo:size]
        top = sc.topk(2, dim=-1)
        gap = (top.values[..., 0] - top.values[..., 1]) / sc.std(-1).clamp_min(1e-12)
        alt = torch.where(top.indices[..., 0] == codes[part][:, lo:size],
                          top.indices[..., 1], top.indices[..., 0])
        for r, f in (gap < margin).nonzero().tolist():
            flips.append((float(gap[r, f]), r, part, lo + f, int(alt[r, f])))
    return sorted(flips)


def follow(model: Emage, suite: Suite, audio, speaker_id, chosen: dict, part: float = 0.05,
           margin: float = 0.1, most: int = 8, block: int = 128):
    """Every window as the reference computes it from the heads that another run chose
    (``chosen``: that run's network outputs over the kept frames of every window).

    Window 0 is seeded as every run seeds it. Window k > 0 is seeded by the decode of
    window k - 1's heads: ``chosen``'s choices on the frames that run kept, and the
    reference's own on the overlap, which ``chosen`` does not hold, taken from its window
    k - 1 as it followed the run. Where such a choice is a near tie (``_flips``),
    rounding may have made it the other way in the run judged, so each row is also seeded
    with each near tie flipped alone, up to ``most`` a row, the nearest first. A row's
    error in window k is that of the candidate nearest the run (the worst of the
    outputs' relative errors over the kept frames), and that candidate's window carries
    the row on to window k + 1.

    A row whose error in a window is over ``part`` has parted from the run: its overlap
    choices, and so every later seed of the row, come from a window unlike the run's, so
    the row is followed no further.

    Returns the reference's window 0 and, for each later window (the remainder too) in
    which some row is still followed, its (start, kept frames, the rows followed into it,
    each one's error)."""
    cfg = model.cfg
    plan = windows(cfg, audio.shape[1] * 30 // 16000)
    alive = torch.arange(audio.shape[0], device=audio.device)
    s0, size0, _ = plan[0]
    prev = _blocks(model, audio, speaker_id,
                   _identity_motion(audio, len(alive), cfg["seed_frames"]), s0, size0, block)
    first, later = prev, []
    for (sp, _, keepp), (s, size, keep) in zip(plan, plan[1:]):
        if not len(alive):
            break
        theirs = _codes(suite, route(cfg, {k: v[alive, sp:sp + keepp]
                                           for k, v in chosen.items()}))
        ours = _codes(suite, route(cfg, {k: v[:, keepp:] for k, v in prev.items()}))
        codes = {p: torch.cat([theirs[p], ours[p]], 1) for p in ours}
        n = len(alive)
        rows = list(range(n))  # positions in ``alive``
        variants = {p: list(codes[p]) for p in codes}
        taken = [0] * n
        for _, r, part_name, f, code in _flips(cfg, suite, prev, codes, keepp,
                                               codes["face"].shape[1], margin):
            if taken[r] == most:
                continue
            taken[r] += 1
            rows.append(r)
            for p in codes:
                v = codes[p][r].clone()
                if p == part_name:
                    v[f] = code
                variants[p].append(v)
        idx = alive[torch.tensor(rows, device=audio.device)]
        sel = {f"{p}_index": torch.stack(v) for p, v in variants.items()}
        seed = decode(suite, sel, None, global_motion=False)["all_motion4inference"][
            :, -cfg["seed_frames"]:]
        net = _blocks(model, audio[idx], speaker_id[idx], seed, s, size, block)
        err = torch.stack([row_errors(net[k][:, :keep], chosen[k][idx, s:s + keep])
                           for k in net]).amax(0)
        err_of = err.tolist()
        nearest = [None] * n  # each row's nearest candidate, the first where two tie
        for c, (r, e) in enumerate(zip(rows, err_of)):
            if nearest[r] is None or e < err_of[nearest[r]]:
                nearest[r] = c
        near = torch.tensor(nearest, device=audio.device)
        best = err[near]
        later.append((s, keep, alive, best))
        on = best <= part
        alive = alive[on]
        prev = {k: v[near][on] for k, v in net.items()}
    return first, later


def generate(model: Emage, suite: Suite, audio, speaker_id) -> dict:
    """The sliding-window generation over (B, samples) audio: each window is seeded by
    the last ``seed_frames`` decoded frames of the window before; the network outputs of
    every window's kept frames, concatenated (B, T, ...)."""
    cfg = model.cfg
    last = _identity_motion(audio, audio.shape[0], cfg["seed_frames"])
    pieces = []
    for start, size, keep in windows(cfg, audio.shape[1] * 30 // 16000):
        net = _window(model, audio, speaker_id, last, start, size)
        last = _seed(model, suite, route(cfg, net))
        pieces.append({k: v[:, :keep] for k, v in net.items()})
    return {k: torch.cat([p[k] for p in pieces], 1) for k in pieces[0]}
