"""Serving engines of the port (counterpart of ``pantomatrix_tpu/serve.py``): batch
generation with static-shape bucketing, and incremental streaming, one stream or many
batched on one card.

- :class:`EmageGenerator` pads requests onto a fixed grid: the batch to ``batch_size``
  (pad rows replicate the bucket's first clip; their outputs are dropped), the audio
  with silence to the next multiple of ``bucket_seconds``; outputs are trimmed to each
  clip's frame count. Only the window that holds the pad boundary can differ from an
  unpadded run. On the card every full window replays one CUDA graph per batch and mode
  (``models/emage_graph.py``), so the grid keeps the number of graphs small, as it keeps
  the number of compiled programs small in the JAX package.
- :class:`SequenceGenerator`: the same grid for CaMN and DisCo, whose forward is one
  call (eager: K2 is one launch per LSTM layer).
- :class:`StreamingEmageGenerator` and :class:`StreamingPool`: push audio as it
  arrives and receive motion as each 64-frame window completes. The full-window step and
  the steady chunk decode replay CUDA graphs on the card; the remainder window and its
  decode (``flush``) run eagerly.

Every array in and out is host numpy; the engines move it to the model's device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .models.emage import (
    SAMPLES_PER_FRAME,
    _select_decode_inputs,
    _window_step,
    graph_window_step,
)
from .models.emage_graph import decode_key, graphs_of
from .models.emage_vq import vq_decode
from .utils.precision import cast_once, compute_dtype_of

SR = 16000
FPS = 30


@dataclass
class GenerationResult:
    motion_axis_angle: np.ndarray   # (t, 165)
    expressions: np.ndarray         # (t, 100)
    trans: np.ndarray               # (t, 3)


def _device_of(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _host(x: torch.Tensor) -> np.ndarray:
    """A float32 host copy that shares no memory with ``x`` (on the CPU ``.cpu()`` and
    ``.numpy()`` would share it, and the step's outputs may be reused by its next call)."""
    return np.array(x.float().cpu().numpy())


def _grid(waves, batch_size: int, bucket_samples: int, speaker_ids):
    """Yield (clip indices, padded (batch_size, samples) audio, (batch_size, 1) speaker
    ids) per bucket of the length-sorted clips; pad rows replicate row 0."""
    order = sorted(range(len(waves)), key=lambda i: len(waves[i]))
    for start in range(0, len(order), batch_size):
        idxs = order[start:start + batch_size]
        n = max(len(waves[i]) for i in idxs)
        max_len = max(1, math.ceil(n / bucket_samples)) * bucket_samples
        batch = np.zeros((batch_size, max_len), np.float32)
        for row, i in enumerate(idxs):
            batch[row, :len(waves[i])] = waves[i]
        batch[len(idxs):] = batch[0]
        spk = np.zeros((batch_size, 1), np.int64)
        if speaker_ids is not None:
            for row, i in enumerate(idxs):
                spk[row, 0] = speaker_ids[i]
        yield idxs, batch, spk


class EmageGenerator:
    """Audio -> full-body motion over a fixed grid of batch and length buckets."""

    def __init__(self, model, vq_model, batch_size: int = 8, bucket_seconds: float = 8.0,
                 compute_dtype: Optional[str] = None, batched_wav: bool = False):
        """model: ``models.api.EmageAudioModel``; vq_model: ``models.api.EmageVQModel``,
        on one device. ``compute_dtype`` and ``batched_wav`` select the serving modes of
        ``EmageAudioModel.inference``; the defaults are the float32 parity path."""
        self.model = model
        self.vq = vq_model
        self.batch_size = batch_size
        self.bucket_samples = int(bucket_seconds * SR)
        self.compute_dtype = compute_dtype
        self.batched_wav = batched_wav

    def generate(self, waves: Sequence[np.ndarray],
                 speaker_ids: Optional[Sequence[int]] = None,
                 ref_trans: Optional[Sequence[np.ndarray]] = None) -> List[GenerationResult]:
        """waves: float32 16 kHz mono arrays of any lengths. ``ref_trans``: each clip's
        (3,) starting translation (default zeros), threaded into the global-motion
        integration as the reference CLI's ``ref_trans=trans[:, 0]``."""
        device = _device_of(self.model)
        results: List[Optional[GenerationResult]] = [None] * len(waves)
        for idxs, batch, spk in _grid(waves, self.batch_size, self.bucket_samples,
                                      speaker_ids):
            rt = np.zeros((self.batch_size, 1, 3), np.float32)
            if ref_trans is not None:
                for row, i in enumerate(idxs):
                    rt[row, 0] = np.asarray(ref_trans[i], np.float32)
            latent = self.model.inference(
                torch.from_numpy(batch).to(device), torch.from_numpy(spk).to(device), self.vq,
                compute_dtype=self.compute_dtype, batched_wav=self.batched_wav)
            decoded = self.vq.decode(**_select_decode_inputs(self.model.config, latent),
                                     get_global_motion=True,
                                     ref_trans=torch.from_numpy(rt).to(device))
            motion = _host(decoded["motion_axis_angle"])
            expr, trans = _host(decoded["expression"]), _host(decoded["trans"])
            for row, i in enumerate(idxs):
                t = min(len(waves[i]) * FPS // SR, motion.shape[1])
                results[i] = GenerationResult(motion_axis_angle=motion[row, :t],
                                              expressions=expr[row, :t], trans=trans[row, :t])
        return results  # type: ignore[return-value]


class SequenceGenerator:
    """The same grid for the LSTM families (CaMN, DisCo): one forward per bucket; returns
    per-clip (t, 165) axis angles at the model's ``pose_fps``."""

    def __init__(self, model, batch_size: int = 8, bucket_seconds: float = 8.0,
                 compute_dtype: Optional[str] = None):
        """compute_dtype="bfloat16": the low-precision serving mode of the forward."""
        self.model = model
        self.batch_size = batch_size
        self.bucket_samples = int(bucket_seconds * SR)
        self.compute_dtype = compute_dtype

    def generate(self, waves: Sequence[np.ndarray],
                 speaker_ids: Optional[Sequence[int]] = None) -> List[np.ndarray]:
        device = _device_of(self.model)
        fps = self.model.config.pose_fps
        results: List[Optional[np.ndarray]] = [None] * len(waves)
        for idxs, batch, spk in _grid(waves, self.batch_size, self.bucket_samples,
                                      speaker_ids):
            out = self.model(torch.from_numpy(batch).to(device), torch.from_numpy(spk).to(device),
                             seed_frames=self.model.config.seed_frames,
                             compute_dtype=self.compute_dtype)
            motion = _host(out["motion_axis_angle"])
            for row, i in enumerate(idxs):
                results[i] = motion[row, :min(len(waves[i]) * fps // SR, motion.shape[1])]
        return results  # type: ignore[return-value]


def _window_callables(model, suite, compute_dtype=None):
    """(window step, chunk decode) of the streaming engines; a pool shares one pair
    across its sessions.

    ``step(audio, spk, motion, mask)`` takes host rows, (N, samples), (N, 1), (N, size,
    337) twice, and returns (net_out, last): the network outputs and the decoded seed
    tail, as tensors on the model's device. On the card a full window replays the step's
    graph, and these are its static outputs: consume them before the next step.
    ``decode(net_out, ref_trans, keep)`` crops net_out to its first ``keep`` frames,
    routes the heads and decodes with global translation from ``ref_trans`` (N, 1, 3);
    it returns host (motion, expression, trans). On the card the steady chunk
    (``keep == stride``) replays its graph; other chunks (the flush) run eagerly."""
    cfg = model.config
    window, stride = cfg.pose_length, cfg.pose_length - cfg.seed_frames
    dtype = compute_dtype_of(compute_dtype)
    device = _device_of(model)
    cache = graphs_of(model)
    graph_step = graph_window_step(cache)
    net_keys = ("rec_face", "rec_upper", "rec_hands", "rec_lower",
                "cls_face", "cls_upper", "cls_hands", "cls_lower")

    def step(audio, spk, motion, mask):
        m = cast_once(model, dtype)
        cast = (lambda x: x) if dtype is None else (lambda x: x.to(dtype))
        audio, motion, mask = (cast(torch.from_numpy(x).to(device)) for x in (audio, motion, mask))
        spk = torch.from_numpy(spk).to(device)
        full = device.type == "cuda" and motion.shape[1] == window
        return (graph_step if full else _window_step)(m, suite, audio, spk, motion, mask)

    def crop_decode(keep, rt, *net):
        net = {k: v[:, :keep] for k, v in zip(net_keys, net)}
        return vq_decode(suite, **_select_decode_inputs(cfg, net), get_global_motion=True,
                         ref_trans=rt)

    def decode(net_out: Dict[str, torch.Tensor], ref_trans: np.ndarray, keep: int):
        rt = torch.from_numpy(np.ascontiguousarray(ref_trans, np.float32)).to(device)
        net = tuple(net_out[k] for k in net_keys)
        if device.type == "cuda" and keep == stride:
            dec = cache.run(decode_key(suite, net_out, keep),
                            lambda r, *xs: crop_decode(keep, r, *xs), (rt,) + net, (suite,))
        else:
            dec = crop_decode(keep, rt, *net)
        return _host(dec["motion_axis_angle"]), _host(dec["expression"]), _host(dec["trans"])

    return step, decode


class StreamingEmageGenerator:
    """Incremental EMAGE generation: push 16 kHz audio as it arrives, receive motion as
    soon as each 64-frame window completes.

    The window step is the offline one (``models/emage.py::_window_step``, the same seed
    threading, slices and masks), so the latent sequence equals the offline
    ``emage_inference``'s. Each emitted chunk is decoded on its own, which differs from
    the offline decode of the whole sequence in two documented ways:

    - the VQ decoders are temporal convolutions: frame f of a chunk [start, end) equals
      the offline decode when f - start >= halo and end - 1 - f >= halo, with halo =
      ``models/emage.py::_decoder_halo`` (5 + vae_layer);
    - the global translation integrates per chunk, from the previous chunk's last
      position.

    Usage::

        gen = StreamingEmageGenerator(model, vq_model)
        for chunk in audio_stream:          # any chunk sizes
            res = gen.push(chunk)           # res.motion_axis_angle: (t_new, 165)
        res = gen.flush()                   # the final remainder window
    """

    def __init__(self, model, vq_model, speaker_id: int = 0, collect_latents: bool = False,
                 compute_dtype: Optional[str] = None):
        cfg = model.config
        self.model = model
        self.vq = vq_model
        self.window, self.pre = cfg.pose_length, cfg.seed_frames
        self.stride = self.window - self.pre
        self.spf = SAMPLES_PER_FRAME
        self.collect_latents = collect_latents
        self.latents: List[dict] = []
        # identity-rot6d motion frame ([1,0,0,0,1,0] per joint, zero trans/contact)
        frame = np.zeros(cfg.pose_dims + 7, np.float32)
        frame[0:330:6] = 1.0
        frame[4:330:6] = 1.0
        self._fake_frame = frame
        self._seed = np.tile(frame, (1, self.pre, 1)).astype(np.float32)
        self._trans = np.zeros((1, 1, 3), np.float32)
        self._audio = np.zeros(0, np.float32)
        self._consumed = 0    # samples trimmed off the front of the buffer
        self._frame_pos = 0   # start frame of the next window
        self._spk = np.asarray([[speaker_id]], np.int64)
        self._expr_dim = vq_model.face.config.vae_test_dim - 6
        self._step, self._decode = _window_callables(model, vq_model, compute_dtype)

    def _window_inputs(self, size: int):
        """This session's (1, ...) host rows of audio, motion and mask for a window of
        ``size`` frames at the current frame position."""
        motion = np.tile(self._fake_frame, (1, size, 1)).astype(np.float32)
        motion[:, :self.pre] = self._seed
        mask = np.ones_like(motion)
        mask[:, :self.pre] = 0.0
        start = self._frame_pos * self.spf - self._consumed
        audio = self._audio[start:start + size * self.spf][None]
        return audio, motion, mask

    def _has_full_window(self) -> bool:
        # the offline frame count (samples * 30 // 16000, prepare_ar_inputs) only grows,
        # so firing on it streams exactly the offline windows; gating on frame_pos * 533
        # samples would fire up to a third of a frame early and could turn the offline
        # remainder window into a full one
        return self._total_samples * FPS // SR >= self._frame_pos + self.window

    def _commit_window(self, net_out, last: np.ndarray, keep: int) -> None:
        """Advance the AR state past one window: seed, frame position, audio trim.
        ``net_out``: this session's (1, ...) rows, copied to the host only when
        collecting latents; ``last``: its host seed tail."""
        self._seed = last
        if self.collect_latents:
            self.latents.append({k: _host(v[:, :keep]) for k, v in net_out.items()})
        self._frame_pos += keep
        cut = self._frame_pos * self.spf - self._consumed
        if cut > 0:
            self._audio = self._audio[cut:]
            self._consumed += cut

    def _decode_emit(self, net_out, keep: int) -> GenerationResult:
        return self._finish_emit(*self._decode(net_out, self._trans, keep))

    def _finish_emit(self, motion, expr, trans) -> GenerationResult:
        """Thread the decoded translation into the next chunk's start; rows (1, t, ...)."""
        self._trans = trans[:, -1:].copy()
        return GenerationResult(motion_axis_angle=motion[0], expressions=expr[0],
                                trans=trans[0])

    def _empty(self) -> GenerationResult:
        return GenerationResult(np.zeros((0, 165), np.float32),
                                np.zeros((0, self._expr_dim), np.float32),
                                np.zeros((0, 3), np.float32))

    @property
    def _total_samples(self) -> int:
        return self._consumed + len(self._audio)

    def _run_window(self, size: int, keep: int):
        audio, motion, mask = self._window_inputs(size)
        net_out, last = self._step(audio, self._spk, motion, mask)
        self._commit_window(net_out, _host(last), keep)
        return net_out

    def push(self, audio_chunk: np.ndarray) -> GenerationResult:
        """Append audio; process every complete full window. Returns the newly final
        frames (possibly none)."""
        self._audio = np.concatenate([self._audio,
                                      np.asarray(audio_chunk, np.float32).ravel()])
        outs = []
        while self._has_full_window():
            net_out = self._run_window(self.window, self.stride)
            outs.append(self._decode_emit(net_out, self.stride))
        if not outs:
            return self._empty()
        return GenerationResult(
            motion_axis_angle=np.concatenate([o.motion_axis_angle for o in outs]),
            expressions=np.concatenate([o.expressions for o in outs]),
            trans=np.concatenate([o.trans for o in outs]),
        )

    def flush(self) -> GenerationResult:
        """The final remainder window, emitted only when more than ``seed_frames`` frames
        remain (the offline remainder rule); eager."""
        remain = self._total_samples * FPS // SR - self._frame_pos - self.pre
        if remain <= self.pre:
            return self._empty()
        size = self.pre + remain
        return self._decode_emit(self._run_window(size, size), size)


class StreamingPool:
    """Many concurrent audio streams on one card: every session with a complete window
    goes onto the batch axis of ONE window step and ONE chunk decode per wave (no
    reference equivalent). Stragglers are padded with replicas of row 0, whose outputs
    are dropped, so the pool replays one step graph and one decode graph at its fixed
    ``batch``.

    Each row is its session's own audio, seed, mask and start translation
    (``ref_trans`` (N, 1, 3)), so every session's latent stream equals its single-stream
    and offline latents (bit-equal on the CPU), and its translation continues from its
    own last position. The JAX package's pool passes (N, 3), which its
    ``vq_get_global_motion`` reads as one clip's (T, 3), so there every session
    integrates from session 0's position; this pool does not copy that.

    Usage::

        pool = StreamingPool(model, vq_model, batch=8)
        sid = pool.open(speaker_id=0)
        pool.feed(sid, chunk)            # buffers audio; no device work
        for sid, res in pool.pump():     # one batched step per ready wave
            ...
        res = pool.flush(sid)            # the session's remainder window
        pool.close(sid)
    """

    def __init__(self, model, vq_model, batch: int = 8, compute_dtype: Optional[str] = None):
        self.model = model
        self.vq = vq_model
        self.batch = batch
        self.compute_dtype = compute_dtype
        self._sessions: dict = {}
        self._next_id = 0
        self._step, self._decode = _window_callables(model, vq_model, compute_dtype)

    def open(self, speaker_id: int = 0, collect_latents: bool = False) -> int:
        sid = self._next_id
        self._next_id += 1
        s = StreamingEmageGenerator(self.model, self.vq, speaker_id=speaker_id,
                                    collect_latents=collect_latents,
                                    compute_dtype=self.compute_dtype)
        s._step, s._decode = self._step, self._decode
        self._sessions[sid] = s
        return sid

    def close(self, sid: int) -> None:
        del self._sessions[sid]

    def session(self, sid: int) -> StreamingEmageGenerator:
        return self._sessions[sid]

    def feed(self, sid: int, audio_chunk: np.ndarray) -> None:
        """Buffer audio for a session (host only; device work happens in ``pump``)."""
        s = self._sessions[sid]
        s._audio = np.concatenate([s._audio, np.asarray(audio_chunk, np.float32).ravel()])

    def ready(self) -> List[int]:
        return [sid for sid, s in self._sessions.items() if s._has_full_window()]

    def pump(self) -> List[tuple]:
        """Process complete windows across all sessions in batched waves until none
        remain. Returns [(sid, GenerationResult), ...] in emission order (a session
        appears once per window it completed)."""
        out = []
        while True:
            ready = self.ready()[:self.batch]
            if not ready:
                return out
            rows = [self._sessions[sid] for sid in ready]
            ins = [s._window_inputs(s.window) for s in rows]
            pad = self.batch - len(rows)
            stack = lambda xs: np.concatenate(list(xs) + [xs[0]] * pad, axis=0)
            net_out, last = self._step(stack([a for a, _, _ in ins]),
                                       stack([s._spk for s in rows]),
                                       stack([m for _, m, _ in ins]),
                                       stack([k for _, _, k in ins]))
            # everything the next step overwrites is consumed before it: the seeds and
            # collected latents go to the host here, net_out into the decode's inputs
            last = _host(last)
            for i, s in enumerate(rows):
                s._commit_window({k: v[i:i + 1] for k, v in net_out.items()}
                                 if s.collect_latents else None,
                                 last[i:i + 1], s.stride)
            m, e, t = self._decode(net_out, stack([s._trans for s in rows]), rows[0].stride)
            for i, (sid, s) in enumerate(zip(ready, rows)):
                out.append((sid, s._finish_emit(m[i:i + 1], e[i:i + 1], t[i:i + 1])))

    def flush(self, sid: int) -> GenerationResult:
        """The session's remainder window (its size differs per session, so this is
        unbatched, as ``StreamingEmageGenerator.flush``)."""
        return self._sessions[sid].flush()


__all__ = ["EmageGenerator", "GenerationResult", "SequenceGenerator",
           "StreamingEmageGenerator", "StreamingPool"]
